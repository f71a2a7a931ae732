"""Parity of the port's ZeRO-3 (FSDP2) with the JAX reference, on the CPU:
the rule functions and the sharded train steps of the LM, the VAE and the
GNN.

``fsdp_rules`` and ``fsdp_compose`` (over ``megatron_rules`` and
``expert_rules``) are held to the reference's on every leaf of the LM
(dense and MoE), VAE and GNN trees: the same dim sharded, read through the
transpose of Dense kernels (the ``qkv`` kernel's tp entry is the port's
per-head split, ``tests/test_torch_tp.py``).

The steps run in one spawned gloo world of 4 ranks
(``torch_workers.model_parallel_cases``): the LM on ``dp2 x fsdp2``,
``fsdp2 x tp2`` and, with experts, ``fsdp2 x ep2``; the VAE and the GNN on
``dp2 x fsdp2``. Each is held to the reference's single-device step on
the whole batch from the same weights: the loss to 1e-5 relative (f32),
the gradients within rtol 1e-4, atol 1e-6 (the VAE's and the GNN's, of
order 1 under their summed losses, within 1e-4 of each leaf's largest,
as their DDP tests hold them), and each parameter's update
within 1e-2 of the learning rate where the reference's gradient is above
ten Adam eps (``torch_parity.assert_updates_close``). The VAE's and the
GNN's reductions are sums, as the reference's DP steps are; the LM's a
mean."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddstore_tpu.models import gnn as jgnn
from ddstore_tpu.models import vae as jvae
from ddstore_tpu.parallel import fsdp as jfsdp
from ddstore_tpu.parallel import make_mesh as j_make_mesh
from ddstore_tpu.parallel import tp as jtp
from ddstore_tpu_torch.parallel import fsdp as tfsdp
from ddstore_tpu_torch.parallel import tp as ttp

from torch_parity import (SMALL, assert_updates_close, jax_lm_step,
                          lm_pair, positions, rule_pairs,
                          spec_in_torch, tokens)
from torch_workers import model_parallel_cases, spawn
from test_torch_gnn import batch as gnn_batch
from test_torch_gnn import mpnn_pair
from test_torch_vae import batch_and_eps, vae_pair

pytestmark = pytest.mark.tier1_required

LR, SMALL_LR = 1e-2, 1e-3
MOE = dict(n_experts=4, moe_top_k=1, moe_capacity=40)
LM_CASES = {"dp2xfsdp2": ({"dp": 2, "fsdp": 2}, {}),
            "fsdp2xtp2": ({"fsdp": 2, "tp": 2}, {}),
            "fsdp2xep2": ({"fsdp": 2, "ep": 2}, MOE)}
CASES = sorted(LM_CASES) + ["vae_dp2xfsdp2", "gnn_dp2xfsdp2"]


def _mesh(**axes):
    """A mesh of these axes for the rules to read (no process group)."""
    from torch.distributed.device_mesh import DeviceMesh

    sizes = tuple(axes.values())
    return DeviceMesh("cpu", torch.arange(int(np.prod(sizes))).view(sizes),
                      mesh_dim_names=tuple(axes), _init_backend=False,
                      _rank=0)


def lm_batch():
    return (tokens(4, 32, SMALL["vocab"], seed=91),
            tokens(4, 32, SMALL["vocab"], seed=92), positions(4, 32))


def _vae_case():
    jm, params, _ = vae_pair()
    raw, key, eps = batch_and_eps(16)
    tx = optax.adam(SMALL_LR)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = jvae.TrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))
    new, loss = jvae.make_train_step(jm, tx, donate=False)(state, raw, key)
    x = jnp.asarray(raw, jnp.float32) / 255.0

    def lossf(p):
        logits, mu, logvar = jm.apply(p, x, key)
        return jvae.loss_fn(logits, x, mu, logvar)

    grads = jax.grad(lossf)(jp)
    case = {"family": "vae", "axes": {"dp": 2, "fsdp": 2}, "cfg": {},
            "tree": params, "batch": (raw, eps), "lr": SMALL_LR}
    return case, (params, (float(loss), new.params, grads))


def _gnn_case():
    jm, params, _ = mpnn_pair()
    gb = gnn_batch(slots=4)
    tx = optax.adam(SMALL_LR)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = jgnn.TrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))
    new, loss = jgnn.make_train_step(jm, tx, donate=False)(state, gb)
    grads = jax.grad(lambda p: jgnn.loss_fn(jgnn._apply_batch(jm, p, gb),
                                            gb.y, gb.graph_mask))(jp)
    case = {"family": "gnn", "axes": {"dp": 2, "fsdp": 2},
            "cfg": dict(hidden=32, layers=2), "tree": params,
            "batch": tuple(np.asarray(f) for f in gb), "lr": SMALL_LR}
    return case, (params, (float(loss), new.params, grads))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, refs = {}, {}
    for name, (axes, moe) in LM_CASES.items():
        jm, params, _ = lm_pair(**moe)
        tree = jax.tree_util.tree_map(np.asarray, params)
        cases[name] = {"family": "lm", "axes": axes,
                       "cfg": dict(SMALL, **moe), "tree": tree,
                       "batch": lm_batch()}
        refs[name] = (tree, jax_lm_step(jm, params, lm_batch(), LR), LR)
    for name, make in (("vae_dp2xfsdp2", _vae_case),
                       ("gnn_dp2xfsdp2", _gnn_case)):
        cases[name], (tree, ref) = make()
        refs[name] = (tree, jax.tree_util.tree_map(np.asarray, ref),
                      SMALL_LR)
    ranks = spawn(4, model_parallel_cases,
                  str(tmp_path_factory.mktemp("fsdp")), cases, LR,
                  timeout=400)
    return ranks, refs


@functools.lru_cache(maxsize=None)
def _trees():
    return {"lm": lm_pair(), "lm_moe": lm_pair(**MOE),
            "vae": vae_pair(), "gnn": mpnn_pair()}


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("tree", ["lm", "lm_moe", "vae", "gnn"])
def test_fsdp_rules_match_reference(tree, size):
    _, params, tm = _trees()[tree]
    ref = jfsdp.fsdp_rules(j_make_mesh({"fsdp": size},
                                       jax.devices()[:size]))
    port = tfsdp.fsdp_rules(_mesh(fsdp=size))
    sharded = 0
    for name, p, path, leaf in rule_pairs(tm, params):
        want = spec_in_torch(ref(path, leaf), path, p.ndim)
        got = ttp.torch_spec(port, name, p)
        assert got == want, (name, got, want)
        sharded += "fsdp" in got
    assert sharded > 0


@pytest.mark.parametrize("base", ["tp", "ep", "ep_tp"])
def test_fsdp_compose_matches_reference(base):
    _, params, tm = lm_pair(**MOE) if "ep" in base else lm_pair()
    axes = {"fsdp": 2, "ep": 2, "tp": 2}
    jmesh = j_make_mesh(axes, jax.devices()[:8])
    tp = "tp" if "tp" in base else None
    ref = jfsdp.fsdp_compose(jtp.expert_rules("ep", tp) if "ep" in base
                             else jtp.megatron_rules("tp"), jmesh)
    port = tfsdp.fsdp_compose(ttp.expert_rules("ep", tp) if "ep" in base
                              else ttp.megatron_rules("tp"), _mesh(**axes))
    for name, p, path, leaf in rule_pairs(tm, params):
        want = spec_in_torch(ref(path, leaf), path, p.ndim)
        got = ttp.torch_spec(port, name, p)
        if tp and path[-2:] == ("qkv", "kernel"):
            # the per-head split takes the tp entry; fsdp the same dim
            assert want == ("tp", "fsdp"), want
            assert got == (ttp.Strided("tp", 3), "fsdp"), got
        else:
            assert got == want, (name, got, want)


@pytest.mark.parametrize("axes", [{"dp": 2}, {"fsdp": 2}, {"dp": 2,
                                                           "fsdp": 2},
                                  {"sp": 2, "tp": 2}])
def test_data_axes_match_reference(axes):
    n = int(np.prod(list(axes.values())))
    want = jfsdp.data_axes(j_make_mesh(axes, jax.devices()[:n]))
    assert tfsdp.data_axes(_mesh(**axes)) == want


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_single_device(world, case):
    ranks, refs = world
    before, (want_loss, want_params, want_grads), lr = refs[case]
    for r in ranks:
        assert r[case]["steps"] == 1
        np.testing.assert_allclose(r[case]["loss"], want_loss, rtol=1e-5,
                                   atol=0)
    assert_updates_close(ranks[0][case]["params"], want_params, before, lr,
                         ranks[0][case]["grads"], want_grads,
                         leaf_scale=case not in LM_CASES)
    assert len({r[case]["digest"] for r in ranks}) == 1


@pytest.mark.parametrize("case", CASES)
def test_state_is_sharded(world, case):
    # ZeRO-3: FSDP2 shards each parameter's rule dim; a 2-D leaf sharded
    # over fsdp holds half its rows or columns (a quarter under tp too)
    ranks, _ = world
    pl = ranks[0][case]["placements"]
    if case in LM_CASES:  # every leaf of the LM has a dim fsdp divides
        assert all(s is not None for _, s in pl.values()), pl
    else:  # FSDP holds the leaves the rules shard, and no others
        _, params, tm = (vae_pair if case.startswith("vae")
                         else mpnn_pair)()
        rules = tfsdp.fsdp_rules(_mesh(dp=2, fsdp=2))
        for name, p, _, _ in rule_pairs(tm, params):
            sharded = "fsdp" in ttp.torch_spec(rules, name, p)
            assert (pl[name][1] is not None) == sharded, name
    if case.startswith("vae"):
        assert pl["encoder.fc.weight"] == ((400, 392),
                                           "(Replicate(), Shard(dim=1))")
    elif case.startswith("gnn"):
        assert "Shard" in pl["msg0_0.weight"][1]
    else:
        d, v = SMALL["dim"], SMALL["vocab"]
        head = pl["lmhead.head.weight"]
        if "tp" in case:  # vocab over tp, features over fsdp
            assert head[0] == (v // 2, d // 2), head
            assert pl["blocks.0.qkv.weight"][0] == (3 * d // 2, d // 2)
        else:  # the vocab stays whole
            assert head[0][0] == v and head[0][1] == d // 2, head
        if "ep" in case:
            assert pl["blocks.0.moe.w1"][0][0] == MOE["n_experts"] // 2
            assert "fsdp" not in str(pl["blocks.0.moe.router.weight"])
