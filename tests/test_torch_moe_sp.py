"""Parity of the port's MoE over a split sequence, and of fsdp with sp,
with the JAX reference on the same meshes, on the CPU at f32.

The reference flattens a step's ``(B, S)`` tokens row-major and takes the
choice-major capacity order over all of them
(``ddstore_tpu/models/transformer.py:90-91``, ``moe.py:97-98``). Over sp a
rank holds one chunk of each of its rows, so its tokens interleave with
the other sp ranks' row by row: ``moe.route`` must give each assignment
the reference's global slot, not one after every lower rank's.

The port runs in one spawned gloo world of 4 ranks; the reference runs its
own ``make_train_step``, ``make_pp_train_step`` math and ``generate`` on
the same mesh over virtual CPU devices, built as ``tests/test_compose.py``
builds its meshes. A 2-rank mesh of the reference is the port's ``sp``
axis beside an axis ``rep`` that no layer reads, so the world's two
halves each run it. Held at ``tests/torch_parity.py``'s tolerances: loss
1e-5 relative, gradients rtol 1e-4 (atol 1e-6), updates within 1e-2 of
lr where |g| >= 1e-7.

* the layer over dp2 x sp2, top-2 with a padded ``valid`` mask and a
  capacity that drops: expert, slot and kept flags equal the reference's
  exactly, and the per-rank order's kept flags differ from them;
* the train step over dp1 x sp2 (top-1 and top-2), dp2 x sp2, sp2 x ep2
  and fsdp2 x sp2, each with a capacity that drops, and the dense LM over
  fsdp2 x sp2;
* the pipelined MoE LM over pp2 x sp2 (GPipe and 1F1B);
* ``generate`` with the MoE ring prefill over sp2, plain and padded
  prompts: tokens exactly, first-token logits within 1e-4."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ddstore_tpu.models import decode as jdec
from ddstore_tpu.models import transformer as jtr
from ddstore_tpu.parallel import fsdp as jfsdp
from ddstore_tpu.parallel import make_mesh as jmake_mesh
from ddstore_tpu.parallel.tp import expert_rules
from jax.sharding import PartitionSpec as P

from torch_moe_sp_workers import moe_sp_cases
from torch_parity import (SMALL, assert_updates_close, lm_pair, positions,
                          tokens)
from torch_workers import spawn
from test_torch_moe import layer_pair, reference_routing
from test_torch_pp_lm import CFG as PP_CFG
from test_torch_pp_lm import MOE as PP_MOE
from test_torch_pp_lm import _batch as pp_batch
from test_torch_pp_lm import M as PP_M
from test_torch_pp_lm import jax_pp_step

pytestmark = pytest.mark.tier1_required

LR = 1e-2
B, S = 4, 32
# name: (port axes, reference axes, cfg beyond SMALL)
TRAIN = {
    "sp2_k1": ({"sp": 2, "rep": 2}, {"sp": 2},
               dict(n_experts=4, moe_top_k=1, moe_capacity=12)),
    "sp2_k2": ({"sp": 2, "rep": 2}, {"sp": 2},
               dict(n_experts=4, moe_top_k=2, moe_capacity=20)),
    "dp2xsp2": ({"dp": 2, "sp": 2}, {"dp": 2, "sp": 2},
                dict(n_experts=4, moe_top_k=2, moe_capacity=16)),
    "sp2xep2": ({"ep": 2, "sp": 2}, {"ep": 2, "sp": 2},
                dict(n_experts=4, moe_top_k=1, moe_capacity=12)),
    "fsdp2xsp2": ({"sp": 2, "fsdp": 2}, {"sp": 2, "fsdp": 2}, {}),
    "fsdp2xsp2_moe": ({"sp": 2, "fsdp": 2}, {"sp": 2, "fsdp": 2},
                      dict(n_experts=4, moe_top_k=2, moe_capacity=16)),
}
# the layer: (experts, hidden, dim, top_k, capacity) over (B, S) tokens
ROUTE = (4, 16, 16, 2, 10)
GEN_CFG = dict(SMALL, n_experts=4, moe_top_k=2, moe_capacity=10)
PP_RUNS = {"gpipe": {"schedule": "gpipe"}, "1f1b": {"schedule": "1f1b"}}


def _batch():
    return (tokens(B, S, SMALL["vocab"], seed=61),
            tokens(B, S, SMALL["vocab"], seed=62), positions(B, S))


def _valid():
    """A padded mask: each row's last few positions are pads, some in
    either sp chunk."""
    lens = np.array([32, 27, 13, 20])
    return np.arange(S)[None, :] < lens[:, None]


def _prompts():
    p = tokens(4, 16, GEN_CFG["vocab"], seed=63)
    return {"plain": (p, 4, None),
            "padded": (p, 4, np.array([16, 11, 9, 13], np.int32))}


def jax_mesh_step(jm, params, batch, axes, lr):
    """The reference's ``create_train_state`` placement and
    ``make_train_step`` on a mesh of ``axes``: loss, parameters after one
    Adam step, gradients, as numpy trees."""
    n = int(np.prod(list(axes.values())))
    mesh = jmake_mesh(axes, jax.devices()[:n])
    jmm = jm.clone(mesh=mesh)
    tx = optax.adam(lr)
    if axes.get("fsdp", 1) > 1:
        rules = jfsdp.fsdp_rules(mesh)
    elif axes.get("ep", 1) > 1:
        rules = expert_rules("ep", None)
    else:
        rules = lambda path, leaf: P()  # noqa: E731 (replicated)
    state = jtr.TrainState(*jfsdp.place_zero3(params, tx, mesh, rules))
    batch = tuple(jnp.asarray(a) for a in batch)
    grads = jax.jit(jax.grad(lambda p: jtr.lm_loss(
        jmm, p, *batch, mesh=mesh)))(state.params)
    new, loss = jtr.make_train_step(jmm, tx, mesh=mesh, donate=False,
                                    state=state)(state, *batch)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return float(loss), as_np(new.params), as_np(grads)


def _route_case():
    e, h, d, k, cap = ROUTE
    jm, params, _, x = layer_pair(e, h, d, B * S, k, 2.0, cap, seed=3)
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    case = {"kind": "route", "axes": {"dp": 2, "sp": 2}, "experts": e,
            "hidden": h, "top_k": k, "capacity": cap,
            "x": x.reshape(B, S, d), "valid": _valid(),
            "params": {"router": p["router"]["kernel"],
                       **{n: p[n] for n in ("w1", "b1", "w2", "b2")}}}

    def reference():
        valid = _valid().reshape(-1)
        y, aux = jm.apply(params, jnp.asarray(x), jnp.asarray(valid))
        expert, slot, kept = reference_routing(params, x, k, cap, valid)
        return {"expert": expert, "slot": slot, "kept": kept,
                "y": np.asarray(y), "aux": float(aux)}

    return case, reference


def _reference_generate(jm, params):
    mesh = jmake_mesh({"sp": 2}, jax.devices()[:2])
    spm = jm.clone(mesh=mesh)
    w = np.asarray(params["params"]["lmhead"]["head"]["kernel"])
    out = {}
    for name, (prompt, n, lengths) in _prompts().items():
        lens = None if lengths is None else jnp.asarray(lengths)
        toks = np.asarray(jax.jit(lambda p, t: jdec.generate(
            spm, p, t, n, prompt_lengths=lens, prefill_mesh=mesh))(
                params, jnp.asarray(prompt)))
        plen = prompt.shape[1]
        mask = None if lengths is None else \
            jnp.arange(plen)[None, :] < lens[:, None]
        feats = np.asarray(jax.jit(lambda p, t: spm.apply(
            p, t, jnp.tile(jnp.arange(plen), (t.shape[0], 1)), True,
            token_mask=mask))(params, jnp.asarray(prompt)))
        last = np.full(len(prompt), plen - 1) if lengths is None \
            else lengths - 1
        out[name] = (toks, feats[np.arange(len(prompt)), last] @ w)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, pairs = {}, {}
    for name, (axes, _, moe) in TRAIN.items():
        jm, params, _ = lm_pair(**moe)
        pairs[name] = (jm, params)
        cases[name] = {"kind": "train", "axes": axes,
                       "cfg": dict(SMALL, **moe),
                       "tree": jax.tree_util.tree_map(np.asarray, params),
                       "batch": _batch()}
    cases["route"], route_ref = _route_case()
    gen_jm, gen_params, _ = lm_pair(**GEN_CFG)
    cases["generate"] = {"kind": "generate", "axes": {"dp": 2, "sp": 2},
                         "cfg": GEN_CFG, "prompts": _prompts(),
                         "tree": jax.tree_util.tree_map(np.asarray,
                                                        gen_params)}
    pp_cfg = dict(PP_CFG, layers=4, **PP_MOE)
    pp_jm, pp_params, _ = lm_pair(**pp_cfg)
    cases["pp2xsp2"] = {"kind": "pp", "axes": {"pp": 2, "sp": 2},
                        "cfg": pp_cfg, "batch": pp_batch(pp_cfg["vocab"]),
                        "tree": jax.tree_util.tree_map(np.asarray,
                                                       pp_params),
                        "m": PP_M, "runs": PP_RUNS}

    def reference():
        refs = {name: (cases[name]["tree"],
                       jax_mesh_step(*pairs[name], cases[name]["batch"],
                                     TRAIN[name][1], LR))
                for name in TRAIN}
        refs["route"] = route_ref()
        refs["generate"] = _reference_generate(gen_jm, gen_params)
        for r, run in PP_RUNS.items():
            refs[f"pp2xsp2/{r}"] = (cases["pp2xsp2"]["tree"], jax_pp_step(
                pp_jm, pp_params, cases["pp2xsp2"]["batch"],
                {"pp": 2, "sp": 2}, run))
        return refs

    with ThreadPoolExecutor(1) as ex:
        refs = ex.submit(reference)
        ranks = spawn(4, moe_sp_cases, str(tmp_path_factory.mktemp("moesp")),
                      cases, LR, timeout=600)
        return ranks, refs.result()


def _assert_step(ranks, got, ref):
    before, (want_loss, want_params, want_grads) = ref
    for r in ranks:
        assert r["steps"] == 1
        np.testing.assert_allclose(r["loss"], want_loss, rtol=1e-5, atol=0)
    assert_updates_close(got["params"], want_params, before, LR,
                         got["grads"], want_grads)


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_step_matches_reference_on_its_mesh(world, case):
    ranks, refs = world
    _assert_step([r[case] for r in ranks], ranks[0][case], refs[case])


@pytest.mark.parametrize("schedule", sorted(PP_RUNS))
def test_pp_sp_moe_step_matches_reference(world, schedule):
    ranks, refs = world
    got = [r["pp2xsp2"][schedule] for r in ranks]
    _assert_step(got, got[0], refs[f"pp2xsp2/{schedule}"])


def _route_global(ranks, field):
    """The ranks' ``(k, b, s)`` routing fields as the global ``(k, B*S)``
    choice-major arrays."""
    k = ranks[0]["route"][field].shape[0]
    out = np.zeros((k, B, S), ranks[0]["route"][field].dtype)
    for r in ranks:
        (i, j), v = r["route"]["at"], r["route"][field]
        b, s = v.shape[1:3]
        out[:, i * b:(i + 1) * b, j * s:(j + 1) * s] = v
    return out.reshape(k, B * S)


def test_routing_takes_the_global_token_order(world):
    ranks, refs = world
    want = refs["route"]
    valid = _valid().reshape(-1)
    assert ranks[0]["route"]["capacity"] == ROUTE[-1]
    np.testing.assert_array_equal(_route_global(ranks, "expert"),
                                  want["expert"])
    kept = _route_global(ranks, "kept")
    np.testing.assert_array_equal(kept, want["kept"])
    counted = np.broadcast_to(valid, kept.shape)
    np.testing.assert_array_equal(_route_global(ranks, "slot")[counted],
                                  want["slot"][counted])
    # the capacity drops tokens, so the per-rank order would keep others
    assert (~want["kept"][counted]).any()
    assert (_route_global(ranks, "kept_per_rank") != want["kept"]).any()


def test_layer_output_and_aux_match_reference(world):
    ranks, refs = world
    want = refs["route"]
    y = np.zeros((B, S, ROUTE[2]), np.float32)
    for r in ranks:
        (i, j), v = r["route"]["at"], r["route"]["y"]
        b, s = v.shape[:2]
        y[i * b:(i + 1) * b, j * s:(j + 1) * s] = v
    np.testing.assert_allclose(y.reshape(B * S, -1), want["y"], rtol=0,
                               atol=1e-5)
    # each rank returns D times its share: their mean is the global aux
    aux = np.mean([r["route"]["aux"] for r in ranks])
    np.testing.assert_allclose(aux, want["aux"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("prompts", sorted(_prompts()))
def test_moe_ring_prefill_matches_reference(world, prompts):
    ranks, refs = world
    want_toks, want_logits = refs["generate"][prompts]
    for r in ranks:
        toks, logits = r["generate"][prompts]
        np.testing.assert_array_equal(toks, want_toks)
        np.testing.assert_allclose(logits, want_logits, rtol=0, atol=1e-4)


@pytest.mark.parametrize("world,dp,pp,tp", [(2, 1, 1, 1), (4, 1, 1, 1),
                                            (4, 2, 1, 1), (8, 2, 2, 1),
                                            (8, 1, 1, 2)])
def test_example_gives_leftover_ranks_to_ep_with_experts(world, dp, pp, tp):
    """Routing over sp does not change the long-context example's layout:
    with ``--experts`` the ranks left after dp x pp x tp still serve the
    experts, as ``examples/lm_longcontext.py:118-123`` gives them."""
    from ddstore_tpu_torch.examples.lm_longcontext import rank_axes

    rest = world // (dp * pp * tp)
    moe = rank_axes(world, dp, pp, tp, experts=4)
    assert (moe["ep"], moe["sp"]) == (rest, 1)
    dense = rank_axes(world, dp, pp, tp, experts=0)
    assert (dense["ep"], dense["sp"]) == (1, rest)
    assert moe["dp"] * moe["pp"] * moe["tp"] * moe["ep"] * moe["sp"] == world
    # the reference's rule, read from its source
    ref = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "lm_longcontext.py")
    with open(ref) as f:
        text = f.read()
    assert 'if args.experts and sp > 1:' in text
    assert text.index('axes["ep"] = sp') < text.index('axes["sp"] = sp')
