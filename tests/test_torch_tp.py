"""Parity of the port's tensor and expert parallelism with the JAX
reference, on the CPU: the rule functions, the placements, and the
sharded train steps.

The rules (``parallel/tp.py``) are held to the reference's on every leaf
of the LM (dense and MoE), VAE and GNN trees: the same dim sharded, read
through the transpose of Dense kernels. The one departure is ``qkv``,
which the port shards by heads (``Strided(tp, 3)``) where the reference
column-shards the fused kernel as one block.

The steps run in one spawned gloo world of 4 ranks
(``torch_workers.model_parallel_cases``) on ``dp2 x tp2``, ``sp2 x tp2``,
``ep2 x tp2`` and ``dp2 x ep2``, each rank passing its part of the global
batch, and are held to the reference's single-device step on the whole
batch from the same weights: the loss to 1e-5 relative (f32), each
parameter's update within 1e-2 of the learning rate (as
``tests/test_torch_longcontext.py`` holds the dp x sp step) wherever the
reference's gradient is above ten Adam eps, and every gradient within
rtol 1e-4, atol 1e-6 (``torch_parity.assert_updates_close``: below ten
eps, f32 summation noise of 1e-10 moves Adam's ``g / (|g| + eps)`` by
more than 1e-2; one MoE ``w1`` element with a gradient of 1.7e-9 moves
by 1.0e-2 of lr here, and the single-device port's by 7e-3). The MoE
cases use an explicit capacity under which assignments drop, so the
routing over the data ranks must follow the global choice-major order to
agree."""

import jax
import numpy as np
import pytest
import torch

from ddstore_tpu.parallel import tp as jtp
from ddstore_tpu_torch.parallel import tp as ttp

from torch_parity import (SMALL, assert_updates_close, jax_lm_step,
                          lm_pair, positions, rule_pairs, spec_in_torch,
                          tokens)
from torch_workers import model_parallel_cases, spawn
from test_torch_gnn import mpnn_pair
from test_torch_vae import vae_pair

pytestmark = pytest.mark.tier1_required

LR = 1e-2
# capacity 48 of the 128 tokens' 256 top-2 assignments over 4 experts:
# the busiest experts drop second choices
MOE = dict(n_experts=4, moe_top_k=2, moe_capacity=48)
CASES = {"dp2xtp2": ({"dp": 2, "tp": 2}, {}),
         "sp2xtp2": ({"sp": 2, "tp": 2}, {}),
         "ep2xtp2": ({"ep": 2, "tp": 2}, MOE),
         "dp2xep2": ({"dp": 2, "ep": 2}, MOE)}


def lm_batch():
    return (tokens(4, 32, SMALL["vocab"], seed=81),
            tokens(4, 32, SMALL["vocab"], seed=82), positions(4, 32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, refs = {}, {}
    for name, (axes, moe) in CASES.items():
        jm, params, _ = lm_pair(**moe)
        tree = jax.tree_util.tree_map(np.asarray, params)
        cases[name] = {"family": "lm", "axes": axes,
                       "cfg": dict(SMALL, **moe), "tree": tree,
                       "batch": lm_batch()}
        refs[name] = (tree, jax_lm_step(jm, params, lm_batch(), LR))
    ranks = spawn(4, model_parallel_cases, str(tmp_path_factory.mktemp("tp")),
                  cases, LR, timeout=400)
    return ranks, refs


def _moe_models():
    return {"dense": lm_pair(), "moe": lm_pair(**MOE)}


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_megatron_rules_match_reference(kind):
    _, params, tm = _moe_models()[kind]
    ref, port = jtp.megatron_rules("tp"), ttp.megatron_rules("tp")
    for name, p, path, leaf in rule_pairs(tm, params):
        want = spec_in_torch(ref(path, leaf), path, p.ndim)
        got = ttp.torch_spec(port, name, p)
        if path[-2:] == ("qkv", "kernel"):
            # the departure: q, k and v each split by heads
            assert want == ("tp", None) and got == (ttp.Strided("tp", 3),
                                                    None), name
        else:
            assert got == want, name


@pytest.mark.parametrize("tp_axis", [None, "tp"])
def test_expert_rules_match_reference(tp_axis):
    _, params, tm = lm_pair(**MOE)
    ref = jtp.expert_rules("ep", tp_axis)
    port = ttp.expert_rules("ep", tp_axis)
    sharded = 0
    for name, p, path, leaf in rule_pairs(tm, params):
        want = spec_in_torch(ref(path, leaf), path, p.ndim)
        got = ttp.torch_spec(port, name, p)
        if tp_axis and path[-2:] == ("qkv", "kernel"):
            assert got == (ttp.Strided("tp", 3), None), name
        else:
            assert got == want, name
        sharded += "ep" in got
    assert sharded == 4 * SMALL["layers"]  # w1, b1, w2, b2 of each block


@pytest.mark.parametrize("family", ["vae", "gnn"])
def test_rules_leave_vae_and_gnn_replicated_like_reference(family):
    _, params, tm = (vae_pair if family == "vae" else mpnn_pair)()
    for ref, port in ((jtp.megatron_rules("tp"), ttp.megatron_rules("tp")),
                      (jtp.expert_rules("ep", "tp"),
                       ttp.expert_rules("ep", "tp"))):
        for name, p, path, leaf in rule_pairs(tm, params):
            assert ttp.torch_spec(port, name, p) == spec_in_torch(
                ref(path, leaf), path, p.ndim), name


def test_qkv_local_shard_holds_this_ranks_heads():
    # tests/test_tp.py:37's shape: 4 heads over tp 4, one head a rank
    dim, heads, tp = 32, 4, 4
    w = torch.arange(3 * dim * dim, dtype=torch.float32).view(3 * dim, dim)
    hd = dim // heads

    class Mesh:  # the two things local_shard reads of a mesh
        mesh_dim_names = ("tp",)
        shape = (tp,)

        def __init__(self, r):
            self.r = r

        def get_local_rank(self, axis):
            return self.r

    for r in range(tp):
        got = ttp.local_shard(w, (ttp.Strided("tp", 3), None), Mesh(r))
        want = torch.cat([w[c * dim + r * hd:c * dim + (r + 1) * hd]
                          for c in range(3)])
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="equal shards"):
        ttp.local_shard(w[:, :30], (None, "tp"), Mesh(0))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_single_device(world, case):
    ranks, refs = world
    before, (want_loss, want_params, want_grads) = refs[case]
    for r in ranks:
        got = r[case]
        assert got["steps"] == 1
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5, atol=0)
    assert_updates_close(ranks[0][case]["params"], want_params, before, LR,
                         ranks[0][case]["grads"], want_grads)
    # every rank gathers the same whole parameters
    assert len({r[case]["digest"] for r in ranks}) == 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_parameters_are_placed(world, case):
    ranks, _ = world
    pl = ranks[0][case]["placements"]
    d, h = SMALL["dim"], 4 * SMALL["dim"]
    if "tp" in case:
        # q, k and v by heads; the MLP or the experts' hidden dim split
        assert pl["blocks.0.qkv.weight"] == ((3 * d // 2, d),
                                             "(_StridedShard(dim=0, sf=3),)")
        assert pl["blocks.0.proj.weight"] == ((d, d // 2), "(Shard(dim=1),)")
        assert pl["lmhead.head.weight"][0] == (SMALL["vocab"] // 2, d)
        assert pl["blocks.0.ln1.weight"] == ((d,), None)
    if "ep" in case:
        e = MOE["n_experts"]
        hl = h // 2 if "tp" in case else h
        assert pl["blocks.0.moe.w1"][0] == (e // 2, d, hl)
        assert pl["blocks.0.moe.w2"][0] == (e // 2, hl, d)
        assert pl["blocks.0.moe.router.weight"] == ((e, d), None)
    elif "tp" in case:
        assert pl["blocks.0.up.weight"] == ((h // 2, d), "(Shard(dim=0),)")
        assert pl["blocks.0.down.bias"] == ((d,), None)


def test_mesh_helpers_are_dtensor_placements(world):
    # the reference's batch_sharding / replicate / shard_batch
    # (mesh.py:59-84) as DTensor placements over a dp x tp mesh
    ranks, _ = world
    for rank, r in enumerate(ranks):
        m = r["_mesh"]
        assert m["batch_sharding"] == ["S(0)", "R"]
        assert m["replicate"] == ["R", "R"]
        # this rank's 3 rows are its dp slot's shard of 6
        assert m["global_shape"] == (6, 5) and m["y_shape"] == (6,)
        assert m["local"] == [[float(rank)] * 5] * 3
        assert m["local_mesh"] == (("dp",), 4)  # one host, four ranks
        assert m["shardings"] is None           # unplaced: replicated
        # a tp mesh needs the placed state (transformer.py:407-412)
        assert "pass the `state`" in m["refusal"]
