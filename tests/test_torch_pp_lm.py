"""Parity of the port's pipelined LM (``create_pp_train_state``,
``make_pp_train_step``, ``lm_to_stages``/``lm_from_stages``,
``weights.from_flax_stages``) with the JAX reference, on the CPU: the
cases of ``tests/test_pp_lm.py`` and the pp cases of
``tests/test_compose.py``.

The port runs in one spawned 4-rank gloo world (pp 4 over 7 layers, so
the last stage pads; dp 2 x pp 2; pp 2 x tp 2; pp 2 x sp 2; pp 2 x ep 2;
pp 2 x fsdp 2, the stages replicated over fsdp as the reference's are)
and one 8-rank world (dp 2 x pp 2 x tp 2, ``test_compose.py:138``), each
rank passing its dp slot's rows in the reference's placement
(``pp_batch_rows``) and its sequence chunk. Each run is one Adam step
from the same weights as the reference's, gathered whole after it
(``lm_from_stages``), and held to:

* dense models: the reference's single-device step on the whole batch
  (a dense loss is the same token mean however the batch is cut);
* MoE models: the reference's own ``make_pp_train_step`` math
  (``pp_*_value_and_grad`` + ``optax.adam``) on the same mesh, since each
  stage routes one microbatch's dp shard alone (capacity 12 drops
  assignments, so the token sets must be the reference's);

at ``tests/torch_parity.py``'s tolerances: loss rtol 1e-5; gradients rtol
1e-4, atol 1e-6; updates within 1e-2 of lr where the reference's
gradient is above ``ADAM_NOISE_FLOOR`` (f32).

The 16-rank dp x pp x tp x sp composition (``tests/test_dryrun_4axis.py``)
is marked ``slow``: 16 processes."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddstore_tpu.models import transformer as jtr
from ddstore_tpu.parallel import make_mesh as jmake_mesh
from ddstore_tpu_torch import weights
from ddstore_tpu_torch.models import transformer as ttr

from torch_parity import (GRAD_TOL, assert_updates_close, flat_leaves,
                          jax_lm_step, lm_pair, positions, tokens)
from torch_pp_workers import pp_lm_cases
from torch_workers import spawn

pytestmark = pytest.mark.tier1_required

LR = 1e-2
B, S, M = 8, 32, 4
CFG = dict(vocab=256, dim=64, heads=4)
MOE = dict(n_experts=4, moe_top_k=2, moe_capacity=12)
GPIPE, F1B = {"schedule": "gpipe"}, {"schedule": "1f1b"}
IL = {"schedule": "interleaved", "n_virtual": 2}
IL1F1B = {"schedule": "interleaved_1f1b", "n_virtual": 2}
# name: (axes, layers, moe, runs)
CASES = {
    "pp4_uneven": ({"pp": 4}, 7, False,
                   {"gpipe": GPIPE, "1f1b": F1B,
                    "gpipe_remat": dict(GPIPE, remat=True)}),
    "dp2xpp2": ({"dp": 2, "pp": 2}, 4, False,
                {"gpipe": GPIPE, "1f1b": F1B, "interleaved": IL,
                 "interleaved_1f1b": IL1F1B}),
    "pp2xtp2": ({"pp": 2, "tp": 2}, 4, False,
                {"gpipe": GPIPE, "1f1b": F1B, "interleaved": IL}),
    "pp2xsp2": ({"pp": 2, "sp": 2}, 4, False,
                {"gpipe": GPIPE, "1f1b": F1B, "interleaved": IL}),
    "pp2xep2_moe": ({"pp": 2, "ep": 2}, 4, True,
                    {"gpipe": GPIPE, "1f1b": F1B}),
    # the stages replicated over fsdp, as the reference's
    # create_pp_train_state leaves them (it places tp and ep only, and its
    # step's data P(dp, sp)); each fsdp rank passes its dp slot's rows
    "pp2xfsdp2": ({"pp": 2, "fsdp": 2}, 4, False,
                  {"gpipe": GPIPE, "1f1b": F1B}),
    "dp2xpp2_moe": ({"dp": 2, "pp": 2}, 4, True,
                    {"gpipe": GPIPE, "1f1b": F1B,
                     "interleaved_1f1b": IL1F1B}),
    # the fused head against the unfused one (test_pp_lm.py:368): vocab
    # 96 in blocks of 32
    "fused": ({"pp": 4}, 4, False,
              {f"{s['schedule']}_{f}": dict(s, fused_xent=f, xent_block=32)
               for s in (GPIPE, F1B) for f in (False, True)}),
}
WIDE = {"dp2xpp2xtp2": ({"dp": 2, "pp": 2, "tp": 2}, 4, False,
                        {"gpipe": GPIPE, "1f1b": F1B})}


def _batch(vocab):
    return (tokens(B, S, vocab, seed=31), tokens(B, S, vocab, seed=32),
            positions(B, S))


def _cfg(name, layers, moe):
    cfg = dict(CFG, layers=layers, **(MOE if moe else {}))
    if name == "fused":
        cfg["vocab"] = 96
    return cfg


def jax_pp_step(jm, params, batch, axes, run):
    """The reference's ``make_pp_train_step`` math on its mesh: loss,
    parameters after one Adam step and gradients, as flat numpy trees."""
    mesh = jmake_mesh(axes)
    s, nv = axes["pp"], run.get("n_virtual", 1)
    moe = jm.n_experts > 0
    outer, stages = jtr.lm_to_stages(params, jm.layers, s, nv)
    stage_fn = jtr._make_stage_fn(jm, s * nv, with_aux=moe, mesh=mesh)
    vg = jtr.pp_1f1b_value_and_grad if run["schedule"].endswith("1f1b") \
        else jtr.pp_gpipe_value_and_grad
    dp = "dp" if axes.get("dp", 1) > 1 else None
    tok, tgt, pos = (jnp.asarray(a) for a in batch)
    loss, grads = jax.jit(lambda pp: vg(
        jm, stage_fn, pp, tok, tgt, pos, n_microbatches=M, mesh=mesh,
        dp_axis=dp, with_aux=moe, aux_weight=jtr.MOE_AUX_WEIGHT,
        n_virtual=nv))((outer, stages))
    tx = optax.adam(LR)
    upd, _ = tx.update(grads, tx.init((outer, stages)), (outer, stages))
    new = optax.apply_updates((outer, stages), upd)

    def flat(pair):
        return jax.tree_util.tree_map(np.asarray, jtr.lm_from_stages(
            pair[0], pair[1], jm.layers, s, nv))

    return float(loss), flat(new), flat(grads)


def _world(cases, world, tmp):
    """The port's ranks' results and the reference's, by run; the
    reference computes in a thread while the ranks run."""
    port, pairs = {}, {}
    for name, (axes, layers, moe, runs) in cases.items():
        cfg = _cfg(name, layers, moe)
        jm, params, _ = lm_pair(**cfg)
        pairs[name] = (jm, params)
        port[name] = {"axes": axes, "cfg": cfg,
                      "tree": jax.tree_util.tree_map(np.asarray, params),
                      "batch": _batch(cfg["vocab"]), "m": M, "runs": runs}

    def reference():
        refs = {}
        for name, (axes, _, moe, runs) in cases.items():
            (jm, params), c = pairs[name], port[name]
            dense = None if moe else jax_lm_step(jm, params, c["batch"], LR)
            for rname, run in runs.items():
                refs[f"{name}/{rname}"] = (c["tree"], jax_pp_step(
                    jm, params, c["batch"], axes, run) if moe else dense)
        return refs

    with ThreadPoolExecutor(1) as ex:
        refs = ex.submit(reference)
        ranks = spawn(world, pp_lm_cases, tmp, port, LR, timeout=600)
        return ranks, refs.result()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _world(CASES, 4, str(tmp_path_factory.mktemp("pplm")))


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    return _world(WIDE, 8, str(tmp_path_factory.mktemp("pplm8")))


def _runs(cases):
    return [f"{n}/{r}" for n, c in cases.items() for r in c[3]]


def _assert_step(ranks, refs, run):
    before, (want_loss, want_params, want_grads) = refs[run]
    for r in ranks:
        assert r[run]["steps"] == 1
        np.testing.assert_allclose(r[run]["loss"], want_loss, rtol=1e-5,
                                   atol=0, err_msg=run)
    got = ranks[0][run]
    assert_updates_close(got["params"], want_params, before, LR,
                         got["grads"], want_grads)


@pytest.mark.parametrize("run", _runs(CASES))
def test_pp_step_matches_reference(world, run):
    _assert_step(*world, run)


@pytest.mark.parametrize("run", _runs(WIDE))
def test_dp_pp_tp_full_step(wide, run):
    """Three axes at once (``test_compose.py:138``): batch over dp,
    stages over pp, Megatron over tp."""
    _assert_step(*wide, run)


def test_remat_changes_no_gradient(world):
    ranks, _ = world
    a = flat_leaves(ranks[0]["pp4_uneven/gpipe"]["grads"])
    b = flat_leaves(ranks[0]["pp4_uneven/gpipe_remat"]["grads"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_fused_head_matches_unfused(world, schedule):
    """``test_pp_lm.py:368``: the fused head's loss and gradients equal
    the unfused head's (rtol 2e-4, atol 2e-5 on gradients)."""
    ranks, _ = world
    f = ranks[0][f"fused/{schedule}_True"]
    u = ranks[0][f"fused/{schedule}_False"]
    np.testing.assert_allclose(f["loss"], u["loss"], rtol=1e-5)
    fg, ug = flat_leaves(f["grads"]), flat_leaves(u["grads"])
    for k in ug:
        np.testing.assert_allclose(fg[k], ug[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_uneven_depth_pads_stay_zero(world):
    """7 layers over 4 stages of 2: the last stage's second layer is a
    pad; its weights are still exactly 0 after the step
    (``test_compose.py:249``)."""
    ranks, _ = world
    for run in ("gpipe", "1f1b", "gpipe_remat"):
        pads = [r[f"pp4_uneven/{run}"]["pads"] for r in ranks]
        assert [len(p) > 0 for p in pads] == [False, False, False, True]
        assert max(pads[3]) == 0.0


def test_pp_state_on_every_stage(world):
    """Each rank holds its stage: the embedding on the first, the head on
    the last, V chunks each; the ranks' losses agree."""
    ranks, _ = world
    for run in _runs(CASES):
        assert len({r[run]["loss"] for r in ranks}) == 1, run
    got = [r["pp4_uneven/gpipe"]["stage"] for r in ranks]
    assert got == [(0, 1, True, False), (1, 1, False, False),
                   (2, 1, False, False), (3, 1, False, True)]
    got = [r["dp2xpp2/interleaved"]["stage"] for r in ranks]
    # the mesh orders pp before dp: ranks 0-1 are stage 0
    assert got == [(0, 2, True, False)] * 2 + [(1, 2, False, True)] * 2
    assert ranks[0]["dp2xpp2/interleaved"]["params"] is not None
    assert all(r["dp2xpp2/gpipe"]["params"] is None for r in ranks[1:])


def test_pp_tp_stage_placements(world):
    """``test_compose.py:153``: the stage layers carry Megatron's
    placement (q, k and v by heads), the last stage's head is
    vocab-sharded, the LayerNorms stay whole."""
    ranks, _ = world
    d = CFG["dim"]
    first = ranks[0]["pp2xtp2/gpipe"]["placements"]
    last = [r["pp2xtp2/gpipe"]["placements"] for r in ranks
            if r["pp2xtp2/gpipe"]["stage"][3]][0]
    assert first["chunks.0.layers.0.qkv.weight"] == (
        (3 * d // 2, d), "(_StridedShard(dim=0, sf=3),)")
    assert first["chunks.0.layers.0.proj.weight"] == ((d, d // 2),
                                                      "(Shard(dim=1),)")
    assert first["chunks.0.layers.1.up.weight"][1] == "(Shard(dim=0),)"
    assert first["chunks.0.layers.0.ln1.weight"] == ((d,), None)
    assert first["embed.tok.weight"] == ((CFG["vocab"], d), None)
    assert last["lmhead.head.weight"] == ((CFG["vocab"] // 2, d),
                                          "(Shard(dim=0),)")


def test_pp_ep_experts_sharded(world):
    ranks, _ = world
    pl = ranks[0]["pp2xep2_moe/gpipe"]["placements"]
    e, d = MOE["n_experts"], CFG["dim"]
    assert pl["chunks.0.layers.0.moe.w1"] == ((e // 2, d, 4 * d),
                                              "(Shard(dim=0),)")
    assert pl["chunks.0.layers.0.moe.router.weight"] == ((e, d), None)


def _model(layers=4, **kw):
    return ttr.TransformerLM(compute_dtype=torch.float32, device="cpu",
                             layers=layers, **CFG, **kw)


@pytest.mark.parametrize("layers,s,v", [(4, 2, 1), (4, 2, 2), (5, 2, 1),
                                        (7, 4, 1), (3, 2, 1)])
def test_stage_state_roundtrip(layers, s, v):
    """The reference's ``(outer, stages)`` -> the port's stages -> the
    reference's, exact; the port's ``lm_to_stages`` of a model cuts what
    the reference's cuts of the same weights; ``tree_from_stages`` is the
    reference's ``lm_from_stages``."""
    jm, params, tm = lm_pair(**CFG, layers=layers)
    outer, stages = jtr.lm_to_stages(params, layers, s, v)
    want = flat_leaves({"o": jax.tree_util.tree_map(np.asarray, outer),
                        "s": jax.tree_util.tree_map(np.asarray, stages)})
    fresh = [ttr.lm_to_stages(_model(layers), s, v, d) for d in range(s)]
    for st in fresh:
        weights.from_flax_stages(jax.tree_util.tree_map(np.asarray, outer),
                                 jax.tree_util.tree_map(np.asarray, stages),
                                 st)
    for got_stages in (fresh, [ttr.lm_to_stages(tm, s, v, d)
                               for d in range(s)]):
        o, st = weights.to_flax_stages(got_stages)
        got = flat_leaves({"o": o, "s": st})
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = flat_leaves(weights.tree_from_stages(o, st, layers, s, v))
    ref = flat_leaves(jax.tree_util.tree_map(
        np.asarray, jtr.lm_from_stages(outer, stages, layers, s, v)))
    assert sorted(back) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    # the pads' mask, as the reference's float leaf
    assert [c.valid for stg in fresh for c in stg.chunks] == \
        [[bool(b) for b in row] for row in np.asarray(stages["_valid"])
         .reshape(s * v, -1)]


def test_stage_split_refuses_empty_stage():
    """``test_compose.py:340``."""
    with pytest.raises(ValueError, match="zero real layers"):
        ttr.lm_to_stages(_model(4), 3, 1, 0)  # stages [2, 2, 0]
    with pytest.raises(ValueError, match="zero real layers"):
        ttr.lm_to_stages(_model(2), 8, 1, 0)


def _fake_mesh(**axes):
    from torch.distributed.device_mesh import DeviceMesh

    sizes = tuple(axes.values())
    return DeviceMesh("cpu", torch.arange(int(np.prod(sizes))).view(sizes),
                      mesh_dim_names=tuple(axes), _init_backend=False,
                      _rank=0)


def test_pp_step_validates_its_arguments():
    """The schedule, ``n_virtual`` (``transformer.py:766-772``), a stage
    cut for another layout, and microbatches that do not split the
    batch."""
    stage = ttr.lm_to_stages(_model(), 2, 1, 0)
    opt = ttr.adam(stage.parameters(), 1e-3)
    mesh = _fake_mesh(pp=2)
    with pytest.raises(ValueError, match="unknown schedule"):
        ttr.make_pp_train_step(stage, opt, mesh, 2, 4, schedule="zb")
    with pytest.raises(ValueError, match="interleaved"):
        ttr.make_pp_train_step(stage, opt, mesh, 2, 4, schedule="gpipe",
                               n_virtual=2)
    with pytest.raises(ValueError, match="same n_virtual"):
        ttr.make_pp_train_step(stage, opt, mesh, 2, 4,
                               schedule="interleaved", n_virtual=2)
    one, opt1 = ttr.create_pp_train_state(_model(), 1)
    step = ttr.make_pp_train_step(one.model, opt1, None, 1, 3)
    tok = torch.from_numpy(tokens(4, 16, CFG["vocab"]))
    with pytest.raises(ValueError, match="microbatches"):
        step(tok, tok, torch.from_numpy(positions(4, 16)))


@pytest.mark.parametrize("axes,moe", [({"pp": 2, "fsdp": 2}, False),
                                      ({"pp": 2, "sp": 2}, True)])
def test_pp_state_refuses_fsdp_and_moe_over_sp(axes, moe):
    """Neither layout is refused any more: pp x fsdp runs with the stages
    replicated over fsdp, as the reference's (the ``pp2xfsdp2`` runs of
    the world above), and MoE with sp inside a stage routes over sp
    (``tests/test_torch_moe_sp.py`` runs it against the reference). The
    state goes on to check the replicas, a collective, which a fake mesh
    without a process group cannot run."""
    with pytest.raises(Exception) as e:
        ttr.create_pp_train_state(_model(**(MOE if moe else {})), 2,
                                  mesh=_fake_mesh(**axes))
    assert not isinstance(e.value, NotImplementedError), e.value


@pytest.mark.slow
def test_dp_pp_tp_sp_16_ranks(tmp_path):
    """dp x pp x tp x sp at 16 ranks, the composition of
    ``tests/test_dryrun_4axis.py`` (``__graft_entry__.dryrun_4axis``):
    marked slow because it spawns 16 processes."""
    cases = {"dp2xpp2xtp2xsp2": ({"dp": 2, "pp": 2, "tp": 2, "sp": 2}, 4,
                                 False, {"gpipe": GPIPE})}
    ranks, refs = _world(cases, 16, str(tmp_path))
    _assert_step(ranks, refs, "dp2xpp2xtp2xsp2/gpipe")
