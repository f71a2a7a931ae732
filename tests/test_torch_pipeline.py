"""Parity of the port's pipeline schedules (``ddstore_tpu_torch/parallel/
pipeline.py``) with the JAX reference's, on the CPU.

Every case of ``tests/test_pipeline.py`` runs on both sides from the same
numpy inputs: the reference on the 8 virtual CPU devices of
``tests/conftest.py``, the port in one spawned 4-rank gloo world for the
whole file (``torch_pp_workers.pipeline_cases``), each rank its own
stage. A reference mesh of 8 devices (pp 4 x dp 2) becomes pp 2 x dp 2
here, on the same inputs, run on both sides. Tolerances are the
reference's own: outputs atol 1e-5, rtol 1e-5; gradients atol 1e-5, rtol
1e-4; losses rtol 1e-5, all f32. A further case holds the 1F1B property
the reference pins with XLA's temp sizes (``tests/test_pp_lm.py:193``):
at S = 4 the most stage graphs a rank holds at once stays at or below
``2S - 1`` under 1F1B for M = 16 and 64, while GPipe's is M."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddstore_tpu.parallel import (interleave_stage_params, make_mesh,
                                  pipeline_apply, stack_stage_params)
from ddstore_tpu.parallel.pipeline import (interleave_order,
                                           pipeline_1f1b,
                                           pipeline_interleaved,
                                           pipeline_interleaved_1f1b)
from ddstore_tpu_torch.parallel import pipeline as tpp

from torch_pp_workers import pipeline_cases
from torch_workers import spawn

pytestmark = pytest.mark.tier1_required

FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)


class StageMLP(nn.Module):
    dim: int = 16

    @nn.compact
    def __call__(self, x):
        h = nn.tanh(nn.Dense(2 * self.dim)(x))
        return x + nn.Dense(self.dim)(h)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _stage_setup(n, m=8, mb=4, dim=16, seed=0, xseed=1):
    """(model, per-stage params, stacked, x, step) of ``n`` stages, as
    ``tests/test_pipeline.py:_setup``."""
    model = StageMLP(dim)
    keys = jax.random.split(jax.random.key(seed), n)
    per = [model.init(k, jnp.zeros((mb, dim))) for k in keys]
    x = jax.random.normal(jax.random.key(xseed), (m, mb, dim))
    return model, per, x, (lambda p, a: model.apply(p, a))


def _il_setup(s=4, v=2, m=8, mb=4, dim=8, seed=7):
    """``tests/test_pipeline.py:_setup_il1f1b``."""
    ks = jax.random.split(jax.random.key(seed), s * v + 3)
    chunks = [{"w": jax.random.normal(ks[i], (dim, dim)) * 0.3,
               "b": jax.random.normal(ks[i], (dim,)) * 0.1}
              for i in range(s * v)]
    lparams = {"head": jax.random.normal(ks[-3], (dim,))}
    x = jax.random.normal(ks[-2], (m, mb, dim))
    tgt = jax.random.normal(ks[-1], (m, mb))

    def stage_fn(p, a):
        return jnp.tanh(a @ p["w"] + p["b"]) + a

    def loss_fn(lp, y, t):
        return jnp.mean((y @ lp["head"] - t) ** 2)

    return chunks, lparams, x, tgt, stage_fn, loss_fn


def _ref_apply(step, stacked, x, mesh, tgt=None, **kw):
    """(out, grads, gx) of the reference's GPipe or interleaved pipeline,
    the gradients those of ``mean((out - tgt)^2)``."""
    v = kw.pop("n_virtual", None)

    def run(p, a):
        if v is None:
            return pipeline_apply(step, p, a, mesh=mesh, **kw)
        return pipeline_interleaved(step, p, a, mesh=mesh, n_virtual=v,
                                    **kw)

    res = {"out": np.asarray(jax.jit(run)(stacked, x))}
    if tgt is not None:
        g, gx = jax.jit(jax.grad(
            lambda p, a: jnp.mean((run(p, a) - tgt) ** 2),
            argnums=(0, 1)))(stacked, x)
        res.update(grads=_np(g), gx=np.asarray(gx))
    return res


def _ref_fused(chunks, lparams, x, tgt, stage_fn, loss_fn, mesh, s, v,
               **kw):
    stacked = interleave_stage_params(chunks, s)
    loss, gst, glp, dx = jax.jit(
        lambda st, lp, xx: pipeline_interleaved_1f1b(
            stage_fn, loss_fn, st, lp, xx, tgt, mesh=mesh, n_virtual=v,
            **kw))(stacked, lparams, x)
    return stacked, {"loss": float(loss), "grads": _np(gst),
                     "lgrads": _np(glp), "dx": np.asarray(dx)}


def _cases():
    """(port cases, reference results) by name."""
    cases, refs = {}, {}
    mesh4 = make_mesh({"pp": 4})
    mesh22 = make_mesh({"pp": 2, "dp": 2})
    # GPipe at pp 4: forward and gradients (test_pipeline.py:39-67)
    model, per, x, step = _stage_setup(4)
    stacked = stack_stage_params(per)
    tgt = jax.random.normal(jax.random.key(2), x.shape)
    cases["gpipe_pp4"] = dict(kind="apply", axes={"pp": 4},
                              params=_np(stacked), x=np.asarray(x),
                              tgt=np.asarray(tgt))
    refs["gpipe_pp4"] = _ref_apply(step, stacked, x, mesh4, tgt)
    cases["gpipe_pp4_remat"] = dict(cases["gpipe_pp4"], remat=True)
    refs["gpipe_pp4_remat"] = refs["gpipe_pp4"]
    cases["train"] = dict(kind="train", axes={"pp": 4}, params=_np(stacked),
                          x=np.asarray(x))
    # pp x dp (test_pipeline.py:70): the stages replicated over dp, x
    # whole or dp-sharded
    _, per2, x2, _ = _stage_setup(2, seed=3)
    stacked2 = stack_stage_params(per2)
    tgt2 = jax.random.normal(jax.random.key(4), x2.shape)
    for dp in (None, "dp"):
        name = f"gpipe_pp2xdp2_{dp}"
        cases[name] = dict(kind="apply", axes={"pp": 2, "dp": 2},
                           params=_np(stacked2), x=np.asarray(x2),
                           tgt=np.asarray(tgt2), dp_axis=dp)
        refs[name] = _ref_apply(step, stacked2, x2, mesh22, tgt2,
                                dp_axis=dp)
    # interleaved (test_pipeline.py:111-200): S 4, V 2
    _, chunks, xc, _ = _stage_setup(8, seed=3, xseed=4)
    stc = interleave_stage_params(chunks, 4)
    tgtc = jax.random.normal(jax.random.key(5), xc.shape)
    cases["il_pp4_v2"] = dict(kind="apply", axes={"pp": 4},
                              params=_np(stc), x=np.asarray(xc),
                              tgt=np.asarray(tgtc), n_virtual=2)
    refs["il_pp4_v2"] = _ref_apply(step, stc, xc, mesh4, tgtc, n_virtual=2)
    cases["il_pp4_v1"] = dict(cases["gpipe_pp4"], n_virtual=1)
    refs["il_pp4_v1"] = _ref_apply(step, stacked, x, mesh4, tgt,
                                   n_virtual=1)
    stc22 = interleave_stage_params(chunks[:4], 2)
    cases["il_pp2xdp2_v2"] = dict(kind="apply", axes={"pp": 2, "dp": 2},
                                  params=_np(stc22), x=np.asarray(xc),
                                  n_virtual=2, dp_axis="dp")
    refs["il_pp2xdp2_v2"] = _ref_apply(step, stc22, xc, mesh22, n_virtual=2,
                                       dp_axis="dp")

    def step_aux(p, a):
        y = model.apply(p, a)
        return y, jnp.mean(y ** 2)

    cases["il_aux"] = dict(kind="apply", axes={"pp": 4}, params=_np(stc),
                           x=np.asarray(xc), n_virtual=2, with_aux=True)
    out, aux = jax.jit(lambda p, a: pipeline_interleaved(
        step_aux, p, a, mesh=mesh4, n_virtual=2, with_aux=True))(stc, xc)
    refs["il_aux"] = {"out": np.asarray(out), "aux": float(aux)}
    # fused interleaved 1F1B (test_pipeline.py:233-360)
    for name, s, v, axes, kw in (
            ("i1f1b_pp4_v2", 4, 2, {"pp": 4}, {}),
            ("i1f1b_pp2xdp2_v2", 2, 2, {"pp": 2, "dp": 2},
             {"dp_axis": "dp"}),
            ("i1f1b_pp4_v1", 4, 1, {"pp": 4}, {}),
            ("i1f1b_aux", 2, 2, {"pp": 2, "dp": 2},
             {"with_aux": True, "aux_weight": 0.37})):
        chunks_, lp, xi, ti, sfn, lfn = _il_setup(s=s, v=v)
        rmesh = make_mesh(axes)
        if kw.get("with_aux"):
            def sfn_aux(p, a, sfn=sfn):
                y = sfn(p, a)
                return y, jnp.mean(y ** 2)
            st, refs[name] = _ref_fused(chunks_, lp, xi, ti, sfn_aux, lfn,
                                        rmesh, s, v, **kw)
        else:
            st, refs[name] = _ref_fused(chunks_, lp, xi, ti, sfn, lfn, rmesh,
                                        s, v, **kw)
        cases[name] = dict(kind="fused", axes=axes, params=_np(st),
                           lparams=_np(lp), x=np.asarray(xi),
                           tgt=np.asarray(ti), n_virtual=v, **kw)
    cases["plain_1f1b_pp4"] = dict(cases["i1f1b_pp4_v1"], plain_1f1b=True)
    chunks_, lp, xi, ti, sfn, lfn = _il_setup(s=4, v=1)
    b = jax.jit(lambda st, l_, xx: pipeline_1f1b(
        sfn, lfn, st, l_, xx, ti, mesh=mesh4))(
            stack_stage_params(chunks_), lp, xi)
    refs["plain_1f1b_pp4"] = {"loss": float(b[0]), "grads": _np(b[1]),
                              "lgrads": _np(b[2]), "dx": np.asarray(b[3])}
    cases["stash"] = dict(kind="stash", axes={"pp": 4}, s=4, mb=8, d=64,
                          ms=(16, 64))
    return cases, refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, refs = _cases()
    ranks = spawn(4, pipeline_cases, str(tmp_path_factory.mktemp("pp")),
                  cases, timeout=400)
    return ranks, refs


def _close_tree(got, want, tol, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close_tree(got[k], want[k], tol, f"{path}/{k}")
    else:
        np.testing.assert_allclose(got, want, err_msg=path, **tol)


def _same_on_every_rank(ranks, name, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name][key], ranks[0][name][key])


@pytest.mark.parametrize("name", ["gpipe_pp4", "gpipe_pp4_remat",
                                  "gpipe_pp2xdp2_None", "gpipe_pp2xdp2_dp",
                                  "il_pp4_v2", "il_pp4_v1"])
def test_forward_and_gradients_match_reference(world, name):
    ranks, refs = world
    got, want = ranks[0][name], refs[name]
    np.testing.assert_allclose(got["out"], want["out"], **FWD)
    _close_tree(got["grads"], want["grads"], GRAD)
    np.testing.assert_allclose(got["gx"], want["gx"], **GRAD)
    for key in ("out", "gx"):  # whole on every rank
        _same_on_every_rank(ranks, name, key)


def test_remat_changes_no_gradient(world):
    ranks, _ = world
    for r in ranks:
        _close_tree(r["gpipe_pp4_remat"]["grads"], r["gpipe_pp4"]["grads"],
                    dict(atol=0, rtol=0))


def test_interleaved_v1_equals_gpipe(world):
    """``n_virtual=1`` is GPipe's schedule (``test_pipeline.py:157``):
    bit for bit on the port."""
    ranks, _ = world
    for r in ranks:
        np.testing.assert_array_equal(r["il_pp4_v1"]["out"],
                                      r["gpipe_pp4"]["out"])
        _close_tree(r["il_pp4_v1"]["grads"], r["gpipe_pp4"]["grads"],
                    dict(atol=0, rtol=0))


def test_interleaved_with_dp_axis(world):
    ranks, refs = world
    for r in ranks:
        np.testing.assert_allclose(r["il_pp2xdp2_v2"]["out"],
                                   refs["il_pp2xdp2_v2"]["out"], **FWD)


def test_interleaved_with_aux_matches_reference(world):
    ranks, refs = world
    for r in ranks:
        np.testing.assert_allclose(r["il_aux"]["out"], refs["il_aux"]["out"],
                                   **FWD)
        np.testing.assert_allclose(r["il_aux"]["aux"], refs["il_aux"]["aux"],
                                   rtol=1e-5)


@pytest.mark.parametrize("name", ["i1f1b_pp4_v2", "i1f1b_pp2xdp2_v2",
                                  "i1f1b_pp4_v1", "i1f1b_aux",
                                  "plain_1f1b_pp4"])
def test_fused_1f1b_matches_reference(world, name):
    ranks, refs = world
    want = refs[name]
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        _close_tree(got["grads"], want["grads"], GRAD)
        _close_tree(got["lgrads"], want["lgrads"], GRAD)
        np.testing.assert_allclose(got["dx"], want["dx"], **GRAD)


def test_interleaved_1f1b_v1_equals_1f1b(world):
    ranks, _ = world
    for r in ranks:
        a, b = r["i1f1b_pp4_v1"], r["plain_1f1b_pp4"]
        assert a["loss"] == b["loss"]
        _close_tree(a["grads"], b["grads"], dict(atol=0, rtol=0))
        np.testing.assert_array_equal(a["dx"], b["dx"])


def test_pipeline_trains(world):
    ranks, _ = world
    for r in ranks:
        assert r["train"]["last"] < 0.2 * r["train"]["l0"], r["train"]
        assert r["train"]["l0"] == ranks[0]["train"]["l0"]


def test_1f1b_stash_bounded_by_stages(world):
    """At S = 4, 1F1B holds at most 2S - 1 = 7 stage graphs a rank
    whatever M is; GPipe holds every microbatch's (M)."""
    ranks, _ = world
    for rank, r in enumerate(ranks):
        for m, (gpipe, f1b) in r["stash"].items():
            assert gpipe == m, (rank, m, gpipe)
            assert f1b <= 2 * 4 - 1, (rank, m, f1b)
    # the first stage's stash is the fullest: exactly 2S - 1
    assert ranks[0]["stash"][64][1] == 7
    for r in ranks:
        assert r["i1f1b_pp4_v2"]["high_water"] <= 2 * 8 - 1


def test_interleave_stage_params_order():
    """Stack position d*V+v holds chunk v*S+d (test_pipeline.py:99)."""
    s, v = 4, 2
    chunks = [{"w": torch.full((2,), float(k))} for k in range(s * v)]
    st = tpp.interleave_stage_params(chunks, s)
    for d in range(s):
        for vv in range(v):
            assert float(st["w"][d * v + vv][0]) == float(vv * s + d)
    assert tpp.interleave_order(s, v) == interleave_order(s, v)


def _fake_mesh(**axes):
    from torch.distributed.device_mesh import DeviceMesh

    sizes = tuple(axes.values())
    return DeviceMesh("cpu", torch.arange(int(np.prod(sizes))).view(sizes),
                      mesh_dim_names=tuple(axes), _init_backend=False,
                      _rank=0)


def test_interleaved_rejects_bad_shapes():
    """``test_pipeline.py:212``: the same errors, before any hand-off."""
    mesh = _fake_mesh(pp=4)
    st = {"w": torch.zeros(8, 3)}
    x = torch.zeros(8, 4, 3)
    step = tpp.stack_stage_params  # never reached
    with pytest.raises(ValueError, match="multiple of the pp axis"):
        tpp.pipeline_interleaved(step, st, x[:6], mesh=mesh, n_virtual=2)
    with pytest.raises(ValueError, match="leading dim"):
        tpp.pipeline_interleaved(step, st, x, mesh=mesh, n_virtual=3)
    with pytest.raises(ValueError, match="n_virtual must be >= 1"):
        tpp.pipeline_interleaved(step, st, x, mesh=mesh, n_virtual=0)
    with pytest.raises(ValueError, match="leading dim"):
        tpp.pipeline_apply(step, {"w": torch.zeros(3, 3)}, x, mesh=mesh)


def test_pp_microbatch_sharding_validated():
    """``test_pp_lm.py:356``: a dp axis that does not divide the
    microbatch raises."""
    mesh = _fake_mesh(pp=1, dp=4)
    with pytest.raises(ValueError, match="microbatch"):
        tpp.pipeline_apply(lambda p, a: a, {"w": torch.zeros(1, 3)},
                           torch.zeros(2, 3, 3), mesh=mesh, dp_axis="dp")
