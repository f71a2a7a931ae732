"""Parity of the port's ring attention and meshes with the JAX reference,
on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py``; the port runs in one spawned gloo world of 8 ranks
(``torch_workers.ring_cases``), which builds the ``{"sp": 8}``,
``{"dp": 2, "sp": 4}``, ``{"sp": 4, "tp": 2}`` and ``{"dp": 8, "sp": 1}``
meshes in turn and runs every case of ``tests/test_attention.py``'s ring
tests on its chunks (the ``sp = 4`` cases on ``{"dp": 2, "sp": 4}`` with
the batch replicated over dp). The same inputs, from a numpy seed, go
through both.

Tolerances: f32 out and lse against JAX's ``ring_attention`` 2e-5, dq,
dk and dv 1e-4 (both sum the chunks in the same order; the kernels' plain
versions and XLA round differently inside a step); against the
full-sequence ``mha_reference`` 3e-5, as ``tests/test_attention.py``
holds the reference's ring; bf16 out 3e-2, as there; the ``sp = 1`` mesh
1e-6, as there. ``_combine`` alone 1e-6 (f32 elementwise). bf16
gradients: against the whole sequence's f32 gradients, the ring's worst
row of dq, dk and dv within 2x one whole-sequence bf16 call's (a
departure: the reference's ring does not hold it, ``ROADMAP.md`` C)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddstore_tpu.ops.attention import mha_reference as j_mha
from ddstore_tpu.parallel import make_mesh as j_make_mesh
from ddstore_tpu.parallel import ring_attention as j_ring
from ddstore_tpu.parallel.ring_attention import _combine as j_combine
from ddstore_tpu_torch.parallel import AXIS_ORDER
from ddstore_tpu_torch.parallel.ring_attention import _combine as t_combine

from torch_workers import spawn, ring_cases

pytestmark = pytest.mark.tier1_required

WORLD = 8
# Seeds at which the ring differentiated through _combine (the reference's
# jax.grad, and this port before its ring backward ran on the final lse)
# puts its worst bf16 dk row at 3.7x and 3.5x one whole-sequence call's;
# the final-lse backward at 1.2x and 1.1x (examples/ring_precision.py's
# emulation, at sp 4 and (1, 2, 512, 64)).
BF16_DK_SEEDS = (22, 27)
ROW_FACTOR = 2.0
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
FULL_TOL = dict(atol=3e-5, rtol=3e-5)


def _qkv(seed, b, h, s, d, grads=True):
    rng = np.random.default_rng(seed)
    arrs = {n: rng.standard_normal((b, h, s, d)).astype(np.float32)
            for n in ("q", "k", "v", "do")}
    if not grads:
        del arrs["do"]
    return arrs


def _cases():
    cases = {}
    for ax in ("sp8", "dp2sp4"):
        axes = {"sp": 8} if ax == "sp8" else {"dp": 2, "sp": 4}
        for causal in (False, True):
            cases[f"full-{ax}-{causal}"] = dict(
                _qkv(2, 4, 2, 256, 32), axes=axes, causal=causal,
                dtype="float32")
    cases["bf16"] = dict(_qkv(3, 1, 2, 512, 32, grads=False),
                         axes={"sp": 8}, causal=True, dtype="bfloat16")
    for causal in (False, True):
        cases[f"flash-{causal}"] = dict(
            _qkv(6, 1, 2, 128, 32), axes={"dp": 2, "sp": 4}, causal=causal,
            dtype="float32", impl="flash", replicate_batch=True)
    cases["misaligned"] = dict(
        _qkv(7, 1, 1, 36, 16, grads=False), axes={"dp": 2, "sp": 4},
        causal=True, dtype="float32", impl="flash", replicate_batch=True)
    cases["xla-misaligned"] = dict(
        _qkv(7, 1, 1, 36, 16), axes={"dp": 2, "sp": 4}, causal=True,
        dtype="float32", impl="xla", replicate_batch=True)
    cases["sp_tp"] = dict(_qkv(8, 2, 4, 128, 16), axes={"sp": 4, "tp": 2},
                          causal=True, dtype="float32")
    cases["sp1"] = dict(_qkv(4, 2, 2, 64, 16, grads=False),
                        axes={"dp": 8, "sp": 1}, causal=True,
                        dtype="float32", replicate_batch=True)
    for seed in BF16_DK_SEEDS:
        case = _qkv(seed, 1, 2, 512, 64)
        case["do"] = _bf16(case["do"])  # the bf16 out's cotangent as is
        cases[f"bf16-dk-{seed}"] = dict(case, axes={"dp": 2, "sp": 4},
                                        causal=True, dtype="bfloat16",
                                        replicate_batch=True)
    return cases


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """(cases, the 8 ranks' results)."""
    cases = _cases()
    ranks = spawn(WORLD, ring_cases, str(tmp_path_factory.mktemp("ring")),
                  cases)
    return cases, ranks


_WANT = {}


def _want(cases, name, impl="auto"):
    """``_jax_ring`` of a case, computed once for its tests."""
    if (name, impl) not in _WANT:
        _WANT[name, impl] = _jax_ring(cases[name], impl)
    return _WANT[name, impl]


def _assemble(case, ranks, name, key):
    """The full array of ``key`` from every rank's chunk (ranks that hold
    the same chunk must agree exactly)."""
    shape = case["q"].shape
    full = np.full(shape[:3] if key == "lse" else shape, np.nan,
                   np.float32)
    for r in ranks:
        res = r[name]
        sl = tuple(slice(lo, hi) for lo, hi in res["index"])
        prev = full[sl]
        if not np.isnan(prev).all():
            np.testing.assert_array_equal(prev, res[key])
        full[sl] = res[key]
    assert not np.isnan(full).any(), f"{name}: {key} not covered"
    return full


def _jax_ring(case, impl="auto"):
    """JAX's ring_attention on the case's mesh: (out, lse) and, when the
    case has ``do``, the gradients of sum(out * do)."""
    axes = case["axes"]
    if case.get("replicate_batch"):  # the reference's sp-only mesh
        axes = {"sp": axes["sp"]}
    n = 1
    for v in axes.values():
        n *= v
    mesh = j_make_mesh(axes, jax.devices()[:n])
    dt = getattr(jnp, case["dtype"])
    q, k, v = (jnp.asarray(case[n], dt) for n in ("q", "k", "v"))
    kw = dict(mesh=mesh, causal=case["causal"], impl=impl)
    if "tp" in axes:
        from jax.sharding import NamedSharding, PartitionSpec as P
        sh = NamedSharding(mesh, P(None, "tp", "sp", None))
        q, k, v = (jax.device_put(t, sh) for t in (q, k, v))
        kw["heads_axis"] = "tp"
    run = jax.jit(functools.partial(j_ring, **kw))
    out, lse = run(q, k, v)
    res = {"out": np.asarray(out, np.float32), "lse": np.asarray(lse)}
    if "do" in case:
        do = jnp.asarray(case["do"])

        def loss(q, k, v):
            return jnp.sum(run(q, k, v)[0].astype(jnp.float32) * do)

        g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
        res.update(dq=np.asarray(g[0]), dk=np.asarray(g[1]),
                   dv=np.asarray(g[2]))
    return res


def _full_reference(case):
    out, lse = j_mha(*(jnp.asarray(case[n], getattr(jnp, case["dtype"]))
                       for n in ("q", "k", "v")), causal=case["causal"])
    return np.asarray(out, np.float32), np.asarray(lse)


@pytest.mark.parametrize("axes", ["sp8", "dp2sp4"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_reference(ring, axes, causal):
    # tests/test_attention.py:57
    cases, ranks = ring
    name = f"full-{axes}-{causal}"
    case = cases[name]
    want = _want(cases, name)
    full_out, full_lse = _full_reference(case)
    for key, full in (("out", full_out), ("lse", full_lse)):
        got = _assemble(case, ranks, name, key)
        np.testing.assert_allclose(got, want[key], err_msg=key, **FWD_TOL)
        np.testing.assert_allclose(got, full, err_msg=key, **FULL_TOL)


@pytest.mark.parametrize("axes", ["sp8", "dp2sp4"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradients_match_reference(ring, axes, causal):
    cases, ranks = ring
    name = f"full-{axes}-{causal}"
    case = cases[name]
    want = _want(cases, name)
    for key in ("dq", "dk", "dv"):
        np.testing.assert_allclose(_assemble(case, ranks, name, key),
                                   want[key], err_msg=key, **GRAD_TOL)


def test_ring_bf16(ring):
    # tests/test_attention.py:73
    cases, ranks = ring
    case = cases["bf16"]
    got = _assemble(case, ranks, "bf16", "out")
    assert all(r["bf16"]["dtype"] == "torch.bfloat16" for r in ranks)
    full, _ = _full_reference(case)
    np.testing.assert_allclose(got, full, atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got, _jax_ring(case)["out"], atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_impl_matches_reference(ring, causal):
    # tests/test_attention.py:135: the reference's Pallas kernel per step,
    # which the CPU runs in interpret mode, against the port's flash path
    # (the kernels' plain versions on the CPU)
    cases, ranks = ring
    name = f"flash-{causal}"
    case = cases[name]
    want = _jax_ring(case, impl="flash")
    full_out, full_lse = _full_reference(case)
    for key in ("out", "lse", "dq", "dk", "dv"):
        got = _assemble(case, ranks, name, key)
        tol = FWD_TOL if key in ("out", "lse") else GRAD_TOL
        np.testing.assert_allclose(got, want[key], err_msg=key, **tol)
    np.testing.assert_allclose(_assemble(case, ranks, name, "out"),
                               full_out, **FULL_TOL)
    np.testing.assert_allclose(_assemble(case, ranks, name, "lse"),
                               full_lse, **FULL_TOL)


def test_ring_flash_impl_rejects_misaligned(ring):
    # tests/test_attention.py:172: 9-row chunks
    cases, ranks = ring
    with pytest.raises(ValueError, match="flash") as want:
        _jax_ring(cases["misaligned"], impl="flash")
    for r in ranks:
        assert r["misaligned"] == {"error": str(want.value)}


def test_ring_xla_impl_on_misaligned_chunks(ring):
    # chunks of 9 (no tile alignment): the plain forward per step, and the
    # plain backward functions on the final lse
    cases, ranks = ring
    case = cases["xla-misaligned"]
    want = _jax_ring(case, impl="xla")
    for key in ("out", "lse", "dq", "dk", "dv"):
        tol = FWD_TOL if key in ("out", "lse") else GRAD_TOL
        np.testing.assert_allclose(
            _assemble(case, ranks, "xla-misaligned", key), want[key],
            err_msg=key, **tol)
    assert all(r["xla-misaligned"]["shifts"]["backward"] == 3
               for r in ranks)


def test_ring_sp_tp_layout(ring):
    # tests/test_attention.py:180: heads split over tp, each tp shard
    # ringing its own heads over sp
    cases, ranks = ring
    case = cases["sp_tp"]
    want = _jax_ring(case)
    full_out, _ = _full_reference(case)
    for key in ("out", "lse"):
        np.testing.assert_allclose(_assemble(case, ranks, "sp_tp", key),
                                   want[key], err_msg=key, **FWD_TOL)
    np.testing.assert_allclose(_assemble(case, ranks, "sp_tp", "out"),
                               full_out, **FULL_TOL)
    for key in ("dq", "dk", "dv"):
        np.testing.assert_allclose(_assemble(case, ranks, "sp_tp", key),
                                   want[key], err_msg=key, **GRAD_TOL)


def test_ring_single_axis_mesh(ring):
    # tests/test_attention.py:224: sp = 1 is one plain call, no shift
    cases, ranks = ring
    case = cases["sp1"]
    full_out, _ = _full_reference(case)
    np.testing.assert_allclose(_assemble(case, ranks, "sp1", "out"),
                               full_out, atol=1e-6)
    assert all(r["sp1"]["shifts"]["forward"] == 0 for r in ranks)


@pytest.mark.parametrize("name,n", [("full-sp8-True", 8),
                                    ("full-dp2sp4-False", 4),
                                    ("flash-True", 4)])
def test_every_rank_runs_every_shift(ring, name, n):
    # The ring's protocol: n - 1 forward and n - 1 backward shifts on
    # every rank, the causal ranks whose last chunks lie in their future
    # (no live step reads them) included.
    _, ranks = ring
    for r in ranks:
        assert r[name]["shifts"]["forward"] == n - 1
        assert r[name]["shifts"]["backward"] == n - 1


def _worst_row(got, want):
    """The largest over rows of ||got - want|| / ||want||, each row's norm
    floored at a thousandth of the largest (``chip_smoke.py``'s
    ``row_errors``)."""
    err = np.linalg.norm(got - want, axis=-1)
    norm = np.linalg.norm(want, axis=-1)
    return float((err / np.maximum(norm, 1e-3 * norm.max())).max())


@pytest.mark.parametrize("seed", BF16_DK_SEEDS)
def test_ring_bf16_gradients_keep_one_calls_precision(ring, seed):
    # Against the whole sequence's f32 gradients, the bf16 ring's worst dk
    # (and dq, dv) row within ROW_FACTOR of one whole-sequence bf16 call's
    # (the plain versions of the kernels, which round where they round).
    # A ring backward through _combine rounds each step's share of do to
    # bf16 and fails this on dk rows of keys near the sequence end.
    from ddstore_tpu_torch.ops.attention import flash_attention, mha_reference

    cases, ranks = ring
    name = f"bf16-dk-{seed}"
    case = cases[name]
    assert all(r[name]["dtype"] == "torch.bfloat16" for r in ranks)
    do = torch.from_numpy(case["do"])
    bf = [torch.from_numpy(case[n]).to(torch.bfloat16).requires_grad_()
          for n in ("q", "k", "v")]
    f32 = [t.detach().float().requires_grad_() for t in bf]
    (flash_attention(*bf, causal=True)[0].float() * do).sum().backward()
    (mha_reference(*f32, causal=True)[0] * do).sum().backward()
    for i, key in enumerate(("dq", "dk", "dv")):
        want = f32[i].grad.numpy()
        ring_err = _worst_row(_assemble(case, ranks, name, key), want)
        one_err = _worst_row(bf[i].grad.float().numpy(), want)
        assert ring_err <= ROW_FACTOR * one_err, (key, ring_err, one_err)


def test_combine_matches_reference():
    # _combine alone, -inf partials included, forward and gradients
    rng = np.random.default_rng(11)
    shape = (2, 3, 16)
    acc_out = rng.standard_normal(shape + (8,)).astype(np.float32)
    out_i = rng.standard_normal(shape + (8,)).astype(np.float32)
    acc_lse = rng.standard_normal(shape).astype(np.float32)
    lse_i = rng.standard_normal(shape).astype(np.float32)
    acc_lse[0, 0, :4] = -np.inf
    lse_i[0, 0, 2:6] = -np.inf
    lse_i[1, 2, 5] = acc_lse[1, 2, 5]  # a tie in the max
    g_out = rng.standard_normal(shape + (8,)).astype(np.float32)
    g_lse = rng.standard_normal(shape).astype(np.float32)

    def jloss(a, b, c, d):
        o, l = j_combine(a, b, c, d)
        return jnp.sum(o * g_out) + jnp.sum(
            jnp.where(jnp.isfinite(l), l, 0.0) * g_lse)

    args = (acc_out, acc_lse, out_i, lse_i)
    jo, jl = j_combine(*(jnp.asarray(a) for a in args))
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*args)
    ta = [torch.from_numpy(a).requires_grad_() for a in args]
    to, tl = t_combine(*ta)
    (torch.sum(to * torch.from_numpy(g_out)) + torch.sum(torch.where(
        torch.isfinite(tl), tl, torch.zeros(())) * torch.from_numpy(g_lse))
     ).backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=1e-6)
    np.testing.assert_array_equal(np.isfinite(tl.detach().numpy()),
                                  np.isfinite(np.asarray(jl)))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=1e-6)
    for t, g in zip(ta, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-6)


def test_axis_order_is_the_reference():
    from ddstore_tpu.parallel.mesh import AXIS_ORDER as J_ORDER

    assert AXIS_ORDER == J_ORDER


def test_make_mesh_matches_reference(ring):
    # each rank sits where the reference's make_mesh puts the device of
    # the same index, with the same axis names in the same order
    _, ranks = ring
    for key, (names, _) in ranks[0]["_meshes"].items():
        axes = dict(key)
        jm = j_make_mesh(axes, jax.devices()[:WORLD])
        assert tuple(names) == tuple(jm.axis_names)
        where = {int(d.id): pos for pos, d in np.ndenumerate(jm.devices)}
        for rank, r in enumerate(ranks):
            got = r["_meshes"][key][1]
            assert got == {a: int(p) for a, p in zip(jm.axis_names,
                                                      where[rank])}
    with pytest.raises(ValueError) as want:
        j_make_mesh({"dp": 3, "sp": 4})
    assert all(r["_bad_mesh"] == str(want.value) for r in ranks)
