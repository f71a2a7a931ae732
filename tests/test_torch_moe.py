"""Parity of the port's MoE with the JAX reference, on the CPU at f32: the
layer (``models/moe.py``), the MoE LM's loss and gradients, its decode
and ``generate``, and the weights' trees.

Every case of ``tests/test_moe.py`` runs through both layers on the same
numpy-seeded input and weights: the routing (each assignment's expert,
slot and whether it is kept) must equal the reference's exactly, the
output and the aux within 1e-5. The LM's loss within 1e-5 relative and its
gradients within rtol 1e-4, atol 1e-6 (``tests/test_torch_train.py``'s
tolerance, summation order only); decode logits within 2e-4 of the full
forward (``tests/test_decode.py:95``); generated tokens exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ddstore_tpu.models import decode as jdec
from ddstore_tpu.models import transformer as jtr
from ddstore_tpu.models.moe import MoeMlp as JMoe
from ddstore_tpu_torch import weights
from ddstore_tpu_torch.models import decode as tdec
from ddstore_tpu_torch.models import moe as tmoe
from ddstore_tpu_torch.models import transformer as ttr

from torch_parity import flat_leaves, lm_pair, positions, tokens

pytestmark = pytest.mark.tier1_required

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# (experts, hidden, dim, tokens, top_k, capacity_factor, capacity, valid)
# of each MoeMlp of tests/test_moe.py
LAYER_CASES = {
    "routes_and_balances": (4, 32, 16, 64, 1, 2.0, None, None),
    "capacity_drop": (4, 32, 16, 64, 1, 0.1, None, None),
    "topk2_dense_mixture": (4, 32, 16, 48, 2, 8.0, None, None),
    "topk1_dropless": (4, 32, 16, 32, 1, 2.0, 32, None),
    "pad_invariance": (2, 8, 8, 20, 1, 2.0, 3,
                       np.r_[np.ones(5, bool), np.zeros(8, bool),
                             np.ones(7, bool)]),
    "first_choices_priority": (2, 8, 8, 16, 2, 0.5, None, None),
    "valid_mask_frees_capacity": (2, 8, 8, 16, 1, 0.25, None,
                                  np.arange(16) >= 8),
    "unmasked_overflow": (2, 8, 8, 16, 1, 0.25, None, None),
}


def layer_pair(e, h, d, t, k, cf, cap, seed=0):
    """(flax MoeMlp, its params, the port's MoeMlp with those weights, the
    input (T, d) as numpy)."""
    jm = JMoe(n_experts=e, hidden=h, top_k=k, capacity_factor=cf,
              capacity=cap, compute_dtype=jnp.float32)
    x = np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)
    params = jm.init(jax.random.key(seed + 1), jnp.asarray(x))
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    tm = tmoe.MoeMlp(d, e, h, capacity_factor=cf, top_k=k, capacity=cap,
                     compute_dtype=torch.float32, device="cpu")
    with torch.no_grad():
        tm.router.weight.copy_(torch.tensor(p["router"]["kernel"].T))
        for n in ("w1", "b1", "w2", "b2"):
            getattr(tm, n).copy_(torch.tensor(p[n]))
    return jm, params, tm, x


def reference_routing(params, x, k, cap, valid):
    """The reference layer's routing (``moe.py:89-100``): each choice-major
    assignment's expert, 0-based slot and whether it is kept."""
    w = params["params"]["router"]["kernel"]
    probs = jax.nn.softmax(jnp.asarray(x) @ w, axis=-1)
    _, topi = jax.lax.top_k(probs, k)
    e = w.shape[1]
    oh = jax.nn.one_hot(topi, e, dtype=jnp.float32)
    if valid is not None:
        oh = oh * jnp.asarray(valid, jnp.float32)[:, None, None]
    ohm = oh.transpose(1, 0, 2).reshape(k * x.shape[0], e)
    pos = jnp.cumsum(ohm, axis=0) * ohm
    keep = (pos > 0) & (pos <= cap)
    expert = np.asarray(topi).T
    slot = np.asarray(pos.sum(-1)).reshape(k, -1).astype(np.int64) - 1
    return expert, slot, np.asarray(keep.any(-1)).reshape(k, -1)


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_reference(case):
    e, h, d, t, k, cf, cap, valid = LAYER_CASES[case]
    jm, params, tm, x = layer_pair(e, h, d, t, k, cf, cap)
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    want_y, want_aux = jm.apply(params, jnp.asarray(x), jv)
    got_y, got_aux = tm(torch.from_numpy(x), tv)
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(want_y),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got_aux.detach()), float(want_aux), rtol=0,
                               atol=1e-5)
    cap_used = tm.capacity_for(t)
    r = tm.routing(torch.from_numpy(x), tv)
    assert r.capacity == cap_used
    expert, slot, kept = reference_routing(params, x, k, cap_used, valid)
    np.testing.assert_array_equal(r.expert.numpy(), expert)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    # a slot is defined where the assignment is counted (valid tokens)
    counted = np.ones_like(kept) if valid is None else \
        np.broadcast_to(valid, kept.shape)
    np.testing.assert_array_equal(r.slot.numpy()[counted], slot[counted])
    # dropped rows are exactly zero; masked rows too
    out = got_y.detach().numpy()
    dropped = ~kept.any(0)
    assert (np.abs(out[dropped]).sum(axis=1) == 0).all()


def test_capacity_pressure_drops_second_choices_first():
    # tests/test_moe.py:171: with top-2 at cf 0.5 some second choices drop
    # and no first choice to an expert drops while a second one is kept
    jm, params, tm, x = layer_pair(*LAYER_CASES["first_choices_priority"]
                                   [:-1])
    r = tm.routing(torch.from_numpy(x))
    kept, expert = r.kept.numpy(), r.expert.numpy()
    assert (~kept).any()
    for ei in range(2):
        if kept[1][expert[1] == ei].any():
            assert kept[0][expert[0] == ei].all()


def test_layer_gradients_match_reference():
    e, h, d, t, k, cf, cap, valid = LAYER_CASES["first_choices_priority"]
    jm, params, tm, x = layer_pair(e, h, d, t, k, cf, cap)
    w = np.random.default_rng(5).normal(size=(t, d)).astype(np.float32)

    def jloss(p, xx):
        y, aux = jm.apply(p, xx)
        return jnp.sum(y * w) + aux

    jg, jx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tm(xt)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jx), **GRAD_TOL)
    jg = jax.tree_util.tree_map(np.asarray, jg)["params"]
    np.testing.assert_allclose(tm.router.weight.grad.numpy().T,
                               jg["router"]["kernel"], **GRAD_TOL)
    for n in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(getattr(tm, n).grad.numpy(), jg[n],
                                   err_msg=n, **GRAD_TOL)


class _Largest(TorchDispatchMode):
    """The largest tensor any op returns while active."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def test_no_one_hot_dispatch_tensor():
    # the reference's dm is (k, T, E, C); the port's largest tensor is the
    # (E, C, h) hidden activation or the (k, T, d) outputs
    e, h, d, t, k = 8, 16, 16, 128, 2
    _, _, tm, x = layer_pair(e, h, d, t, k, 2.0, None)
    cap = tm.capacity_for(t)
    with _Largest() as seen:
        y, aux = tm(torch.from_numpy(x).requires_grad_())
        (y.sum() + aux).backward()
    assert seen.numel <= max(e * cap * h, (e * cap + 1) * d, k * t * d,
                             e * h * d)
    assert seen.numel < k * t * e * cap // 8


def test_expert_init_counts_experts_as_receptive_field():
    # flax's lecun_normal on (E, d, h): fan-in E * d
    m = ttr.TransformerLM(vocab=64, dim=64, heads=4, layers=1, n_experts=8,
                          device="cpu")
    m.init_weights(torch.Generator().manual_seed(0))
    w1, w2 = m.blocks[0].moe.w1.detach(), m.blocks[0].moe.w2.detach()
    assert abs(float(w1.std()) - (8 * 64) ** -0.5) < 2e-3
    assert abs(float(w2.std()) - (8 * 256) ** -0.5) < 1e-3
    assert not m.blocks[0].moe.b1.detach().any()
    # the initializer the reference's MoeMlp declares w1 with (moe.py:106)
    jw1 = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.key(0), (8, 64, 256)))
    assert abs(float(jw1.std()) - float(w1.std())) < 2e-3


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_weights_round_trip(top_k):
    jm, params, tm = lm_pair(n_experts=4, moe_top_k=top_k)
    tree = jax.tree_util.tree_map(np.asarray, params)
    back = flat_leaves(weights.to_flax(tm)["params"])
    for path, leaf in flat_leaves(tree["params"]).items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=path)
    # the router is a Dense kernel (transposed); the experts are not
    assert tm.blocks[0].moe.router.weight.shape == (4, 64)
    assert tm.blocks[0].moe.w1.shape == (4, 64, 256)


@pytest.mark.parametrize("top_k,capacity", [(1, None), (2, None), (2, 24)])
def test_lm_loss_and_gradients_match_reference(top_k, capacity):
    jm, params, tm = lm_pair(n_experts=4, moe_top_k=top_k,
                             moe_capacity=capacity)
    tok, tgt, pos = tokens(2, 32, jm.vocab, seed=3), \
        tokens(2, 32, jm.vocab, seed=4), positions(2, 32)
    want, jg = jax.jit(jax.value_and_grad(
        lambda p: jtr.lm_loss(jm, p, tok, tgt, pos)))(params)
    got = ttr.lm_loss(tm, *(torch.from_numpy(a) for a in (tok, tgt, pos)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    aux = float(ttr.moe_aux_sum(tm))
    assert 0.5 * tm.layers < aux < 4 * tm.layers
    got.backward()
    gg = flat_leaves(weights.to_flax(
        {n: p.grad for n, p in tm.named_parameters()})["params"])
    for path, w in flat_leaves(jax.tree_util.tree_map(
            np.asarray, jg)["params"]).items():
        np.testing.assert_allclose(gg[path], w, err_msg=path, **GRAD_TOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_decode_step_matches_full_forward_and_reference(top_k):
    # tests/test_decode.py:95: 16 tokens over 2 experts at cf 2 never
    # overflow, so the dropless decode equals training routing
    jm, params, tm = lm_pair(n_experts=2, moe_top_k=top_k)
    b, s = 2, 8
    tok = tokens(b, s, jm.vocab, seed=5)
    with torch.no_grad():
        full = tm(torch.from_numpy(tok), torch.from_numpy(positions(b, s)))
    cache = tdec.init_cache(tm, b, s)
    jc = jdec.init_cache(jm, b, s)
    jstep = jax.jit(lambda c, t, x: jdec.decode_step(jm, params, c, t, x))
    for t in range(s):
        logits, cache = tdec.decode_step(tm, cache, t,
                                         torch.from_numpy(tok[:, t:t + 1]))
        jl, jc = jstep(jc, t, jnp.asarray(tok[:, t:t + 1]))
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=str(t))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   rtol=1e-5, atol=1e-5, err_msg=str(t))


@pytest.mark.parametrize("top_k", [1, 2])
def test_generate_matches_reference(top_k):
    # tests/test_decode.py:172 and test_moe.py:262: the prefill routes as
    # training does; padded prompts with prompt_lengths continue as the
    # unpadded ones do (pads take no capacity, capacity of the real count)
    jm, params, tm = lm_pair(n_experts=4, moe_top_k=top_k,
                             moe_capacity=None)
    prompts = tokens(4, 5, jm.vocab, seed=7)
    padded = np.concatenate([prompts, np.full((4, 4), jm.vocab - 1,
                                              np.int32)], axis=1)
    lens = np.full(4, 5, np.int32)
    want = np.asarray(jdec.generate(jm, params, jnp.asarray(prompts), 4))
    want_pad = np.asarray(jdec.generate(jm, params, jnp.asarray(padded), 4,
                                        prompt_lengths=jnp.asarray(lens)))
    got = tdec.generate(tm, torch.from_numpy(prompts).long(), 4).numpy()
    got_pad = tdec.generate(tm, torch.from_numpy(padded).long(), 4,
                            prompt_lengths=lens).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_pad, want_pad)
    np.testing.assert_array_equal(got_pad[:, 9:], got[:, 5:])


def test_prefill_routing_ignores_padding_under_pressure():
    # test_moe.py:137's recipe through the LM: with a capacity that drops
    # real tokens, masked pads and the real count's capacity give the
    # unpadded prompt's features exactly
    jm, params, tm = lm_pair(n_experts=2, moe_top_k=1)
    prompts = tokens(2, 8, jm.vocab, seed=8)
    padded = np.concatenate([prompts, np.zeros((2, 8), np.int32)], axis=1)
    pos = positions(2, 16)
    mask = torch.from_numpy(pos < 8)
    cap = tmoe.default_capacity(16, 2, 1, 0.25)
    with torch.no_grad():
        plain = tm(torch.from_numpy(prompts), torch.from_numpy(pos[:, :8]),
                   return_features=True, moe_capacity=cap)
        pad = tm(torch.from_numpy(padded), torch.from_numpy(pos),
                 return_features=True, token_mask=mask, moe_capacity=cap)
    routed = tm.blocks[0].moe.stats["routed"]
    assert int(routed.sum()) == 16  # the pads took no slot
    np.testing.assert_array_equal(pad[:, :8].numpy(), plain.numpy())


def test_moe_refuses_a_split_sequence():
    """MoE over a mesh that splits the sequence was refused until routing
    took the global token order (``tests/test_torch_moe_sp.py`` holds it
    to the reference): the model now builds over a dp x sp mesh, its
    layers routing this rank's tokens alone until ``create_train_state``
    places them."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", torch.arange(2).view(1, 2),
                      mesh_dim_names=("dp", "sp"), _init_backend=False,
                      _rank=0)
    m = ttr.TransformerLM(vocab=64, dim=32, heads=4, layers=1, n_experts=2,
                          device="cpu", mesh=mesh)
    assert m.mesh is mesh and m.blocks[0].moe.route_group is None
    assert m.blocks[0].moe.route_place is None
