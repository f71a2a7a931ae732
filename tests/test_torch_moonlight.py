"""DeepSeek-V3's block in the port (``TransformerLM``'s ``deepseek``) against
the plain reference of the Moonlight cell (``benchmark/
reference_moonlight.py``), seeded and small, on the CPU, in f32 so that
the two agree to rounding:

* latent attention with rope and the shared rotary key, and rope against
  DeepSeek's permuted-halves form;
* the held-expert layer: its choices, gates, shared experts, balance
  loss and the bias update; its shares of an expert-parallel deployment
  summing to the uncut layer;
* the whole LM's loss, gradients and 3 Adam steps through
  ``make_train_step``, and a tiny benchmark cell through its job;
* ``flash_attention`` with values narrower than the keys, and, on a
  card only, the kernels' (192, 128) route against the plain one;
* the paths that refuse the options.
"""

from __future__ import annotations

import ast
import json
import math
import os

import pytest
import torch
import torch.nn.functional as F

from benchmark import reference_moonlight as rmoon
from benchmark import weights_moonlight
from ddstore_tpu_torch.models import decode
from ddstore_tpu_torch.models import transformer as tr
from ddstore_tpu_torch.models.moe import RoutedExperts, RoutedSpec
from ddstore_tpu_torch.ops.attention import flash_attention, mha_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the cell's model block at a tiny width: every kind of layer, 4 of 16
# experts held, 4 chosen a token
TINY = dict(vocab=256, dim=64, heads=4, layers=3, compute_dtype="float32",
            initializer_range=0.02, norm_eps=1e-5, rope_theta=50000.0,
            kv_rank=32, qk_nope=16, qk_rope=8, v_dim=12, dense_layers=1,
            dense_hidden=96, experts=16, held=[4, 4], top_k=4,
            expert_hidden=24, shared=2, scale=2.446, bias_rate=1e-3,
            balance=1e-4)


def _spec(m, held=None):
    return RoutedSpec(m["experts"], m["top_k"], m["expert_hidden"],
                      held=tuple(m["held"] if held is None else held),
                      shared=m["shared"], scale=m["scale"],
                      bias_rate=m["bias_rate"], balance=m["balance"])


def _deepseek(m):
    return tr.DeepSeekSpec(
        mla=tr.MlaSpec(m["kv_rank"], m["qk_nope"], m["qk_rope"],
                       m["v_dim"]),
        routed=_spec(m), dense_hidden=m["dense_hidden"],
        dense_layers=m["dense_layers"], norm_eps=m["norm_eps"],
        rope_theta=m["rope_theta"])


def _model(m, dtype=torch.float32):
    return tr.TransformerLM(
        vocab=m["vocab"], dim=m["dim"], heads=m["heads"],
        layers=m["layers"], compute_dtype=dtype, device="cpu",
        deepseek=_deepseek(m))


def _loaded(m, seed, dtype=torch.float32):
    model = _model(m, dtype)
    missing, unexpected = model.load_state_dict(
        weights_moonlight.make(m, seed, "cpu"), strict=False)
    assert not unexpected and all(k.endswith("score_bias") for k in missing)
    return model


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("seed", [0, 1])
def test_mla_block_matches_the_reference(seed):
    m = dict(TINY, layers=1)
    model = _loaded(m, seed)
    blk = model.blocks[0]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 24, m["dim"], generator=g)
    pos = torch.arange(24).expand(2, 24)
    xa = x.clone().requires_grad_()
    y, _, _ = blk(xa, rotary=tr.rope_table(pos, m["qk_rope"],
                                           m["rope_theta"]))
    y.sum().backward()
    P = {k: v.detach().clone().requires_grad_()
         for k, v in weights_moonlight.make(m, seed, "cpu").items()}
    xr = x.clone().requires_grad_()
    with rmoon.exact_matmuls():
        yr, _ = rmoon._layer(0, xr, P, m, {}, "f32", (), {})
        yr.sum().backward()
    assert _rel(y, yr) < 1e-5
    assert _rel(xa.grad, xr.grad) < 1e-5
    for name, p in blk.named_parameters():
        assert _rel(p.grad, P["blocks.0." + name].grad) < 1e-5, name


def test_rope_pairs_give_deepseeks_permuted_halves_scores():
    """DeepSeek's code permutes each rotary vector's pairs to halves and
    rotates halves; the scores q . k are the same as rotating the pairs
    in place."""
    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn(1, 10, 2, 8, generator=g) for _ in range(2))
    pos = torch.arange(10)[None]
    table = tr.rope_table(pos, 8, 50000.0)
    ours = torch.einsum("bshd,bthd->bhst", tr.rope(q, table),
                        tr.rope(k, table))

    def halves(x):
        x = x.unflatten(-1, (4, 2)).transpose(-1, -2).flatten(-2)
        x1, x2 = x[..., :4], x[..., 4:]
        inv = 50000.0 ** (-torch.arange(0, 8, 2).float() / 8)
        ang = torch.arange(10).float()[:, None] * inv
        cos = torch.cat([ang.cos(), ang.cos()], -1)[None, :, None]
        sin = torch.cat([ang.sin(), ang.sin()], -1)[None, :, None]
        return x * cos + torch.cat([-x2, x1], -1) * sin

    theirs = torch.einsum("bshd,bthd->bhst", halves(q), halves(k))
    assert torch.allclose(ours, theirs, atol=1e-5)


def _expert_pair(m, seed, held=None):
    layer = RoutedExperts(m["dim"], _spec(m, held), torch.float32)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
        layer.score_bias.copy_(torch.randn(m["experts"], generator=g)
                               * 0.05)
    return layer, g


@pytest.mark.parametrize("rows", [1, 3])
def test_expert_layer_matches_the_reference(rows):
    m = TINY
    layer, g = _expert_pair(m, rows)
    x = torch.randn(rows * 20, m["dim"], generator=g)
    xa = x.clone().requires_grad_()
    y, bal = layer(xa, rows=rows)
    (y.sum() + bal * 1e3).backward()
    P = {"b.moe." + n: p.detach().clone().requires_grad_()
         for n, p in layer.named_parameters()}
    xr = x.clone().requires_grad_()
    with rmoon.exact_matmuls():
        yr, balr, counts = rmoon._experts(xr.view(rows, 20, -1), P, "b.",
                                          m, layer.score_bias, "f32", ())
        (yr.sum() + balr * 1e3).backward()
    assert torch.equal(counts, layer.stats["counts"])
    first, count = m["held"]
    assert layer.stats["held"].tolist() == counts[first:first + count].tolist()
    assert _rel(y, yr.view_as(y)) < 1e-5
    assert abs(float(bal) - float(balr)) <= 1e-6 * abs(float(balr))
    assert _rel(xa.grad, xr.grad) < 1e-5
    for n, p in layer.named_parameters():
        assert _rel(p.grad, P["b.moe." + n].grad) < 1e-5, n


def test_gates_come_from_the_scores_without_the_bias():
    """A large bias on one expert makes every token choose it, yet its
    gate is ``scale * s_i / sum of the chosen s`` from the sigmoid scores
    alone."""
    m = TINY
    layer, g = _expert_pair(m, 5)
    with torch.no_grad():
        layer.score_bias.zero_()
        layer.score_bias[5] = 10.0
    x = torch.randn(16, m["dim"], generator=g)
    idx, gates, _ = layer.route(x, 1)
    assert (idx == 5).any(-1).all()
    s = torch.sigmoid(F.linear(x, layer.router.weight))
    chosen = s.gather(1, idx)
    want = m["scale"] * chosen / chosen.sum(-1, keepdim=True)
    assert torch.allclose(gates, want, atol=1e-6)


def test_balance_loss_is_deepseek_v3_sequence_wise():
    """Eqs. 17-20: alpha * sum_i f_i P_i a row, averaged over rows, f_i
    = E / (k T) * the row's choices of i, P_i the row's mean normalised
    score."""
    m = TINY
    layer, g = _expert_pair(m, 6)
    x = torch.randn(2 * 10, m["dim"], generator=g)
    idx, _, bal = layer.route(x, 2)
    s = torch.sigmoid(F.linear(x, layer.router.weight)).view(2, 10, -1)
    want = 0.0
    for r in range(2):
        f = torch.zeros(m["experts"])
        for e in idx.view(2, 10, -1)[r].reshape(-1).tolist():
            f[e] += m["experts"] / (m["top_k"] * 10)
        p = (s[r] / s[r].sum(-1, keepdim=True)).mean(0)
        want += m["balance"] * float((f * p).sum()) / 2
    assert abs(float(bal) - want) < 1e-9


def test_bias_moves_by_the_sign_of_the_load_gap():
    m = TINY
    layer, g = _expert_pair(m, 7)
    before = layer.score_bias.clone()
    layer(torch.randn(30, m["dim"], generator=g), rows=1)
    layer(torch.randn(30, m["dim"], generator=g), rows=1)
    load = layer.load.float().clone()
    assert int(load.sum()) == 60 * m["top_k"]
    layer.update_bias()
    want = before + m["bias_rate"] * torch.sign(load.mean() - load)
    assert torch.equal(layer.score_bias, want)
    assert int(layer.load.sum()) == 0


def test_shares_sum_to_the_uncut_layer():
    """Eight ranks of expert parallelism, each holding 2 of 16 experts:
    their partial outputs, with the shared experts (which every rank
    computes alike) counted once, add up to the layer that holds all."""
    m = TINY
    whole, g = _expert_pair(m, 8, held=(0, m["experts"]))
    x = torch.randn(24, m["dim"], generator=g)
    y_whole, _ = whole(x, rows=1)
    shared = None
    total = torch.zeros_like(y_whole)
    for r in range(8):
        part = RoutedExperts(m["dim"], _spec(m, (2 * r, 2)), torch.float32)
        with torch.no_grad():
            for n, p in part.named_parameters():
                src = dict(whole.named_parameters())[n]
                p.copy_(src[2 * r:2 * r + 2] if n in ("w_in", "w_out")
                        else src)
            part.score_bias.copy_(whole.score_bias)
        y, _ = part(x, rows=1)
        if shared is None:
            with torch.no_grad():
                gu = F.linear(x, part.shared_gate_up.weight).chunk(2, -1)
                shared = F.linear(F.silu(gu[0]) * gu[1],
                                  part.shared_down.weight)
        total += y - shared
        assert torch.equal(part.stats["counts"], whole.stats["counts"])
    assert _rel(total + shared, y_whole) < 1e-5


@pytest.mark.parametrize("seed", [11, 12])
def test_lm_loss_gradients_and_adam_steps_match_the_reference(seed):
    m = TINY
    model = _loaded(m, seed)
    state, opt = tr.create_train_state(model, lr=1e-3)
    step = tr.make_train_step(model, opt, state=state)
    g = torch.Generator().manual_seed(seed)
    batches = [tuple(torch.randint(0, m["vocab"], (2, 32), generator=g)
                     for _ in range(2)) for _ in range(3)]
    pos = torch.arange(32).expand(2, 32)
    losses, grad1, counts1 = [], {}, None
    for i, (tok, tgt) in enumerate(batches):
        losses.append(float(step(tok, tgt, pos)))
        if i == 0:
            grad1 = {k: float(opt.state[p]["exp_avg"].norm()) / 0.1
                     for k, p in model.named_parameters()}
            counts1 = [blk.moe.stats["counts"].tolist()
                       for blk in model.blocks if blk.routed is not None]
    ref_losses, ref_grad1, ref_change, ref_counts = rmoon.train(
        m, lambda: weights_moonlight.make(m, seed, "cpu"), batches, 1e-3)
    p0 = weights_moonlight.make(m, seed, "cpu")
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert rmoon.routing_gap(counts1, ref_counts) == 0
    for k, p in model.named_parameters():
        assert abs(grad1[k] - ref_grad1[k]) <= 1e-4 * ref_grad1[k] + 1e-9, k
        change = float((p.detach() - p0[k]).norm())
        assert abs(change - ref_change[k]) <= 1e-3 * ref_change[k] + 1e-9, k
    biases = [blk.moe.score_bias for blk in model.blocks
              if blk.routed is not None]
    assert all(bool(b.abs().max() > 0) for b in biases)


@pytest.mark.parametrize("dv", [8, 12, 24])
def test_flash_attention_takes_values_narrower_than_keys(dv):
    g = torch.Generator().manual_seed(dv)
    q, k = (torch.randn(2, 3, 40, 24, generator=g).requires_grad_()
            for _ in range(2))
    v = torch.randn(2, 3, 40, dv, generator=g).requires_grad_()
    out, lse = flash_attention(q, k, v, causal=True)
    assert out.shape == (2, 3, 40, dv)
    do = torch.randn(2, 3, 40, dv, generator=g)
    (out * do).sum().backward()
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sc = qr @ kr.transpose(-1, -2) / math.sqrt(24)
    sc = sc.masked_fill(torch.ones(40, 40, dtype=torch.bool).triu(1),
                        float("-inf"))
    ref = torch.softmax(sc, -1) @ vr
    (ref * do).sum().backward()
    assert _rel(out, ref) < 1e-5
    assert _rel(lse, mha_reference(qr, kr, vr, causal=True)[1]) < 1e-6
    for a, b in ((q, qr), (k, kr), (v, vr)):
        assert _rel(a.grad, b.grad) < 1e-5


def test_flash_attention_refuses_values_wider_than_queries():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="at most q's"):
        flash_attention(q, q, torch.zeros(1, 1, 8, 24))


@pytest.mark.gpu
def test_latent_attention_route_on_the_card_matches_the_plain_one():
    """On a card, q and k 192 wide and v 128 through the kernels (v
    zero-padded to 192, out and dv cut back) against the plain path on the
    CPU, bf16, each tensor within 2e-2 of its L2 norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator().manual_seed(192)
    q, k = (torch.randn(1, 4, 1024, 192, generator=g).bfloat16()
            for _ in range(2))
    v = torch.randn(1, 4, 1024, 128, generator=g).bfloat16()
    do = torch.randn(1, 4, 1024, 128, generator=g).bfloat16()
    res = {}
    for dev in ("cuda", "cpu"):
        ts = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out, lse = flash_attention(*ts, causal=True)
        out.backward(do.to(dev))
        res[dev] = [out.detach(), lse] + [t.grad for t in ts]
    for a, b in zip(res["cuda"], res["cpu"]):
        assert _rel(a.cpu(), b) < 2e-2


@pytest.mark.gpu
def test_held_row_kernels_on_the_card_match_the_plain_ones():
    """On a card, each row kernel of ``ops/held.py`` against its plain
    version on the CPU, over the rows the held choices fill (a quarter of
    tokens x top_k), bf16, within 1e-3 of each tensor's L2 norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from ddstore_tpu_torch.ops import held

    g = torch.Generator().manual_seed(27)
    t, k, d, h = 512, 6, 256, 88
    rows = t * k
    mine = torch.rand(t, k, generator=g) < 0.25
    n = int(mine.sum())
    pos = torch.full((t, k), -1, dtype=torch.int64)
    pos[mine] = torch.randperm(n, generator=g)
    offs = torch.tensor([n // 2, n // 2, n], dtype=torch.int32)
    gates = torch.rand(t, k, generator=g)
    x, ys = (torch.randn(r, d, generator=g).bfloat16() for r in (t, rows))
    dy = torch.randn(t, d, generator=g)
    gu = torch.randn(rows, 2 * h, generator=g).bfloat16()
    da = torch.randn(rows, h, generator=g).bfloat16()
    sel = pos[mine]

    def both(fn, *args):
        cuda = [a.cuda() if isinstance(a, torch.Tensor) else a
                for a in args]
        return fn(*cuda), fn(*args)

    pairs = [both(held.scatter_rows, x, pos, rows),
             both(held.combine, ys, pos, gates, torch.float32),
             both(held.combine, ys, pos, None, torch.bfloat16),
             both(held.swiglu_rows, gu, offs),
             both(held.swiglu_bwd, gu, da, offs)]
    pairs = [(a[:n], b[:n]) if a.shape[0] == rows else (a, b)
             for a, b in pairs]
    (dys, dg), (dys_p, dg_p) = both(held.combine_bwd, dy, ys, pos, gates)
    pairs += [(dys[sel.cuda()], dys_p[sel]), (dg, dg_p)]
    for a, b in pairs:
        assert _rel(a.cpu(), b) < 1e-3


class _Mesh:
    """What ``parallel.mesh.axis_size`` reads of a mesh."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())


@pytest.mark.parametrize("path", ["init_cache", "generate", "return_kv",
                                  "ring", "ep_state", "dp_step_routed",
                                  "pipeline", "unshard", "with_n_experts"])
def test_paths_that_do_not_take_the_options_refuse_them(path):
    m = dict(TINY, layers=2)
    model = _model(m)
    tok = torch.zeros(1, 8, dtype=torch.int64)
    with pytest.raises(ValueError):
        if path == "init_cache":
            decode.init_cache(model, 1, 16)
        elif path == "generate":
            decode.generate(model, tok, 2)
        elif path == "return_kv":
            model(tok, torch.arange(8)[None], return_kv=True)
        elif path == "ring":
            tr.TransformerLM(vocab=m["vocab"], dim=m["dim"],
                             heads=m["heads"], layers=1, device="cpu",
                             mesh=_Mesh(sp=2), deepseek=_deepseek(m))
        elif path == "ep_state":
            tr.create_train_state(model, mesh=_Mesh(ep=2))
        elif path == "dp_step_routed":
            _, opt = tr.create_train_state(model)
            tr.make_train_step(model, opt, mesh=_Mesh(dp=2))
        elif path == "pipeline":
            tr.lm_to_stages(model, 2)
        elif path == "unshard":
            tr.unshard(model)
        else:
            tr.TransformerLM(vocab=64, dim=32, heads=2, layers=1,
                             device="cpu", n_experts=4,
                             deepseek=_deepseek(TINY))


def test_options_are_off_by_default():
    model = tr.TransformerLM(vocab=64, dim=32, heads=2, layers=2,
                             device="cpu")
    assert not model.extended and model.routed is None
    names = [n for n, _ in model.named_parameters()]
    assert "blocks.0.qkv.weight" in names and "blocks.0.ln1.bias" in names
    assert model.embed.sinusoids


def test_reference_imports_torch_and_the_benchmark_alone():
    for name in ("reference_moonlight.py", "weights_moonlight.py",
                 "arith_moonlight.py"):
        path = os.path.join(REPO, "benchmark", name)
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = ["." if node.level else node.module]
            for mod in mods:
                assert mod == "." or mod.split(".")[0] in (
                    "torch", "__future__", "math", "typing"), (name, mod)


TINY_CELL = "tinymoon.train"
TINY_SEED = 4294967311


def make_tiny_root(dst) -> str:
    """A copy of the benchmark's folder under ``dst`` with the Moonlight
    cell's block at the tiny width as the cell ``tinymoon.train``, held
    to the full cell's limits; returns that folder."""
    import shutil

    root = os.path.join(str(dst), "benchmark")
    shutil.copytree(os.path.join(REPO, "benchmark"), root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(root, "configs", "moonlight-16b-a3b.json")) as f:
        cfg = json.load(f)
    model = dict(TINY, compute_dtype="bfloat16")
    with open(os.path.join(root, "configs", "tinymoon.json"), "w") as f:
        json.dump(dict(cfg, name="tinymoon", model=model), f)
    with open(os.path.join(root, "traffic", "tinymoon_mix.json"), "w") as f:
        json.dump({"job": "train_moonlight", "rows": 2, "seq": 64,
                   "shard_windows": 1024, "order": "random", "ranks": 1,
                   "lr": 3e-4, "checked_steps": 3, "warmup_steps": 1,
                   "trace_steps": 2}, f)
    with open(os.path.join(root, "workloads",
                           "moonlight-16b-a3b.train.json")) as f:
        w = json.load(f)
    w.update(config="tinymoon", traffic="tinymoon_mix")
    with open(os.path.join(root, "workloads", TINY_CELL + ".json"),
              "w") as f:
        json.dump(w, f)
    return root


def _run_tiny(root, patch: str = "", trace: int = 1) -> dict:
    """The tiny cell's run on the CPU in a fresh interpreter (the run
    refuses a process that loaded JAX), ``patch`` run first: its result
    line."""
    import subprocess
    import sys

    code = (patch + "\nimport sys; from benchmark.run import main; "
            "sys.exit(main(['--workload', %r, '--seed', %r, '--seconds', "
            "'0.5', '--trace', %r, '--device', 'cpu'], root=%r))"
            % (TINY_CELL, str(TINY_SEED), str(trace), root))
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_tiny_cell_runs_correct_through_its_job(tmp_path):
    """The cell's job at a tiny width on the CPU: the store, the loader,
    the step and the reference, every check under the cell's limits."""
    out = _run_tiny(make_tiny_root(tmp_path))
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                  "routing_gap", "batch_mismatch"}


# faults planted in the program, under the timed path
FAULTS = {
    # half of each row's tokens left out of the loss
    "half": """
from ddstore_tpu_torch.models import transformer as tr
_loss = tr.lm_loss
def _half(model, tokens, targets, positions, **kw):
    n = tokens.shape[1] // 2
    return _loss(model, tokens[:, :n], targets[:, :n], positions[:, :n],
                 **kw)
tr.lm_loss = _half
""",
    # softmax scores in place of the sigmoid
    "softmax": """
import torch
from ddstore_tpu_torch.models import moe
_route = moe.RoutedExperts.route
def _softmax_route(self, x, rows):
    sig = torch.sigmoid
    torch.sigmoid = lambda t: torch.softmax(t, dim=-1)
    try:
        return _route(self, x, rows)
    finally:
        torch.sigmoid = sig
moe.RoutedExperts.route = _softmax_route
""",
    # a step that leaves every parameter as it was
    "unchanged": """
import torch
from ddstore_tpu_torch.models import transformer as tr
_make = tr.make_train_step
def _frozen_step(model, opt, **kw):
    step = _make(model, opt, **kw)
    def frozen(*args):
        before = [p.detach().clone() for p in model.parameters()]
        loss = step(*args)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return loss
    return frozen
tr.make_train_step = _frozen_step
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_in_the_tiny_cell_is_not_correct(tmp_path, fault):
    """Each fault planted in the program is judged not correct by the
    job's own judge, under the full cell's limits."""
    out = _run_tiny(make_tiny_root(tmp_path), FAULTS[fault], trace=0)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("reading", ["fp8", "half", "softmax",
                                     "frozen_norm"])
def test_the_control_fails_the_tiny_cells_limits(tmp_path, reading):
    """``control_moonlight``'s readings at the tiny width (the reference
    on fp8 operands, and its faults, in the program's place), judged by
    the job's own judge, each pass at least one of the full cell's
    limits."""
    from benchmark import control_moonlight
    from benchmark.registry import Registry

    cell = Registry(make_tiny_root(tmp_path)).cell(TINY_CELL)
    got = control_moonlight.readings(cell, TINY_SEED,
                                     torch.device("cpu"))[reading]
    limits = cell["workload"]["limits"]
    assert any(v > limits[k] for k, v in got.items()), got
