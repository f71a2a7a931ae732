"""Where the ring's bf16 gradients lose precision: a CPU emulation.

Runs causal attention over (1, 2, S, 64) bf16 inputs from a seed four
ways and holds each against the f32 result (``mha_reference`` and
autograd):

* one whole-sequence call of ``flash_attention`` (its plain versions on
  the CPU, which round where the kernels round);
* the two-rank ring differentiated through ``_combine``, as the
  reference's ``jax.grad`` does, emulated in one process (the same
  ``_combine`` and offsets, no shifts): each step's bf16 out gets the
  cotangent ``w_i * do`` rounded to bf16 (``ring``);
* the same ring with each step's output handed on in f32, so that that
  cotangent reaches its backward unrounded (``ring_f32_do``; the kernels
  cannot take it so: it isolates that rounding);
* the ring's backward on the final lse, as ``parallel/ring_attention.py``
  runs it: each live step's plain dq and dk/dv on the caller's ``do``
  with the final lse and one ``c = rowsum(do * out)``, dq summed in f32,
  each chunk's dk/dv summed in bf16 in the order the ring sends it back
  (``ring_final_lse``).

For each of the second rank's out, dq, dk and dv it prints three ratios
of the ring's error to the one call's: the largest over bands of 256
positions of the bands' worst rows, the worst row over the chunk, and the
largest over bands of the bands' L2 errors (each row's error is relative
to that row of the f32 result, floored at a thousandth of the largest
row, as ``chip_smoke.py``'s ``row_errors``). Run::

    python -m ddstore_tpu_torch.examples.ring_precision --seeds 16
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import attention
from ..parallel.ring_attention import _combine

BAND = 256


class _F32Out(torch.autograd.Function):
    """A ring step whose bf16 out is handed on as f32, so that its
    output gradient arrives unrounded; the backward is the plain one."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_offset):
        out, lse = attention.mha_reference(q, k, v, causal=True,
                                           q_offset=q_offset,
                                           kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = dict(causal=True, q_offset=q_offset, kv_offset=kv_offset,
                       scale=q.shape[-1] ** -0.5)
        return out.float(), lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        c = attention.flash_bwd_prep(do, out, dlse)
        dq = attention.flash_bwd_dq_reference(q, k, v, do, lse, c,
                                              **ctx.cfg)
        dk, dv = attention.flash_bwd_dkv_reference(q, k, v, do, lse, c,
                                                   **ctx.cfg)
        return dq, dk, dv, None, None


class _FinalLse(torch.autograd.Function):
    """The ``n``-rank causal ring with the backward of
    ``parallel/ring_attention.py``'s ``_Ring``, all ranks in one process:
    the forward merges each rank's live steps with ``_combine``; the
    backward runs the plain dq and dk/dv of each live step with the rank's
    final lse and c."""

    @staticmethod
    def forward(ctx, q, k, v, n):
        c = q.shape[2] // n
        chunk = [[t[:, :, i * c:(i + 1) * c] for i in range(n)]
                 for t in (q, k, v)]
        outs, lses = [], []
        for idx in range(n):
            acc_out = torch.zeros(q.shape[:2] + (c, q.shape[3]))
            acc_lse = torch.full(q.shape[:2] + (c,), float("-inf"))
            for src in range(idx, -1, -1):  # the live steps, in ring order
                o, lse = attention.mha_reference(
                    chunk[0][idx], chunk[1][src], chunk[2][src], causal=True,
                    q_offset=idx * c, kv_offset=src * c)
                acc_out, acc_lse = _combine(acc_out, acc_lse, o, lse)
            outs.append(acc_out.to(q.dtype))
            lses.append(acc_lse)
        out = torch.cat(outs, dim=2)
        ctx.save_for_backward(q, k, v, out, torch.cat(lses, dim=2))
        ctx.n = n
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        n, c = ctx.n, q.shape[2] // ctx.n
        part = [[t[:, :, i * c:(i + 1) * c] for i in range(n)]
                for t in (q, k, v, do, out, lse)]
        dq = [torch.zeros(part[0][0].shape) for _ in range(n)]
        dkv = {}
        for idx in range(n):
            cc = attention.flash_bwd_prep(part[3][idx], part[4][idx])
            for src in range(idx + 1):
                args = (part[0][idx], part[1][src], part[2][src],
                        part[3][idx], part[5][idx], cc)
                cfg = dict(causal=True, q_offset=idx * c, kv_offset=src * c,
                           scale=q.shape[-1] ** -0.5)
                dq[idx] += attention.flash_bwd_dq_reference(
                    *args, **cfg).float()
                dkv[idx, src] = attention.flash_bwd_dkv_reference(
                    *args, **cfg)
        dk, dv = [], []
        for src in range(n):
            # chunk src's gradient starts n - 1 ranks on and comes back a
            # rank a step, each adding its share in the chunk's dtype
            g = [torch.zeros_like(part[1][src]) for _ in range(2)]
            for step in range(n - 1, -1, -1):
                share = dkv.get(((src + step) % n, src))
                if share is not None:
                    g = [a + b for a, b in zip(g, share)]
            dk.append(g[0])
            dv.append(g[1])
        return (torch.cat(dq, dim=2).to(q.dtype), torch.cat(dk, dim=2),
                torch.cat(dv, dim=2), None)


def _row_rel(got, want):
    got, want = got.float(), want.float()
    norm = want.norm(dim=-1)
    floor = 1e-3 * float(norm.max())
    return (got - want).norm(dim=-1) / norm.clamp_min(floor)


def _band_l2(got, want):
    def per_band(t):
        return t.pow(2).sum(dim=(0, 1, 3)).reshape(-1, BAND).sum(-1).sqrt()

    return per_band(got.float() - want) / per_band(want)


def _grads(fn, q, k, v, do):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    (out.float() * do.float()).sum().backward()
    return {"out": out.detach(), "dq": leaves[0].grad,
            "dk": leaves[1].grad, "dv": leaves[2].grad}


def _ring(f32_do: bool, n: int = 2):
    """The ring differentiated through ``_combine`` (``f32_do``: with each
    step's out handed on in f32)."""
    def run(q, k, v):
        c = q.shape[2] // n
        chunks = [[t[:, :, i * c:(i + 1) * c] for i in range(n)]
                  for t in (q, k, v)]
        outs = []
        for idx in range(n):
            acc_out = torch.zeros(q.shape[:2] + (c, q.shape[3]))
            acc_lse = torch.full(q.shape[:2] + (c,), float("-inf"))
            for src in range(idx, -1, -1):  # the live steps, in ring order
                args = (chunks[0][idx], chunks[1][src], chunks[2][src])
                if f32_do:
                    o, lse = _F32Out.apply(*args, idx * c, src * c)
                else:
                    o, lse = attention.flash_attention(
                        *args, causal=True, q_offset=idx * c,
                        kv_offset=src * c)
                acc_out, acc_lse = _combine(acc_out, acc_lse, o, lse)
            outs.append(acc_out.to(q.dtype))
        return torch.cat(outs, dim=2)
    return run


def compare(seed: int, seq: int) -> dict:
    """{"<ring> <tensor>": [band worst-row ratio, worst-row ratio, band
    L2 ratio]} on the second rank's rows, for each ring against the one
    call."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((1, 2, seq, 64), generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    ref = _grads(lambda a, b, c: attention.mha_reference(
        a.float(), b.float(), c.float(), causal=True)[0], q, k, v, do)
    one = _grads(lambda a, b, c: attention.flash_attention(
        a, b, c, causal=True)[0], q, k, v, do)
    res = {}
    lo = seq // 2
    rings = (("ring", _ring(False)), ("ring_f32_do", _ring(True)),
             ("ring_final_lse", lambda a, b, c: _FinalLse.apply(a, b, c, 2)))
    for name, ring in rings:
        got = _grads(ring, q, k, v, do)
        for key in ("out", "dq", "dk", "dv"):
            r, o, w = (t[:, :, lo:] for t in (got[key], one[key], ref[key]))
            rr, ro = _row_rel(r, w), _row_rel(o, w)
            bands = [x.amax(dim=(0, 1)).reshape(-1, BAND).amax(-1)
                     for x in (rr, ro)]
            res[f"{name} {key}"] = [
                round(float((bands[0] / bands[1]).max()), 3),
                round(float(rr.max() / ro.max()), 3),
                round(float((_band_l2(r, w) / _band_l2(o, w)).max()), 3)]
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--seq", type=int, default=8192)
    args = ap.parse_args()
    worst: dict = {}
    for seed in range(args.seeds):
        res = compare(seed, args.seq)
        print(f"seed {seed}: {json.dumps(res)}", flush=True)
        for key, vals in res.items():
            worst[key] = [max(a, b) for a, b in
                          zip(worst.get(key, vals), vals)]
    print("largest over seeds (band worst-row, worst-row, band L2 ratios): "
          + json.dumps(worst), flush=True)


if __name__ == "__main__":
    main()
