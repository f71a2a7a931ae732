#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ddstore_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc`` under ``$CUDA_HOME``, default ``/usr/local/cuda``).
It needs no network and imports nothing of JAX or of ``ddstore_tpu``.

Phases; any failure raises and ends the run with a non-zero exit:

1. device: the card's name and power limit, TF32 off for matmuls and
   convolutions (the plain versions are then exact f32 references);
2. build: every CUDA kernel of the port, from the sources in the
   checkout (one ``nvcc`` per source, all started together); the ptxas
   report must show no register spills;
3. kernels: each kernel (flash forward, dq, dk/dv) against its plain
   PyTorch version on the card, at the main path's shapes and at edge
   cases (ragged tiles, fewer queries than a tile, offsets, fully-masked
   rows, keys no query sees, lse cotangents), dq and dk/dv also
   bit-identical over two launches, with timings of the kernel, the plain
   version and one library call (yardstick only);
4. small reference check: a small model on the card (kernels) against
   the same model on the CPU (plain versions): logits, loss, greedy
   tokens, every parameter's gradient, and the parameters after one
   Adam step;
5. serving slice, at the full width of the repo's LM config (vocab 32768,
   dim 1024, 16 heads, 8 layers; ``bench.py:3169``): 4096 token windows
   of 2048 in the store -> sampler -> loader -> card -> eval loss on 4
   batches of (8, 2048) -> greedy generation of 32 tokens after 8
   prompts of 2048. Launch counts are zeroed just before and read just
   after; the flash forward must have run 8 layers x 5 forwards = 40
   times, the backward kernels never. After the counted run, the prefill
   is timed over 5 repeats and one prefill and 4 decode steps run under
   torch.profiler;
6. training slice, same model width and the same windows: store ->
   sampler -> loader -> ``make_train_step`` (Adam, lr 1e-3) for 8 steps
   of (8, 2048), then one step with ``accum_steps=2``. Counts zeroed just
   before and read just after: each of the three kernels must have run
   8 x 8 + 2 x 8 = 80 times; losses finite and falling. After the counted
   run, the fused cross-entropy head is timed alone and one more step
   runs under torch.profiler.

Then it prints the kernel table as one JSON line (each row names its
design: ``wgmma+tma``, the bf16 path of all three kernels), the card's
name and power limit, and as the last line ``{"ok": true, "device":
{...}}``.
Without a card, or outside a checkout, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ddstore_tpu_torch.data.dataset import DistributedSampler, ShardedDataset
from ddstore_tpu_torch.data.loader import DeviceLoader
from ddstore_tpu_torch.models import decode as tdec
from ddstore_tpu_torch.models import transformer as ttr
from ddstore_tpu_torch.ops import _build, attention
from ddstore_tpu_torch.ops.xent import fused_linear_xent
from ddstore_tpu_torch.store import DDStore

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bound of
# a kernel is max(bytes / memory rate, operations / peak rate).
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# The repo's LM config (bench.py:3169) and the slices' traffic.
VOCAB, DIM, HEADS, LAYERS = 32768, 1024, 16, 8
WINDOWS, SEQ, BATCH = 4096, 2048, 8
LOSS_BATCHES, NEW_TOKENS = 4, 32
TRAIN_STEPS, TRAIN_LR, WARMUP_STEPS = 8, 1e-3, 2  # lm_longcontext.py:56

# Kernel against plain version: bf16 out / lse, f32 out and lse (max abs
# error), and the largest error of a live row of out relative to that
# row of the plain version (L2 norms over the head dim): bf16 rounds out
# and P at 2**-8 relative, so an exact kernel stays below about 5e-3.
# The backward kernels are held to the same per-row relative error for
# dq, dk and dv (see row_errors): bf16 rounds P and dS to bf16 at 2**-8
# before their products, f32 only sums in another order.
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 1e-4)}
ROW_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}

# Kernel cases: name, (b, h, sq, sk, d), dtype, causal, q_offset,
# kv_offset; the lm_* cases take the main path's layout (qkv_views).
CASES = [
    ("lm_causal", (BATCH, HEADS, SEQ, SEQ, DIM // HEADS),
     torch.bfloat16, True, 0, 0),
    ("lm_full", (BATCH, HEADS, SEQ, SEQ, DIM // HEADS),
     torch.bfloat16, False, 0, 0),
    ("f32_causal", (2, 4, 512, 512, 64), torch.float32, True, 0, 0),
    ("f32_d128", (1, 4, 256, 256, 128), torch.float32, False, 0, 0),
    ("d128", (2, 8, 1024, 1024, 128), torch.bfloat16, True, 0, 0),
    ("s640", (2, 8, 640, 640, 64), torch.bfloat16, True, 0, 0),
    ("s640_d128_f32", (1, 4, 640, 640, 128), torch.float32, True, 0, 0),
    ("kv_ahead_masked_rows", (1, 4, 256, 256, 64), torch.bfloat16,
     True, 0, 128),
    ("kv_ahead_masked_rows_f32", (1, 4, 256, 256, 64), torch.float32,
     True, 0, 136),
    ("q_offset", (2, 4, 256, 256, 64), torch.bfloat16, True, 192, 64),
    ("cross_len", (1, 4, 136, 520, 64), torch.bfloat16, True, 384, 0),
    # keys 136..519 lie beyond the last query: no query sees them
    ("cross_len_dead_tail", (1, 4, 136, 520, 64), torch.bfloat16, True, 0,
     0),
    # fewer queries than one consumer warpgroup's 64 rows
    ("short_causal", (1, 4, 40, 40, 64), torch.bfloat16, True, 0, 0),
    # head dim 128 with a ragged last tile of 128 queries and of 128 keys
    ("d128_ragged", (1, 4, 200, 200, 128), torch.bfloat16, True, 0, 0),
]
# Backward cases that carry an lse cotangent (dlse != 0).
DLSE_CASES = {"f32_causal", "s640", "kv_ahead_masked_rows", "q_offset",
              "cross_len", "cross_len_dead_tail", "d128_ragged"}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def live_pairs(sq, sk, causal, q_offset, kv_offset):
    """Score pairs (query, key) the causal mask leaves live: row i sees
    keys j with kv_offset + j <= q_offset + i."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, q_offset + i - kv_offset + 1))
               for i in range(sq))


def attention_work(b, h, sq, sk, d, itemsize, causal, q_offset, kv_offset,
                   kind="fwd"):
    """(flops, bytes) a kernel needs on these inputs: its products over the
    live score pairs (2*d FLOP each: the forward's s and pv, dq's s, dp
    and dq, dk/dv's s, dp, dv and dk), each input read once and each
    output written once. The forward reads q, k, v and writes out and the
    f32 lse; dq reads q, k, v, do and the f32 lse and c and writes dq;
    dk/dv reads the same and writes dk and dv."""
    pairs = live_pairs(sq, sk, causal, q_offset, kv_offset)
    products, rows_q, rows_k, f32_rows = {
        "fwd": (2, 2 * sq, 2 * sk, sq),
        "dq": (3, 3 * sq, 2 * sk, 2 * sq),
        "dkv": (4, 2 * sq, 4 * sk, 2 * sq)}[kind]
    flops = 2.0 * products * b * h * d * pairs
    nbytes = b * h * ((rows_q + rows_k) * d * itemsize + f32_rows * 4)
    return flops, nbytes


def bound_of(flops, nbytes):
    """(bound ms, what bounds it) on the H100 SXM's published peaks."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def qkv_views(g, dev, b, h, s, d, dt):
    """q, k, v as ``Block.qkv_heads`` gives them to the kernel: (B, H, S,
    D) views of one (B, S, 3 * H * D) projection (row stride 3 * H * D)."""
    dim = h * d
    qkv = torch.randn((b, s, 3 * dim), generator=g, device=dev).to(dt)
    return tuple(t.reshape(b, s, h, d).transpose(1, 2)
                 for t in qkv.split(dim, dim=-1))


def case_inputs(g, dev, name, shape, dt):
    """q, k, v of a kernel case: the main path's views for the lm_* cases,
    separate tensors otherwise."""
    b, h, sq, sk, d = shape
    if name.startswith("lm_"):
        return qkv_views(g, dev, b, h, sq, d, dt)
    q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dt)
    k, v = (torch.randn((b, h, sk, d), generator=g, device=dev).to(dt)
            for _ in range(2))
    return q, k, v


def phase_kernels(dev):
    """Kernel vs plain version on the card; timings at the LM shape."""
    g = torch.Generator(device=dev).manual_seed(1234)
    errs, rel_errs = {}, {}
    for name, (b, h, sq, sk, d), dt, causal, qo, ko in CASES:
        q, k, v = case_inputs(g, dev, name, (b, h, sq, sk, d), dt)
        with torch.no_grad():
            out, lse = attention.flash_attention(
                q, k, v, causal=causal, q_offset=qo, kv_offset=ko)
            ref_out, ref_lse = attention.mha_reference(
                q, k, v, causal=causal, q_offset=qo, kv_offset=ko)
        torch.cuda.synchronize()
        check(out.shape == q.shape and out.dtype == dt and
              lse.shape == (b, h, sq) and lse.dtype == torch.float32,
              f"{name}: output shapes/dtypes")
        live = torch.isfinite(ref_lse)
        check(not torch.isnan(out).any() and not torch.isnan(lse).any(),
              f"{name}: NaN in the kernel's output")
        check(bool((torch.isfinite(lse) == live).all()),
              f"{name}: fully-masked rows differ")
        dead = ~live
        check(bool((out[dead] == 0).all()) and
              bool((lse[dead] == -math.inf).all()),
              f"{name}: a fully-masked row is not out 0 / lse -inf")
        diff = out.float() - ref_out.float()
        e_out = float(diff.abs().max())
        e_lse = float((lse[live] - ref_lse[live]).abs().max()) \
            if live.any() else 0.0
        e_rel = float((diff.norm(dim=-1)[live] / ref_out.float()
                       .norm(dim=-1)[live].clamp_min(1e-6)).max()) \
            if live.any() else 0.0
        dname = str(dt).split(".")[-1]
        t_out, t_lse = TOL[dname]
        print(f"kernel flash_fwd {name}: b,h,sq,sk,d={b},{h},{sq},{sk},{d} "
              f"{dname} causal={causal} q_offset={qo} kv_offset={ko} "
              f"strides q={q.stride()} masked_rows={int(dead.sum())} "
              f"max_abs_err out={e_out:.3e} (tol {t_out}) "
              f"lse={e_lse:.3e} (tol {t_lse}) max_row_rel_err "
              f"out={e_rel:.3e} (tol {ROW_REL_TOL[dname]})", flush=True)
        check(e_out <= t_out and e_lse <= t_lse and
              e_rel <= ROW_REL_TOL[dname],
              f"{name}: kernel disagrees with the plain version")
        errs[name] = max(e_out, e_lse)
        rel_errs[name] = e_rel
        del q, k, v, out, lse, ref_out, ref_lse, diff

    # Timings at the shape and layout the slice's prefill and loss give
    # the kernel.
    b, h, s, d = BATCH, HEADS, SEQ, DIM // HEADS
    q, k, v = qkv_views(g, dev, b, h, s, d, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel():
        attention.flash_attention(q, k, v, causal=True)

    def plain():
        attention.mha_reference(q, k, v, causal=True)

    def library():
        sdpa(q, k, v, is_causal=True)

    with torch.no_grad():
        # in turns: kernel, plain, library, library, plain, kernel
        t = {"kernel": [], "plain": [], "library": []}
        for order in (("kernel", "plain", "library"),
                      ("library", "plain", "kernel")):
            for which in order:
                fn, iters = {"kernel": (kernel, 20), "plain": (plain, 4),
                             "library": (library, 20)}[which]
                t[which].append(time_ms(fn, iters))
    flops, nbytes = attention_work(b, h, s, s, d, 2, True, 0, 0)
    bound, bound_by = bound_of(flops, nbytes)
    ms = {k2: sum(v2) / len(v2) for k2, v2 in t.items()}
    print(f"kernel flash_fwd timing at (B,H,S,D)=({b},{h},{s},{d}) bf16 "
          f"causal: kernel_ms={ms['kernel']:.4f} plain_ms={ms['plain']:.4f}"
          f" library_ms(sdpa)={ms['library']:.4f} bound_ms={bound:.4f} "
          f"({bound_by}: {flops:.4e} FLOP, {nbytes:.4e} B) "
          f"rounds={json.dumps(t)} achieved_TFLOPs="
          f"{flops / ms['kernel'] / 1e9:.1f}", flush=True)
    return {"errs": errs, "rel_errs": rel_errs, "ms": ms, "bound_ms": bound,
            "bound_by": bound_by}


def row_errors(got, want, dead):
    """(max abs error, largest error of a row (L2 over the head dim)
    relative to the plain version's row, rows no live score pair reaches
    (``dead``, (..., S) bool) that the kernel leaves not exactly 0). A row
    smaller than a thousandth of the largest row is held relative to that
    thousandth instead: such a row is the difference of two rounded sums
    (the first query's dq is p (dp - c) k with dp = c up to rounding)."""
    got, want = got.float(), want.float()
    norm = want.norm(dim=-1)
    floor = 1e-3 * float(norm.max()) if norm.numel() else 0.0
    live = ~dead
    err = (got - want).norm(dim=-1)
    rel = (err[live] / norm[live].clamp_min(max(floor, 1e-30))).max() \
        if live.any() else torch.zeros(())
    return (float((got - want).abs().max()), float(rel),
            int((got[dead] != 0).any(dim=-1).sum()))


def dead_keys(b, h, sq, sk, causal, q_offset, kv_offset, dev):
    """(B, H, Sk) bool: keys no query sees (causal, kv_offset + j beyond
    the last query q_offset + sq - 1)."""
    kpos = kv_offset + torch.arange(sk, device=dev)
    dead = kpos > q_offset + sq - 1 if causal else torch.zeros_like(
        kpos, dtype=torch.bool)
    return dead.expand(b, h, sk)


def phase_bwd_kernels(dev):
    """dq and dk/dv kernels vs their plain versions on the card, over the
    forward's cases (several with an lse cotangent); timings at the LM
    shape against the backward of one SDPA call."""
    g = torch.Generator(device=dev).manual_seed(4321)
    errs = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    rel_errs = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for name, (b, h, sq, sk, d), dt, causal, qo, ko in CASES:
        q, k, v = case_inputs(g, dev, name, (b, h, sq, sk, d), dt)
        # do as autograd hands it over: the gradient of a (B, H, S, D)
        # view of a (B, S, H, D) buffer
        do = torch.randn((b, sq, h, d), generator=g, device=dev).to(dt) \
            .transpose(1, 2)
        dlse = torch.randn((b, h, sq), generator=g, device=dev) \
            if name in DLSE_CASES else None
        kw = dict(causal=causal, q_offset=qo, kv_offset=ko, scale=d ** -0.5)
        with torch.no_grad():
            out, lse = attention.flash_attention(
                q, k, v, causal=causal, q_offset=qo, kv_offset=ko)
            c = attention.flash_bwd_prep(do, out, dlse)
            got = {"dq": attention._flash_bwd_dq_cuda(q, k, v, do, lse, c,
                                                      **kw)}
            got["dk"], got["dv"] = attention._flash_bwd_dkv_cuda(
                q, k, v, do, lse, c, **kw)
            again = {"dq": attention._flash_bwd_dq_cuda(q, k, v, do, lse, c,
                                                        **kw)}
            again["dk"], again["dv"] = attention._flash_bwd_dkv_cuda(
                q, k, v, do, lse, c, **kw)
            torch.cuda.synchronize()
            want = {"dq": attention.flash_bwd_dq_reference(q, k, v, do, lse,
                                                           c, **kw)}
            want["dk"], want["dv"] = attention.flash_bwd_dkv_reference(
                q, k, v, do, lse, c, **kw)
        dname = str(dt).split(".")[-1]
        tol = ROW_REL_TOL[dname]
        dead = {"dq": ~torch.isfinite(lse),
                "dk": dead_keys(b, h, sq, sk, causal, qo, ko, dev)}
        dead["dv"] = dead["dk"]
        line = []
        for which, kern in (("dq", "flash_bwd_dq"), ("dk", "flash_bwd_dkv"),
                            ("dv", "flash_bwd_dkv")):
            t = got[which]
            check(t.shape == want[which].shape and t.dtype == dt and
                  not torch.isnan(t).any(), f"{name}: {which} shape/NaN")
            e_abs, e_rel, nonzero_dead = row_errors(t, want[which],
                                                    dead[which])
            line.append(f"{which} max_abs_err={e_abs:.3e} "
                        f"max_row_rel_err={e_rel:.3e}")
            check(nonzero_dead == 0,
                  f"{name}: {nonzero_dead} {which} rows that no live pair "
                  f"reaches are not 0")
            check(e_rel <= tol, f"{name}: {which} disagrees with the plain "
                  f"version ({e_rel:.3e} > {tol})")
            errs[kern][name] = max(errs[kern].get(name, 0.0), e_abs)
            rel_errs[kern][name] = max(rel_errs[kern].get(name, 0.0), e_rel)
        # no atomics: a second launch on the same inputs gives the same bits
        for kern, which in (("dq", ("dq",)), ("dk/dv", ("dk", "dv"))):
            same = all(torch.equal(again[x], got[x]) for x in which)
            check(same, f"{name}: {kern} differs between two launches")
            line.append(f"{kern} bit-identical over two launches {same}")
        dead_q, dead_k = int(dead["dq"].sum()), int(dead["dk"].sum())
        print(f"kernel flash_bwd {name}: b,h,sq,sk,d={b},{h},{sq},{sk},{d} "
              f"{dname} causal={causal} q_offset={qo} kv_offset={ko} "
              f"dlse={'yes' if dlse is not None else 'no'} masked_rows="
              f"{dead_q} dead_keys={dead_k} {'; '.join(line)} (tol per "
              f"row {tol})", flush=True)
        del q, k, v, do, out, lse, c, got, want, again

    # Timings at the LM shape, on the main path's layout.
    b, h, s, d = BATCH, HEADS, SEQ, DIM // HEADS
    dim = h * d
    base = torch.randn((b, s, 3 * dim), generator=g, device=dev) \
        .to(torch.bfloat16).requires_grad_()
    ql, kl, vl = (t.reshape(b, s, h, d).transpose(1, 2)
                  for t in base.split(dim, dim=-1))
    q, k, v = (t.detach() for t in (ql, kl, vl))
    do = torch.randn((b, s, h, d), generator=g, device=dev) \
        .to(torch.bfloat16).transpose(1, 2)
    kw = dict(causal=True, q_offset=0, kv_offset=0, scale=d ** -0.5)
    with torch.no_grad():
        out, lse = attention.flash_attention(q, k, v, causal=True)
        c = attention.flash_bwd_prep(do, out)
    # The library yardstick: the backward of one SDPA call (dq, dk and dv
    # together), its forward done before the timed span.
    sd_out = torch.nn.functional.scaled_dot_product_attention(
        ql, kl, vl, is_causal=True)
    fns = {
        "dq": (lambda: attention._flash_bwd_dq_cuda(q, k, v, do, lse, c,
                                                    **kw), 20),
        "dkv": (lambda: attention._flash_bwd_dkv_cuda(q, k, v, do, lse, c,
                                                      **kw), 20),
        "dq_plain": (lambda: attention.flash_bwd_dq_reference(
            q, k, v, do, lse, c, **kw), 3),
        "dkv_plain": (lambda: attention.flash_bwd_dkv_reference(
            q, k, v, do, lse, c, **kw), 3),
        "sdpa_backward": (lambda: torch.autograd.grad(
            sd_out, (ql, kl, vl), do, retain_graph=True), 20),
    }
    t = {n: [] for n in fns}
    # in turns: kernels, plain, library, then the reverse
    for order in (list(fns), list(fns)[::-1]):
        for n in order:
            fn, iters = fns[n]
            if n == "sdpa_backward":
                t[n].append(time_ms(fn, iters))
            else:
                with torch.no_grad():
                    t[n].append(time_ms(fn, iters))
    ms = {n: sum(x) / len(x) for n, x in t.items()}
    res = {"errs": errs, "rel_errs": rel_errs, "rounds": t, "ms": ms}
    for kern, kind in (("flash_bwd_dq", "dq"), ("flash_bwd_dkv", "dkv")):
        flops, nbytes = attention_work(b, h, s, s, d, 2, True, 0, 0, kind)
        bound, bound_by = bound_of(flops, nbytes)
        res[kern] = {"ms": ms[kind], "plain_ms": ms[kind + "_plain"],
                     "bound_ms": bound, "bound_by": bound_by}
        print(f"kernel {kern} timing at (B,H,S,D)=({b},{h},{s},{d}) bf16 "
              f"causal: kernel_ms={ms[kind]:.4f} plain_ms="
              f"{ms[kind + '_plain']:.4f} bound_ms={bound:.4f} "
              f"({bound_by}: {flops:.4e} FLOP, {nbytes:.4e} B) "
              f"achieved_TFLOPs={flops / ms[kind] / 1e9:.1f}", flush=True)
    print(f"kernel flash_bwd timing: dq + dkv = "
          f"{ms['dq'] + ms['dkv']:.4f} ms against library_ms(sdpa "
          f"backward, dq dk dv in one call)={ms['sdpa_backward']:.4f}; "
          f"rounds={json.dumps(t)}", flush=True)
    return res


COUNTERS = ("flash_fwd_launches", "flash_bwd_dq_launches",
            "flash_bwd_dkv_launches")


def launch_counts():
    return {n[:-len("_launches")]: getattr(attention, n) for n in COUNTERS}


def zero_launch_counts():
    for n in COUNTERS:
        setattr(attention, n, 0)


def small_reference_check(dev, seed):
    """A small model on the card (kernels) against the same model on the
    CPU (plain versions): f32 logits atol 1e-4, f32 loss atol 1e-5,
    greedy tokens equal after a 60-token prompt (padded to 64 for the
    kernel, one launch per layer); bf16 loss atol 2e-2. Then, in f32,
    every parameter's gradient through the fused cross-entropy head to
    1e-4 of that gradient's largest magnitude on the CPU (the card sums
    in other orders), one dq and one dk/dv launch per layer, and the
    parameters after one Adam step (lr 1e-3) at rtol 5e-3, atol 5e-4
    (Adam divides by sqrt(nu), which amplifies summation-order noise in
    near-zero gradients, as ``tests/test_decode.py:134`` holds it)."""
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        gpu = ttr.TransformerLM(vocab=512, dim=256, heads=4, layers=2,
                                compute_dtype=dt, device=dev)
        gpu.init_weights(torch.Generator(device=dev).manual_seed(seed))
        cpu = ttr.TransformerLM(vocab=512, dim=256, heads=4, layers=2,
                                compute_dtype=dt, device="cpu")
        cpu.load_state_dict(gpu.state_dict())
        rng = np.random.default_rng(seed)
        tok = torch.from_numpy(rng.integers(0, 512, (2, 128),
                                            dtype=np.int32))
        tgt = torch.from_numpy(rng.integers(0, 512, (2, 128),
                                            dtype=np.int32))
        pos = torch.arange(128, dtype=torch.int32).expand(2, 128)
        args_cpu = (tok, tgt, pos)
        args_gpu = tuple(a.to(dev) for a in args_cpu)
        with torch.no_grad():
            l_gpu = float(ttr.lm_loss(gpu, *args_gpu))
            l_cpu = float(ttr.lm_loss(cpu, *args_cpu))
        msg = (f"small {str(dt).split('.')[-1]} model, card vs CPU: loss "
               f"{l_gpu:.6f} vs {l_cpu:.6f}")
        if dt == torch.float32:
            with torch.no_grad():
                lg_gpu = gpu(args_gpu[0], args_gpu[2]).cpu()
                lg_cpu = cpu(tok, pos)
            e = float((lg_gpu - lg_cpu).abs().max())
            before = attention.flash_fwd_launches
            g_gpu = tdec.generate(gpu, args_gpu[0][:, :60], 8).cpu()
            n = attention.flash_fwd_launches - before
            g_cpu = tdec.generate(cpu, tok[:, :60], 8)
            msg += f", logits max_abs_err {e:.3e}, greedy tokens equal " \
                   f"{bool(torch.equal(g_gpu, g_cpu))}, prefill of 60 " \
                   f"tokens launched flash_fwd {n} times"
            check(e <= 1e-4, msg)
            check(torch.equal(g_gpu, g_cpu), msg)
            check(n == gpu.layers, msg)
            msg += "; " + small_train_check(gpu, cpu, args_gpu, args_cpu)
        print(msg, flush=True)
        check(math.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= tol, msg)


def small_train_check(gpu, cpu, args_gpu, args_cpu):
    """Gradients and one Adam step, card against CPU (see
    :func:`small_reference_check`); returns the line it prints."""
    before = launch_counts()
    ttr.lm_loss(gpu, *args_gpu, fused_xent=True).backward()
    torch.cuda.synchronize()
    n = {k: v - before[k] for k, v in launch_counts().items()}
    ttr.lm_loss(cpu, *args_cpu, fused_xent=True).backward()
    worst, worst_name = 0.0, ""
    for (name, pg), pc in zip(gpu.named_parameters(), cpu.parameters()):
        err = float((pg.grad.cpu() - pc.grad).abs().max()) / \
            max(float(pc.grad.abs().max()), 1e-30)
        if err > worst:
            worst, worst_name = err, name
    msg = (f"gradients of {sum(1 for _ in gpu.parameters())} parameters: "
           f"largest error {worst:.3e} of the gradient's scale "
           f"({worst_name}); backward launches {n}")
    check(worst <= 1e-4, msg)
    check(n == {"flash_fwd": gpu.layers, "flash_bwd_dq": gpu.layers,
                "flash_bwd_dkv": gpu.layers}, msg)
    losses = []
    for model, args in ((gpu, args_gpu), (cpu, args_cpu)):
        _, opt = ttr.create_train_state(model, lr=TRAIN_LR)
        losses.append(float(ttr.make_train_step(model, opt,
                                                fused_xent=True)(*args)))
    worst = 0.0
    for pg, pc in zip(gpu.parameters(), cpu.parameters()):
        excess = (pg.detach().cpu() - pc.detach()).abs() - \
            5e-3 * pc.detach().abs()
        worst = max(worst, float(excess.max()))
    msg += (f"; one Adam step: loss {losses[0]:.6f} vs {losses[1]:.6f}, "
            f"parameters' largest |card - CPU| - 5e-3 |CPU| = {worst:.3e} "
            f"(tol 5e-4)")
    check(abs(losses[0] - losses[1]) <= 1e-5 and worst <= 5e-4, msg)
    return msg


def make_store(seed):
    """The slices' data: 4096 windows of 2048 tokens and their next-token
    targets in the store, from a repeated-pattern corpus built as
    ``examples/lm_longcontext.py:133-143`` builds it."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    base = rng.integers(0, VOCAB, size=64)
    corpus = np.tile(base, WINDOWS * SEQ // 64 + 2)
    starts = rng.integers(0, len(corpus) - SEQ - 1, size=WINDOWS)
    at = starts[:, None] + np.arange(SEQ)
    windows = corpus[at].astype(np.int32)
    nexts = corpus[at + 1].astype(np.int32)
    store = DDStore()
    ds = ShardedDataset(store, windows, nexts)
    data_mib = sum(store.row_nbytes(v) * store.total_rows(v)
                   for v in store.variables()) / 2**20
    print(f"store: {data_mib:.1f} MiB in {len(store.variables())} "
          f"variables, {time.perf_counter() - t0:.2f} s", flush=True)
    return store, ds


def full_width_model(dev, seed):
    model = ttr.TransformerLM(vocab=VOCAB, dim=DIM, heads=HEADS,
                              layers=LAYERS, compute_dtype=torch.bfloat16,
                              device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    print(f"model: {sum(p.numel() for p in model.parameters()) / 1e6:.1f} "
          f"M params", flush=True)
    return model


def phase_slice(dev, seed, ds):
    """The serving slice (phase 5)."""
    loader = DeviceLoader(ds, DistributedSampler(WINDOWS, 1, 0, seed=seed),
                          BATCH, device=dev)
    model = full_width_model(dev, seed)
    positions = torch.arange(SEQ, dtype=torch.int32,
                             device=dev).expand(BATCH, SEQ)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()  # count the main path alone
    t_start = time.perf_counter()
    batches = iter(loader)
    losses, loss_s = [], []
    for _ in range(LOSS_BATCHES):
        tok, tgt = next(batches)
        check(tok.device == torch.device(dev) and
              tok.shape == (BATCH, SEQ), "loader batch")
        t1 = time.perf_counter()
        with torch.no_grad():
            loss = float(ttr.lm_loss(model, tok, tgt, positions))  # syncs
        loss_s.append(time.perf_counter() - t1)
        losses.append(loss)
    prompts = next(batches)[0]
    batches.close()
    stats = {}
    out = tdec.generate(model, prompts, NEW_TOKENS, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    want = {"flash_fwd": LAYERS * (LOSS_BATCHES + 1), "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    print(f"slice: eval losses {losses} (s each: {loss_s}); generate "
          f"out {tuple(out.shape)}; prefill {stats['prefill_s']:.4f} s = "
          f"{BATCH * SEQ / stats['prefill_s']:.1f} tokens/s (one sample, "
          f"cache allocation included); decode "
          f"{stats['decode_s'] / stats['decode_steps'] * 1e3:.3f} ms per "
          f"step ({BATCH} sequences, one token each, "
          f"{stats['decode_steps']} steps); input_pipeline_efficiency "
          f"{loader.metrics.efficiency:.4f}; loader "
          f"{json.dumps(loader.metrics.summary())}; peak memory "
          f"{peak_gib:.3f} GiB; wall {wall:.3f} s; launches {launches} "
          f"(want {want})", flush=True)
    check(all(math.isfinite(x) and 0 < x < 30 for x in losses),
          f"eval losses not finite/plausible: {losses}")
    check(out.shape == (BATCH, SEQ + NEW_TOKENS), "generate shape")
    check(bool(torch.equal(out[:, :SEQ], prompts)),
          "generate changed the prompt")
    check(bool(((out >= 0) & (out < VOCAB)).all()),
          "generated tokens out of range")
    check(launches == want, f"serving launches {launches} != {want}")
    time_prefill(model, prompts, positions, stats["prefill_s"])
    profile_breakdown(model, prompts, positions)
    return {"launches": launches}


def time_prefill(model, prompts, positions, one_shot_s, repeats=5):
    """The prefill forward (8 prompts of 2048, K/V into the cache) over
    ``repeats`` runs, with the cache made outside the timed span; printed
    beside ``generate``'s one-shot figure, which includes allocating the
    cache."""
    cache = tdec.init_cache(model, BATCH, SEQ + NEW_TOKENS)
    times = []
    with torch.no_grad():
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, kvs = model(prompts, positions, return_features=True,
                           return_kv=True)
            for i, (k, v) in enumerate(kvs):
                cache["k"][i, :, :, :SEQ] = k
                cache["v"][i, :, :, :SEQ] = v
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    print(f"prefill: median {med * 1e3:.3f} ms over {repeats} repeats = "
          f"{BATCH * SEQ / med:.1f} tokens/s (ms each: "
          f"{[round(x * 1e3, 3) for x in times]}); generate's one-shot "
          f"prefill {one_shot_s * 1e3:.3f} ms", flush=True)


def device_profile(name, fn):
    """Run ``fn`` once under torch.profiler (after one warm call) and
    print the busy share of the window (self device time of all kernels
    over the window's host wall time) and its largest kernels."""
    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    top = "; ".join(f"{k[:60]} {ms:.3f} ms x{n}" for k, ms, n in rows[:10])
    print(f"profile {name}: host wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / wall_ms:.1%}); top kernels: "
          f"{top or 'no device time captured'}", flush=True)


def profile_breakdown(model, prompts, positions):
    """Where the device time goes, after the counted serving run: one
    prefill forward and 4 decode steps."""
    def prefill():
        with torch.no_grad():
            model(prompts, positions, return_features=True, return_kv=True)

    cache = tdec.init_cache(model, BATCH, SEQ + 4)

    def decode():
        for s in range(SEQ, SEQ + 4):
            tdec.decode_step(model, cache, s, prompts[:, -1:])

    device_profile("prefill", prefill)
    device_profile("decode x4", decode)


def lm_flops_per_step(vocab, dim, layers, b, s):
    """Model FLOPs of one train step, counted as ``bench.py:3004`` counts
    them: the matmuls (qkv 6Td^2, proj 2Td^2, MLP 16Td^2 a layer, head
    2TdV) and causal attention (2bs^2d a layer), backward = 2x forward."""
    t = b * s
    fwd = layers * (24 * t * dim * dim + 2 * b * s * s * dim) \
        + 2 * t * dim * vocab
    return 3 * fwd


def phase_train(dev, seed, ds):
    """The training slice (phase 6)."""
    loader = DeviceLoader(ds, DistributedSampler(WINDOWS, 1, 0,
                                                 seed=seed + 1),
                          BATCH, device=dev)
    model = full_width_model(dev, seed + 1)
    state, opt = ttr.create_train_state(model, lr=TRAIN_LR)
    step = ttr.make_train_step(model, opt, state=state)
    step_accum = ttr.make_train_step(model, opt, accum_steps=2, state=state)
    positions = torch.arange(SEQ, dtype=torch.int32,
                             device=dev).expand(BATCH, SEQ)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()  # count the main path alone
    t_start = time.perf_counter()
    batches = iter(loader)
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        tok, tgt = next(batches)
        t1 = time.perf_counter()
        losses.append(float(step(tok, tgt, positions)))  # syncs
        step_s.append(time.perf_counter() - t1)
    tok, tgt = next(batches)
    t1 = time.perf_counter()
    loss_accum = float(step_accum(tok, tgt, positions))
    accum_s = time.perf_counter() - t1
    batches.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    per = LAYERS * (TRAIN_STEPS + 2)
    want = {"flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per}
    med = float(np.median(step_s[WARMUP_STEPS:]))
    flops = lm_flops_per_step(VOCAB, DIM, LAYERS, BATCH, SEQ)
    print(f"train: {TRAIN_STEPS} steps of ({BATCH}, {SEQ}) at lr "
          f"{TRAIN_LR}, losses {losses}; accum_steps=2 step loss "
          f"{loss_accum} ({accum_s * 1e3:.3f} ms); step ms "
          f"{[round(x * 1e3, 3) for x in step_s]}; median after "
          f"{WARMUP_STEPS} warm-up steps {med * 1e3:.3f} ms = "
          f"{BATCH * SEQ / med:.1f} tokens/s; model FLOPs {flops:.4e} a "
          f"step, utilisation {flops / med / PEAK_BF16_FLOPS:.4f} of "
          f"{PEAK_BF16_FLOPS:.3e}; input_pipeline_efficiency "
          f"{loader.metrics.efficiency:.4f}; loader "
          f"{json.dumps(loader.metrics.summary())}; peak memory "
          f"{peak_gib:.3f} GiB; wall {wall:.3f} s; launches {launches} "
          f"(want {want})", flush=True)
    check(all(math.isfinite(x) for x in losses + [loss_accum]),
          f"train losses not finite: {losses}, {loss_accum}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(state.step == TRAIN_STEPS + 1, f"state.step {state.step}")
    check(launches == want, f"train launches {launches} != {want}")

    time_head(dev, model, tgt, med)
    device_profile("train step", lambda: float(step(tok, tgt, positions)))
    return {"launches": launches}


def time_head(dev, model, targets, step_s):
    """The fused cross-entropy head alone at the train step's shape:
    forward and backward of ``fused_linear_xent`` on (8 x 2048, 1024)
    bf16 features and the f32 head, its products in f32 on bf16-rounded
    operands as the reference's preferred_element_type=f32 (4 products of
    2 x 16384 x 1024 x 32768 FLOP: the forward, the backward's recompute,
    dx and dw)."""
    g = torch.Generator(device=dev).manual_seed(7)
    feats = torch.randn((BATCH * SEQ, DIM), generator=g, device=dev) \
        .to(torch.bfloat16).requires_grad_()
    w = model.lmhead.head.weight.t()
    tgt = targets.reshape(-1)

    def head():
        nll = fused_linear_xent(feats, w, tgt, 8192, torch.bfloat16)
        torch.autograd.grad(nll.mean(), (feats, w))

    ms = time_ms(head, 3, warmup=1)
    flops = 4 * 2.0 * BATCH * SEQ * DIM * VOCAB
    print(f"train head: fused cross-entropy forward + backward "
          f"{ms:.3f} ms = {ms / (step_s * 1e3):.1%} of the median step, "
          f"{flops:.4e} FLOP in f32 products = "
          f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)


def kernel_table(kern, bwd, sl, tr):
    """The kernels' JSON line: launches are the training path's (this
    slice's), with each path's counts beside them."""
    by_path = {k: {"serving": sl["launches"][k], "training": v}
               for k, v in tr["launches"].items()}
    ms = kern["ms"]
    rows = [{
        "name": "flash_fwd",
        "route": "cuda",
        "design": "wgmma+tma",
        "source": "ddstore_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ddstore_tpu/ops/attention.py:92",
        "replaces_function": "_flash_kernel",
        "launches": tr["launches"]["flash_fwd"],
        "launches_by_path": by_path["flash_fwd"],
        "max_abs_err": max(kern["errs"].values()),
        "lm_shape_max_abs_err": kern["errs"]["lm_causal"],
        "max_row_rel_err": max(kern["rel_errs"].values()),
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": ms["library"],
    }]
    for name, line, fn, design in (
            ("flash_bwd_dq", 213, "_bwd_dq_kernel", "wgmma+tma"),
            ("flash_bwd_dkv", 263, "_bwd_dkv_kernel", "wgmma+tma")):
        rows.append({
            "name": name,
            "route": "cuda",
            "design": design,
            "source": "ddstore_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"ddstore_tpu/ops/attention.py:{line}",
            "replaces_function": fn,
            "launches": tr["launches"][name],
            "launches_by_path": by_path[name],
            "max_abs_err": max(bwd["errs"][name].values()),
            "lm_shape_max_abs_err": bwd["errs"][name]["lm_causal"],
            "max_row_rel_err": max(bwd["rel_errs"][name].values()),
            **bwd[name],
            # no single PyTorch call computes dq (or dk, dv) alone; the
            # backward of one SDPA call gives all three: sdpa_backward_ms
            "library_ms": None,
        })
    return {"kernels": rows, "sdpa_backward_ms": bwd["ms"]["sdpa_backward"],
            "flash_bwd_dq_plus_dkv_ms": bwd["ms"]["dq"] + bwd["ms"]["dkv"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. device
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build
    build_s = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
        # per kernel: its entry, registers, spills, and any wgmma that
        # ptxas had to serialize
        regs = [ln.strip() for ln in _build.build_logs.get(name, "")
                .splitlines() if any(w in ln for w in (
                    "entry function", "registers", "spill", "wgmma"))]
        print(f"build {name}: {regs}", flush=True)
        spills = [ln for ln in regs if "spill" in ln and
                  "0 bytes spill stores, 0 bytes spill loads" not in ln]
        check(not spills, f"build {name}: register spills {spills}")
    print(f"build: {len(_build.SOURCES)} kernel(s) in {build_s:.2f} s",
          flush=True)

    # 3. kernels against their plain versions
    kern = phase_kernels(dev)
    bwd = phase_bwd_kernels(dev)

    # 4.-6. the small reference check, then the slices on the store
    small_reference_check(dev, args.seed)
    store, ds = make_store(args.seed)
    sl = phase_slice(dev, args.seed, ds)
    tr = phase_train(dev, args.seed, ds)
    store.close()

    print(json.dumps(kernel_table(kern, bwd, sl, tr)), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
