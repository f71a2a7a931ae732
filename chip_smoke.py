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
   report must show no register spills. Beside them, the store's native
   core (one ``g++`` per translation unit, all started together);
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
   runs under torch.profiler;
7. VAE DDP slice (``examples/vae_mnist.py`` at its defaults): a VAE step
   on the card against the same step on the CPU; then 2 rank processes
   (``spawn``), both on the one card, form a ``TorchGroup`` over gloo and
   a ``DDStore(backend="tcp")`` over it, register the two halves of
   ``synthetic_mnist(60000)`` (uint8, 47 MB), and train the VAE under
   ``DistributedDataParallel`` for one epoch at a global batch of 128 (468
   steps of 64 a rank) with an eval pass after it; the gradient
   all-reduce goes over gloo (NCCL refuses two ranks on one device).
   Checked: finite losses whose last 20 average below the first 20, both
   ranks' parameters bit-identical (a checksum gathered through the
   group), about half the rows read from the other rank, one staged
   batch equal to ``data[idx] / 255``, no attention kernel launched.
   After the counted epoch, both ranks read the same epoch through the
   host path again, untimed, for a digest of its batches, then train it
   through epoch-window readahead (2 windows of 8 batches): every staged
   batch's bytes must equal the host path's (the digest, taken after the
   epoch's clock stops), nothing may fall back, and no async read may
   stay in flight, nor after a readahead epoch cancelled after 10
   batches. Then 20 more steps run
   under torch.profiler on rank 0. Then a third epoch, of a fresh VAE,
   through the device-collective fetch: both ranks draw the same global
   batches of 128 (``DistributedSampler(n, 1, 0)``), each reads only the
   rows it owns and one ``all_to_all_single`` over the gloo group (on
   CUDA tensors) delivers each rank its 64. Checked: no fallback, one
   exchange per batch, no byte over TCP, the ranks' local reads summing
   to the epoch's bytes, about half of each rank's rows sent to the
   other, losses falling, parameters bit-identical, no attention launch,
   and (untimed, after the epoch's clock stops) the digest of the
   batches equal to ``get_batch`` of the same slices. Last, a one-process
   NCCL group runs 5 DDP steps, which must equal the same steps without
   DDP;
8. GNN DDP slice (``examples/gnn_molecules.py``: the MPNN at hidden 64,
   3 layers, bf16 dense layers, 8 graphs a slot, Adam lr 3e-3): an MPNN
   step on the card against the same step on the CPU in f32; in bf16,
   steps on the card (its atomic scatter, as the main path) and on the
   CPU, each against the CPU's f32 step, the card's error held within
   a factor of the CPU's;
   then 2 rank processes on the one card, as in phase 7, each register
   half of 133,885 QM9-shaped synthetic graphs (QM9's molecule count) as
   ragged variables and train the MPNN under DistributedDataParallel for
   1,024 steps of one slot a rank, then an eval pass of 64 batches.
   Checked: finite losses whose last 100 average below the first 100,
   both ranks' parameters bit-identical, about half the graphs read from
   the other rank (``owner_of_rows``), the first staged ``GraphBatch``
   equal field by field to ``pack_graph_batch`` of the same graphs read
   one at a time, no attention kernel launched. Then 20 profiled steps on
   rank 0, the step's parts timed alone, and 5 DDP steps in a
   one-process NCCL group held to the same steps without DDP (with
   PyTorch's deterministic algorithms: the scatter's atomics otherwise
   sum in a varying order);
9. device-collective fetch and shuffles: in a one-process NCCL group
   over a world-1 store, 20 loader batches through the collective path
   (exchange on the card) byte-equal to ``get_batch``, and
   ``global_shuffle_epoch``/``permute_rows`` on the card; the A/B of
   ``device_fetch_batch`` against ``get_batch`` + the copy to the card
   at the reference bench's geometry (32,768 x 64 f32, batches of 2,048,
   16 batches; every batch equal before it is timed) in that group and
   over phase 7's two gloo ranks; ``device_fetch_ragged_batch`` of the
   GNN's nodes in phase 8's ranks against ``get_ragged_batch`` +
   ``pad_ragged``; and last, in phase 7's ranks, ``host_global_shuffle``
   of the VAE variable, whose shards must be the plain seeded
   permutation of the rows, their multiset unchanged. The two-rank
   checks run in phases 7 and 8's rank processes after their counted
   epochs, so no other process is spawned.

Then it prints the kernel table as one JSON line (each row names its
design: ``wgmma+tma``, the bf16 path of all three kernels), the card's
name and power limit, and as the last line ``{"ok": true, "device":
{...}}``.
Without a card, or outside a checkout, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import math
import multiprocessing as mp
import os
import queue
import socket
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from ddstore_tpu_torch import _build as native_build
from ddstore_tpu_torch.data.dataset import (DistributedSampler,
                                            ShardedDataset, nsplit)
from ddstore_tpu_torch.data.device_fetch import (device_fetch_batch,
                                                 device_fetch_ragged_batch,
                                                 exchange_device,
                                                 host_bytes_over_dcn,
                                                 plan_device_fetch)
from ddstore_tpu_torch.data.formats import synthetic_mnist
from ddstore_tpu_torch.data.graphs import (GraphBatch, GraphSample,
                                           GraphShardedDataset,
                                           pack_graph_batch,
                                           synthetic_graphs)
from ddstore_tpu_torch.data.loader import DeviceLoader
from ddstore_tpu_torch.data.permute import seeded_perm_slice
from ddstore_tpu_torch.data.ragged import pad_ragged
from ddstore_tpu_torch.models import decode as tdec
from ddstore_tpu_torch.models import gnn as tgnn
from ddstore_tpu_torch.models import transformer as ttr
from ddstore_tpu_torch.models import vae as tvae
from ddstore_tpu_torch.ops import _build, attention
from ddstore_tpu_torch.ops.xent import fused_linear_xent
from ddstore_tpu_torch.parallel import (global_shuffle_epoch,
                                        host_global_shuffle, permute_rows)
from ddstore_tpu_torch.rendezvous import TorchGroup
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
# The VAE slice: the MNIST train set's size, the global batch of
# examples/vae_mnist.py:38, two rank processes on the one card; a step on
# the card is held to the CPU step at tests/test_torch_vae.py's bf16
# tolerances (loss rtol, each gradient leaf relative to its largest).
VAE_SAMPLES, VAE_RANKS, VAE_BATCH = 60000, 2, 128
VAE_PROFILE_STEPS, VAE_NCCL_STEPS, VAE_TREND = 20, 5, 20
VAE_LOSS_RTOL, VAE_GRAD_TOL = 5e-3, 2e-2
# After the counted epoch, the same epoch through readahead.
VAE_RA_WINDOWS, VAE_RA_WINDOW_BATCHES = 2, 8
# The device-collective fetch: phase 7's third epoch (the global batch
# staged by its owners, one all_to_all_single delivering each rank its
# 64 rows), phase 9's 20 batches in a one-process NCCL group, and the A/B
# of device_fetch_batch against get_batch + the copy to the card at the
# reference bench's geometry (bench.py:616: 32,768 rows of 64 f32,
# batches of 2,048, 16 batches); the GNN's ragged nodes padded to 32.
COLL_NCCL_BATCHES = 20
AB_ROWS, AB_DIM, AB_BATCH, AB_BATCHES = 32768, 64, 2048, 16
RAGGED_MAX_LEN = 32
# The GNN slice: the repo's one GNN configuration (MPNN hidden 64, 3
# layers, bf16 dense layers; examples/gnn_molecules.py: 8 graphs a slot,
# Adam lr 3e-3) over QM9's 133,885 molecules as QM9-shaped synthetic
# graphs, split between two rank processes on the one card, one slot a
# rank. One step (Adam at lr 1e-3, as the tests) on the card is held to
# the CPU's f32 step from the same weights: the loss (relative), each
# gradient leaf (L2 error over the leaf's L2 norm) and the parameters
# after the step. In f32 directly, at the tests' loss and gradient
# tolerances and the step at lr / 10, because Adam's first update
# -lr g / (|g| + 1e-8) turns a gradient difference d into a weight
# difference of up to lr d / 1e-8 where |g| is near 1e-8 (3.1e-6 to
# 1.5e-5 over four runs on an H100 at 700 W). In bf16 the card and the
# CPU round differently, so both are held to the f32 step and the
# card's error, over GNN_BF16_RUNS steps with the main path's atomic
# scatter, to at most GNN_BF16_FACTOR times the CPU's: in the loss (or
# one bf16 rounding, 2**-8, if that is larger), the worst gradient
# leaf, and the share of weights that the step moves the other way
# from the f32 step's (Adam's first update is about +-lr wherever the
# gradient is not near 0, so the sign is what a step can get wrong).
GNN_GRAPHS, GNN_RANKS, GNN_G, GNN_LR = 133885, 2, 8, 3e-3
GNN_STEPS, GNN_EVAL_BATCHES, GNN_TREND = 1024, 64, 100
GNN_PROFILE_STEPS, GNN_NCCL_STEPS = 20, 5
GNN_F32_TOL = (1e-5, 1e-4, 1e-4)
GNN_BF16_RUNS, GNN_BF16_FACTOR = 8, 3.0

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
    print the busy share of the window and its largest kernels. Busy is
    the union of the device's kernel and copy intervals over the
    window's host wall time; the profiler's user annotations on the
    device track (``DistributedDataParallel.forward``, ``Optimizer.step``,
    ``gloo:all_reduce``: ranges that span kernels and the gaps between
    them) are left out, as is any device event named like a host one."""
    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    host = {e.name for e in events if e.device_type != cuda}
    work = [e for e in events if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and e.name not in host]
    by_name = {}
    for e in work:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy, end = 0.0, None  # the union of the intervals
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in work):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy /= 1e3
    rows = sorted(by_name.items(), key=lambda r: -r[1][0])
    top = "; ".join(f"{k[:60]} {ms:.3f} ms x{n}"
                    for k, (ms, n) in rows[:10])
    print(f"profile {name}: host wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / wall_ms:.1%}; kernels and copies sum "
          f"{sum(ms for ms, _ in by_name.values()):.3f} ms); top: "
          f"{top or 'no device time captured'}", flush=True)
    return wall_ms, busy


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


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def param_digest(model) -> str:
    return hashlib.sha256(b"".join(
        p.detach().cpu().numpy().tobytes()
        for p in model.parameters())).hexdigest()


def vae_card_vs_cpu(dev, seed):
    """One VAE step (loss and gradients, bf16 hidden layers) on the card
    against the same step on the CPU: same weights, batch and eps."""
    cpu = tvae.VAE(device="cpu").init_weights(
        torch.Generator().manual_seed(seed))
    card = tvae.VAE(device=dev)
    card.load_state_dict(cpu.state_dict())
    per_rank = VAE_BATCH // VAE_RANKS
    raw = torch.from_numpy(synthetic_mnist(per_rank, seed)[0])
    eps = torch.randn((per_rank, tvae.LATENT),
                      generator=torch.Generator().manual_seed(seed + 1))
    res = []
    for model, d in ((cpu, torch.device("cpu")), (card, dev)):
        x = tvae._dequantize(raw.to(d))
        logits, mu, logvar = model(x, eps=eps.to(d))
        loss = tvae.loss_fn(logits, x, mu, logvar)
        loss.backward()
        res.append((loss.item(), {n: p.grad.cpu() for n, p in
                                  model.named_parameters()}))
    (lc, gc), (lg, gg) = res
    worst = max(float((gg[n] - gc[n]).abs().max() / gc[n].abs().max())
                for n in gc)
    msg = (f"vae card vs cpu: loss {lg} vs {lc} (relative "
           f"{abs(lg - lc) / abs(lc):.3e}, tol {VAE_LOSS_RTOL}); worst "
           f"gradient leaf error {worst:.3e} of its largest (tol "
           f"{VAE_GRAD_TOL})")
    print(msg, flush=True)
    check(abs(lg - lc) <= VAE_LOSS_RTOL * abs(lc) and worst <= VAE_GRAD_TOL,
          msg)


def store_rank(phase, rank, world, port, seed, q):
    """One rank of a multi-process phase (``phase``: "vae" or "gnn"), in a
    spawned process; its result (or its traceback) goes to ``q``."""
    try:
        q.put((rank, True, _store_rank(phase, rank, world, port, seed)))
    except Exception:  # noqa: BLE001 — the parent fails the run
        q.put((rank, False, traceback.format_exc()))


def _store_rank(phase, rank, world, port, seed):
    torch.cuda.set_device(0)  # the ranks share the card; before any use
    os.environ["DDSTORE_HOST"] = "127.0.0.1"
    os.environ["DDSTORE_CMA"] = "0"  # the other rank's rows come over TCP
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    group = TorchGroup()
    store = DDStore(group, backend="tcp")
    try:
        train = {"vae": _vae_train, "gnn": _gnn_train}[phase]
        out = train(rank, group, store, torch.device("cuda", 0), seed)
        out["transport"] = store.transport_facts()
        out["cma_ops"] = store.cma_ops
        return out
    finally:
        store.close()
        dist.destroy_process_group()


def _vae_train(rank, group, store, dev, seed):
    t0 = time.perf_counter()
    data = synthetic_mnist(VAE_SAMPLES, seed)[0]
    ds = ShardedDataset(store, data)
    setup_s = time.perf_counter() - t0
    per_rank = VAE_BATCH // VAE_RANKS
    model = tvae.VAE(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    _, opt = tvae.create_train_state(model)
    step = tvae.make_train_step(model, opt, group=dist.group.WORLD)
    sampler = DistributedSampler(len(ds), VAE_RANKS, rank, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1 + rank)
    loader = DeviceLoader(ds, sampler, per_rank, device=dev)
    first = sampler.epoch_indices()[:per_rank]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()  # count the main path alone
    losses, step_s = [], []
    t_start = time.perf_counter()
    for i, xb in enumerate(loader):
        if i == 0:
            want = torch.from_numpy(data[first]).to(dev).float() / 255.0
            check(bool(torch.equal(tvae._dequantize(xb), want)),
                  "staged batch != data[idx] / 255")
        t1 = time.perf_counter()
        losses.append(float(step(xb, generator=gen)))  # syncs
        step_s.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts()
    summary = loader.metrics.summary()
    peak = torch.cuda.max_memory_allocated(dev)

    ev = tvae.make_eval_step(model, group=dist.group.WORLD)
    t1 = time.perf_counter()
    ev_loss = sum(float(ev(xb, generator=gen)) for xb in DeviceLoader(
        ds, DistributedSampler(len(ds), VAE_RANKS, rank, shuffle=False),
        per_rank, device=dev))
    eval_s = time.perf_counter() - t1

    # the counted epoch's batches again, untimed: what readahead must stage
    host_digest = batches_digest(DeviceLoader(ds, sampler, per_rank,
                                              device=dev))
    readahead = vae_readahead_epochs(store, ds, sampler, step, gen, dev,
                                     host_digest)

    # more steps, under the profiler on rank 0 (every rank runs the same
    # number: each one is a collective)
    sampler.set_epoch(1)
    batches = iter(DeviceLoader(ds, sampler, per_rank, device=dev))

    def steps():
        for _ in range(VAE_PROFILE_STEPS):
            float(step(next(batches), generator=gen))

    if rank == 0:
        prof = device_profile(f"vae ddp {VAE_PROFILE_STEPS} steps, rank 0",
                              steps)
    else:
        steps()
        steps()
        prof = None
    xb = next(batches)
    batches.close()
    local = tvae.VAE(device=dev)
    local.load_state_dict(model.state_dict())
    local_step = tvae.make_train_step(local,
                                      tvae.create_train_state(local)[1])
    out = {"breakdown": step_breakdown(
               model, lambda: local_step(xb, generator=gen), dev),
           "losses": losses, "step_s": step_s, "wall_s": wall,
           "setup_s": setup_s, "eval_loss": ev_loss, "eval_s": eval_s,
           "launches": launches, "summary": summary, "peak_bytes": peak,
           "readahead": readahead, "rows": len(step_s) * per_rank,
           "row_bytes": store.row_nbytes(ds.data_var), "profile": prof,
           "checksums": group.allgather(param_digest(model))}
    # after the counted epochs: the collective epoch, then phase 9's
    # checks that need two ranks (the shuffle last: it rewrites shards)
    out["collective"] = vae_collective_epoch(rank, group, ds, dev, seed)
    out["ab"] = fetch_ab(store, dev, seed)
    out["shuffle"] = shuffle_check(store, ds, data, group, seed)
    return out


def vae_collective_epoch(rank, group, ds, dev, seed):
    """Phase 7's third epoch: a fresh VAE trained under DDP for one epoch
    whose batches come through the device-collective fetch (every rank
    draws the same global batches of 128, reads the rows it owns, and one
    all_to_all_single over the gloo group delivers its 64). Launch counts
    zeroed just before, read just after; then, untimed, this rank's
    slices of the same global batches read with get_batch, for the
    digest of what the exchange must have delivered."""
    model = tvae.VAE(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    _, opt = tvae.create_train_state(model)
    step = tvae.make_train_step(model, opt, group=dist.group.WORLD)
    sampler = DistributedSampler(len(ds), 1, 0, seed=seed)  # global
    gen = torch.Generator(device=dev).manual_seed(seed + 1 + rank)
    loader = DeviceLoader(ds, sampler, VAE_BATCH, device=dev,
                          device_collective=True)
    check(loader._collective_ready,
          f"collective fetch unusable: {loader.collective_fallback_reason}")
    torch.cuda.synchronize()
    zero_launch_counts()
    staged, losses, step_s = [], [], []
    t0 = time.perf_counter()
    for xb in loader:
        t1 = time.perf_counter()
        losses.append(float(step(xb, generator=gen)))
        step_s.append(time.perf_counter() - t1)
        staged.append(xb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    summary = loader.metrics.summary()
    idx, per = sampler.epoch_indices(), VAE_BATCH // VAE_RANKS
    want = hashlib.sha256()
    for b in range(len(staged)):
        lo = b * VAE_BATCH + rank * per
        want.update(ds.fetch(idx[lo:lo + per]).tobytes())
    return {"losses": losses, "step_s": step_s, "wall_s": wall,
            "summary": summary, "launches": launches,
            "batches": len(staged),
            "digest_equal": batches_digest(staged) == want.hexdigest(),
            "fallback": loader.collective_fallback_reason,
            "checksums": group.allgather(param_digest(model))}


def fetch_ab(store, dev, seed):
    """device_fetch_batch against get_batch + the copy to the card (a
    pinned buffer, as the loader stages) at the reference bench's
    geometry, over the store's ranks (a collective: every rank runs the
    same batches in the same order). Every batch is checked equal first,
    then each path is timed per batch, host clock around work that ends
    in a synchronize."""
    rank, world = store.rank, store.world
    counts = nsplit(AB_ROWS, world)
    lo = sum(counts[:rank])
    full = np.random.default_rng(seed + 7).standard_normal(
        (AB_ROWS, AB_DIM), dtype=np.float32)
    store.add("ab", full[lo:lo + counts[rank]])
    rng = np.random.default_rng(seed + 8)
    batches = [rng.integers(0, AB_ROWS, AB_BATCH)
               for _ in range(AB_BATCHES)]
    per = AB_BATCH // world
    buf = torch.empty((per, AB_DIM), pin_memory=True)

    def host(idx):
        store.get_batch("ab", idx[rank * per:(rank + 1) * per],
                        out=buf.numpy())
        return buf.to(dev, non_blocking=True)

    def collective(idx):
        return device_fetch_batch(store, "ab", idx, device=dev)

    for idx in batches:
        check(torch.equal(host(idx), collective(idx)),
              "device_fetch_batch != get_batch of this rank's slice")
    times = {"host": [], "collective": []}
    for idx in batches:
        for name, fn in (("host", host), ("collective", collective),
                         ("collective", collective), ("host", host)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(idx)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    plans = [plan_device_fetch(store.row_starts("ab"), idx, world)
             for idx in batches]
    row_bytes = store.row_nbytes("ab")
    out = {"host_ms": float(np.median(times["host"])) * 1e3,
           "collective_ms": float(np.median(times["collective"])) * 1e3,
           "host_dcn_bytes": sum(host_bytes_over_dcn(
               store, "ab", idx[rank * per:(rank + 1) * per])
               for idx in batches) // AB_BATCHES,
           "ledger": {k: v // AB_BATCHES for k, v in _sum_ledgers(
               p.rank_ledger(row_bytes, rank) for p in plans).items()},
           "exchange_device": str(exchange_device(None, dev)),
           "world": world}
    store.free("ab")
    return out


def _sum_ledgers(ledgers):
    total = {}
    for led in ledgers:
        for k, v in led.items():
            total[k] = total.get(k, 0) + v
    return total


def _multiset(rows: np.ndarray) -> int:
    """An order-free digest of a set of uint8 rows: the wrapping sum of
    per-row polynomial hashes."""
    words = rows.reshape(len(rows), -1).view(np.uint64)
    mult = np.random.default_rng(12345).integers(
        1, 1 << 62, words.shape[1], dtype=np.uint64) | np.uint64(1)
    with np.errstate(over="ignore"):
        return int(((words * mult).sum(axis=1, dtype=np.uint64) ** 3).sum(
            dtype=np.uint64))


def shuffle_check(store, ds, data, group, seed):
    """host_global_shuffle of the VAE variable over the ranks: this
    rank's shard afterwards must be the plain permutation of the rows
    before it (``data`` by ``seeded_perm_slice``), and the multiset of
    all rows must not change."""
    var = ds.data_var
    total = store.total_rows(var)
    begin, end = store.my_row_range(var)
    t0 = time.perf_counter()
    host_global_shuffle(store, var, seed + 9)
    shuffle_s = time.perf_counter() - t0
    shard = store.get_batch(var, np.arange(begin, end))
    want = data[seeded_perm_slice(total, begin, end, seed + 9)]
    sums = group.allgather(_multiset(shard))
    return {"equal": bool(np.array_equal(shard, want)),
            "multiset_equal": sum(sums) % (1 << 64) == _multiset(data),
            "shuffle_s": shuffle_s, "rows": end - begin}


def batches_digest(batches) -> str:
    digest = hashlib.sha256()
    for xb in batches:
        digest.update(xb.cpu().numpy().tobytes())
    return digest.hexdigest()


def vae_readahead_epochs(store, ds, sampler, step, gen, dev, want_digest):
    """The counted epoch again (same sampler epoch), read through
    epoch-window readahead, with a train step per batch as in the counted
    run: every staged batch's bytes must equal the host path's (their
    digest, taken after the epoch's clock stops), nothing may fall back,
    and no async read may stay in flight; then an epoch cancelled after
    10 batches, which must leave none in flight either."""
    loader = DeviceLoader(ds, sampler, VAE_BATCH // VAE_RANKS, device=dev,
                          readahead_windows=VAE_RA_WINDOWS,
                          readahead_window_batches=VAE_RA_WINDOW_BATCHES)
    staged, step_s = [], []
    t0 = time.perf_counter()
    for xb in loader:
        t1 = time.perf_counter()
        float(step(xb, generator=gen))
        step_s.append(time.perf_counter() - t1)
        staged.append(xb)
    wall = time.perf_counter() - t0
    summary = loader.metrics.summary()
    check(batches_digest(staged) == want_digest,
          "readahead epoch's batches differ from the host path's")
    check(loader.readahead_fallback_reason is None,
          f"readahead fell back: {loader.readahead_fallback_reason}")
    pending = [store.async_pending()]
    batches = iter(loader)
    for _ in range(10):
        next(batches)
    batches.close()
    pending.append(store.async_pending())
    check(pending == [0, 0], f"async reads left in flight: {pending}")
    return {"summary": summary, "step_s": step_s, "wall_s": wall,
            "pending": pending}


def median_ms(fn, n=VAE_PROFILE_STEPS):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def step_breakdown(model, local_step, dev):
    """Parts of a DDP step timed alone (median ms of VAE_PROFILE_STEPS,
    after the counted run; every rank runs the same collectives): the
    gloo all-reduce of the gradients' size on the card and on the host,
    the loss's all-reduce, and ``local_step``, the step of a copy of the
    model without DDP."""
    grads = torch.zeros(sum(p.numel() for p in model.parameters()),
                        device=dev)
    host = grads.cpu()
    scalar = torch.zeros((), device=dev)
    return {"allreduce_grads_card_ms": median_ms(
                lambda: dist.all_reduce(grads)),
            "allreduce_grads_host_ms": median_ms(
                lambda: dist.all_reduce(host)),
            "allreduce_loss_ms": median_ms(lambda: dist.all_reduce(scalar)),
            "step_without_ddp_ms": median_ms(
                lambda: float(local_step())),
            "grad_elements": grads.numel()}


def run_ranks(phase, world, seed):
    """Spawn the rank processes of ``phase`` and collect their results;
    any rank that fails, or dies without a result, fails the run."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=store_rank,
                         args=(phase, r, world, port, seed, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + 900
    try:
        while len(results) + len(errors) < world:
            try:
                rank, ok, value = q.get(timeout=5)
                (results if ok else errors)[rank] = value
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs) if p.exitcode not in
                    (None, 0) and r not in results and r not in errors]
            check(not dead, f"{phase} rank(s) {dead} died with exit codes "
                            f"{[procs[r].exitcode for r in dead]}")
            check(time.monotonic() < deadline, f"{phase} ranks timed out")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    check(not errors, f"{phase} rank failures: {errors}")
    return [results[r] for r in range(world)]


@torch.no_grad()
def _largest_difference(a, b) -> float:
    return max(float((x - y).abs().max())
               for x, y in zip(a.parameters(), b.parameters()))


def nccl_vs_plain(name, models, make_step, inputs, card):
    """A one-process NCCL group: DDP steps of ``models[0]`` on each of
    ``inputs`` (``(args, kwargs)`` of a step), held to the same steps of
    ``models[1]`` without DDP (a sum over one rank)."""
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        check(dist.get_backend() == "nccl", "not an NCCL group")
        steps = [make_step(m, g)
                 for m, g in zip(models, (dist.group.WORLD, None))]
        got = [[float(s(*a, **k)) for s in steps] for a, k in inputs]
        diff = _largest_difference(*models)
        print(f"{name} nccl (one process, NCCL group of 1) | {card}: "
              f"{len(inputs)} DDP steps, losses (ddp, plain) {got}; "
              f"largest parameter difference {diff:.3e}", flush=True)
        check(all(math.isfinite(a) and abs(a - b) <= 1e-6 * abs(b)
                  for a, b in got), f"{name} nccl ddp steps {got}")
        check(diff <= 1e-6, f"{name} nccl ddp parameters differ by {diff}")
    finally:
        dist.destroy_process_group()


def vae_nccl(dev, seed, card):
    """VAE_NCCL_STEPS DDP steps of the VAE in a one-process NCCL group."""
    per_rank = VAE_BATCH // VAE_RANKS
    models = [tvae.VAE(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed)) for _ in "ab"]
    raw = torch.from_numpy(synthetic_mnist(
        VAE_NCCL_STEPS * per_rank, seed + 2)[0]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    inputs = [((raw[i * per_rank:(i + 1) * per_rank],),
               {"eps": torch.randn((per_rank, tvae.LATENT), generator=gen,
                                   device=dev)})
              for i in range(VAE_NCCL_STEPS)]
    nccl_vs_plain("vae", models, lambda m, g: tvae.make_train_step(
        m, tvae.create_train_state(m)[1], group=g), inputs, card)


def phase_vae(dev, seed, card):
    """The VAE DDP slice (phase 7)."""
    vae_card_vs_cpu(dev, seed)
    print(f"vae ddp: {VAE_RANKS} rank processes on cuda:0, gradients "
          f"all-reduced over gloo (NCCL refuses two ranks on one "
          f"device); the store's remote rows over TCP (DDSTORE_CMA=0)",
          flush=True)
    t0 = time.perf_counter()
    ranks = run_ranks("vae", VAE_RANKS, seed)
    wall = time.perf_counter() - t0
    per_rank = VAE_BATCH // VAE_RANKS
    steps_want = (VAE_SAMPLES // VAE_RANKS) // per_rank
    for r, res in enumerate(ranks):
        losses, m = res["losses"], res["summary"]
        med = float(np.median(res["step_s"]))
        moved = m.get("bytes_moved", {}).get("bytes_over_dcn", 0)
        remote = moved / (res["rows"] * res["row_bytes"])
        print(f"vae ddp rank {r} | {card}: {len(losses)} steps of "
              f"{per_rank}; median step {med * 1e3:.3f} ms = "
              f"{per_rank / med:.1f} samples/s; epoch wall "
              f"{res['wall_s']:.3f} s = {res['rows'] / res['wall_s']:.1f} "
              f"samples/s; input_pipeline_efficiency "
              f"{m['input_pipeline_efficiency']:.4f}; fetch (get_batch of "
              f"{per_rank} rows, about half remote) p50 "
              f"{m['host_fetch']['p50_s'] * 1e3:.3f} ms p99 "
              f"{m['host_fetch']['p99_s'] * 1e3:.3f} ms; bytes over the "
              f"wire per epoch {moved} ({remote:.4f} of the rows); peak "
              f"device memory {res['peak_bytes'] / 2**20:.1f} MiB; store "
              f"set-up {res['setup_s']:.3f} s; eval loss per sample "
              f"{res['eval_loss'] / VAE_SAMPLES:.3f} in "
              f"{res['eval_s']:.3f} s; transport {res['transport']}, CMA "
              f"ops {res['cma_ops']}; launches {res['launches']}; "
              f"scheduler {json.dumps(m.get('sched'))}", flush=True)
        check(len(losses) == steps_want, f"rank {r}: {len(losses)} steps")
        check(all(math.isfinite(x) for x in losses), "vae loss not finite")
        first = float(np.mean(losses[:VAE_TREND]))
        last = float(np.mean(losses[-VAE_TREND:]))
        check(last < first, f"vae loss did not fall: first {VAE_TREND} "
                            f"{first}, last {last}")
        check(moved > 0 and 0.45 <= remote <= 0.55,
              f"rank {r}: {remote} of the rows were remote")
        check(not any(res["launches"].values()),
              f"attention kernels launched on the VAE path: "
              f"{res['launches']}")
        check(len(set(res["checksums"])) == 1,
              f"ranks' parameters differ: {res['checksums']}")
        ra = res["readahead"]
        rm = ra["summary"]
        print(f"vae ddp rank {r} readahead epoch | {card}: "
              f"readahead_windows={VAE_RA_WINDOWS}, "
              f"window_batches={VAE_RA_WINDOW_BATCHES}, the counted "
              f"epoch's batches byte for byte; median step "
              f"{float(np.median(ra['step_s'])) * 1e3:.3f} ms; epoch wall "
              f"{ra['wall_s']:.3f} s; input_pipeline_efficiency "
              f"{rm['input_pipeline_efficiency']:.4f} (host path "
              f"{m['input_pipeline_efficiency']:.4f}); fetch p50 "
              f"{rm['host_fetch']['p50_s'] * 1e3:.3f} ms p99 "
              f"{rm['host_fetch']['p99_s'] * 1e3:.3f} ms (host path "
              f"{m['host_fetch']['p50_s'] * 1e3:.3f} / "
              f"{m['host_fetch']['p99_s'] * 1e3:.3f} ms); bytes over the "
              f"wire {rm.get('bytes_moved', {}).get('bytes_over_dcn', 0)}; "
              f"async reads pending after the epoch and after a "
              f"cancelled one {ra['pending']}; readahead_summary "
              f"{json.dumps(rm['readahead'])}", flush=True)
    check(ranks[0]["losses"] == ranks[1]["losses"],
          "the ranks' all-reduced losses differ")
    vae_collective_report(ranks, card, steps_want)
    meds = [float(np.median(res["step_s"])) for res in ranks]
    total = sum(per_rank / x for x in meds)
    wall_ms, busy_ms = ranks[0]["profile"]
    print(f"vae ddp total | {card}: {total:.1f} samples/s at the ranks' "
          f"median steps ({VAE_BATCH / max(meds):.1f} samples/s by the "
          f"slower rank); losses {ranks[0]['losses'][0]:.1f} -> "
          f"{ranks[0]['losses'][-1]:.1f} (sum over the global batch); "
          f"device busy over {VAE_PROFILE_STEPS} profiled steps "
          f"{busy_ms:.3f} of {wall_ms:.3f} ms ({busy_ms / wall_ms:.1%}); "
          f"phase wall {wall:.1f} s (spawn included)", flush=True)
    br = ranks[0]["breakdown"]
    print(f"vae ddp step breakdown, rank 0 | {card}: median step "
          f"{meds[0] * 1e3:.3f} ms; alone: the same step without DDP "
          f"{br['step_without_ddp_ms']:.3f} ms, gloo all-reduce of the "
          f"{br['grad_elements']} f32 gradients on the card "
          f"{br['allreduce_grads_card_ms']:.3f} ms (on the host "
          f"{br['allreduce_grads_host_ms']:.3f} ms), of the loss "
          f"{br['allreduce_loss_ms']:.3f} ms", flush=True)
    vae_nccl(dev, seed, card)
    return {"launches": {k: sum(r["launches"][k] for r in ranks)
                         for k in ranks[0]["launches"]},
            "collective_launches": {
                k: sum(r["collective"]["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]},
            "wall_s": time.perf_counter() - t0,
            "ab": [r["ab"] for r in ranks],
            "shuffle": [r["shuffle"] for r in ranks]}


def vae_collective_report(ranks, card, steps_want):
    """Phase 7's third epoch: the device-collective fetch's checks and
    numbers, rank by rank."""
    per_rank = VAE_BATCH // VAE_RANKS
    local = 0
    for r, res in enumerate(ranks):
        c = res["collective"]
        m = c["summary"]
        moved, coll = m["bytes_moved"], m["collective"]
        med = float(np.median(c["step_s"]))
        padded_rows = moved["bytes_over_ici"] / res["row_bytes"]
        print(f"vae ddp rank {r} collective epoch | {card}: {c['batches']} "
              f"global batches of {VAE_BATCH}, {per_rank} rows a rank, "
              f"each rank reading only its own rows and one "
              f"all_to_all_single over gloo delivering them (exchange on "
              f"{coll['exchange_device']}); median step {med * 1e3:.3f} ms "
              f"= {per_rank / med:.1f} samples/s; epoch wall "
              f"{c['wall_s']:.3f} s; input_pipeline_efficiency "
              f"{m['input_pipeline_efficiency']:.4f}; staging (plan, local "
              f"get_batch, send buffer, copy to the card) p50 "
              f"{m['host_fetch']['p50_s'] * 1e3:.3f} ms p99 "
              f"{m['host_fetch']['p99_s'] * 1e3:.3f} ms; exchange "
              f"(all_to_all_single + index_select) p50 "
              f"{m['device_put']['p50_s'] * 1e3:.3f} ms p99 "
              f"{m['device_put']['p99_s'] * 1e3:.3f} ms; exchanges "
              f"{coll['exchanges']}; ledger {json.dumps(moved)}; padding "
              f"share of the rows sent "
              f"{1 - moved['rows_over_ici'] / padded_rows:.4f}; losses "
              f"{c['losses'][0]:.1f} -> {c['losses'][-1]:.1f}; launches "
              f"{c['launches']}; fallbacks "
              f"{m['faults']['collective_batch_fallbacks']}", flush=True)
        check(c["fallback"] is None, f"collective fell back: {c['fallback']}")
        check(m["faults"]["collective_batch_fallbacks"] == 0,
              "collective batches fell back to the host path")
        check(c["batches"] == steps_want and
              coll["exchanges"] == c["batches"],
              f"rank {r}: {coll['exchanges']} exchanges for "
              f"{c['batches']} batches")
        check(moved["bytes_over_dcn"] == 0, "collective rows crossed TCP")
        share = moved["rows_over_ici"] / (c["batches"] * per_rank)
        check(0.45 <= share <= 0.55,
              f"rank {r}: {share} of its rows sent to the other rank")
        check(c["digest_equal"], "collective epoch's batches differ from "
                                 "get_batch of the same slices")
        check(all(math.isfinite(x) for x in c["losses"]),
              "collective epoch loss not finite")
        check(np.mean(c["losses"][-VAE_TREND:]) <
              np.mean(c["losses"][:VAE_TREND]),
              "collective epoch's loss did not fall")
        check(not any(c["launches"].values()),
              f"attention kernels launched: {c['launches']}")
        check(len(set(c["checksums"])) == 1,
              f"collective epoch's parameters differ: {c['checksums']}")
        local += moved["bytes_local_get"]
    want = steps_want * VAE_BATCH * ranks[0]["row_bytes"]
    check(local == want, f"ranks' local reads {local} != epoch bytes {want}")
    check(ranks[0]["collective"]["losses"] ==
          ranks[1]["collective"]["losses"],
          "the ranks' collective-epoch losses differ")


def gnn_batch_on(batch, dev):
    return GraphBatch(*(torch.from_numpy(np.asarray(f)).to(dev)
                        for f in batch))


def _mpnn_step(weights, dtype, dev, host):
    """One MPNN train step (Adam at lr 1e-3) from ``weights`` on ``dev``:
    the loss, and each parameter's gradient and value after the step, on
    the CPU."""
    model = tgnn.MPNN(n_graphs=GNN_G, compute_dtype=dtype, device=dev)
    model.load_state_dict(weights)
    loss = float(tgnn.make_train_step(
        model, tgnn.create_train_state(model)[1])(gnn_batch_on(host, dev)))
    return (loss, {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: p.detach().cpu() for n, p in model.named_parameters()})


def _step_errors(run, ref, weights):
    """A step against the reference step from the same ``weights``: the
    loss's relative error, the worst gradient leaf's L2 error over its
    L2 norm, the parameters' largest difference after the step, and the
    share of weights the step moved another way than the reference."""
    (loss, grads, after), (rloss, rgrads, rafter) = run, ref
    flips = sum(int((torch.sign(after[n] - w)
                     != torch.sign(rafter[n] - w)).sum())
                for n, w in weights.items())
    return (abs(loss - rloss) / abs(rloss),
            max(float((grads[n] - g).norm() / g.norm())
                for n, g in rgrads.items()),
            max(float((after[n] - a).abs().max()) for n, a in rafter.items()),
            flips / sum(w.numel() for w in weights.values()))


def gnn_card_vs_cpu(dev, seed, card):
    """One MPNN train step (the repo's GNN at full width, one slot of
    GNN_G graphs) on the card against the CPU's f32 step from the same
    weights. f32 directly, at GNN_F32_TOL. In bf16 the card (cuBLAS
    products, the scatter's bf16 atomics in a varying order) and the CPU
    round differently, so both bf16 steps are held to the f32 step, and
    the card's error in each of GNN_BF16_RUNS steps to at most
    GNN_BF16_FACTOR times the CPU's."""
    graphs = synthetic_graphs(np.random.default_rng(seed), GNN_G)
    host = pack_graph_batch(graphs, 1, GNN_G, GNN_G * 12, GNN_G * 36)
    weights = tgnn.MPNN(n_graphs=GNN_G, device="cpu").init_weights(
        torch.Generator().manual_seed(seed)).state_dict()
    ref = _mpnn_step(weights, torch.float32, "cpu", host)

    loss_err, grad_err, step_err, _ = _step_errors(
        _mpnn_step(weights, torch.float32, dev, host), ref, weights)
    loss_rtol, grad_tol, step_atol = GNN_F32_TOL
    msg = (f"gnn card vs cpu (float32) | {card}: loss relative error "
           f"{loss_err:.3e} (tol {loss_rtol}); worst gradient leaf error "
           f"{grad_err:.3e} of its L2 norm (tol {grad_tol}); parameters "
           f"after one Adam step differ by at most {step_err:.3e} (tol "
           f"{step_atol})")
    print(msg, flush=True)
    check(loss_err <= loss_rtol and grad_err <= grad_tol
          and step_err <= step_atol, msg)

    cpu = _step_errors(_mpnn_step(weights, torch.bfloat16, "cpu", host),
                       ref, weights)
    runs = [_mpnn_step(weights, torch.bfloat16, dev, host)
            for _ in range(GNN_BF16_RUNS)]
    errs = [_step_errors(r, ref, weights) for r in runs]
    # the card's steps among themselves: the atomics' varying order
    spread = max(_step_errors(r, runs[0], weights)[1] for r in runs[1:])
    limits = (max(GNN_BF16_FACTOR * cpu[0], 2.0 ** -8),
              GNN_BF16_FACTOR * cpu[1], GNN_BF16_FACTOR * cpu[3])
    worst = tuple(max(e[i] for e in errs) for i in (0, 1, 3))
    msg = (f"gnn card vs cpu (bfloat16), each against the CPU's f32 step "
           f"| {card}: CPU loss error {cpu[0]:.3e}, worst gradient leaf "
           f"{cpu[1]:.3e} of its L2 norm, steps moved another way "
           f"{cpu[3]:.4%}, parameters {cpu[2]:.3e}; card over "
           f"{GNN_BF16_RUNS} steps: loss {min(e[0] for e in errs):.3e}"
           f"-{worst[0]:.3e} (limit {limits[0]:.3e}), gradient "
           f"{min(e[1] for e in errs):.3e}-{worst[1]:.3e} (limit "
           f"{limits[1]:.3e}), steps moved another way "
           f"{min(e[3] for e in errs):.4%}-{worst[2]:.4%} (limit "
           f"{limits[2]:.4%}), parameters up to "
           f"{max(e[2] for e in errs):.3e}; the card's steps among "
           f"themselves: worst gradient leaf {spread:.3e} of its L2 norm")
    print(msg, flush=True)
    check(all(w <= lim for w, lim in zip(worst, limits)), msg)


def _gnn_train(rank, group, store, dev, seed):
    t0 = time.perf_counter()
    graphs = synthetic_graphs(np.random.default_rng(seed + rank),
                              nsplit(GNN_GRAPHS, GNN_RANKS)[rank])
    gen_s = time.perf_counter() - t0
    ds = GraphShardedDataset(store, graphs, graphs_per_slot=GNN_G)
    setup_s = time.perf_counter() - t0
    graph_bytes = sum(store.row_nbytes(v) * store.total_rows(v)
                      for v in store.variables())
    model = tgnn.MPNN(n_graphs=GNN_G, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    _, opt = tgnn.create_train_state(model, lr=GNN_LR)
    step = tgnn.make_train_step(model, opt, group=dist.group.WORLD)
    sampler = DistributedSampler(len(ds), GNN_RANKS, rank, seed=seed)
    idx = sampler.epoch_indices()[:GNN_STEPS * GNN_G]
    loader = DeviceLoader(ds, sampler, GNN_G, device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()  # count the main path alone
    losses, step_s = [], []
    batches = iter(loader)
    t_start = time.perf_counter()
    for i in range(GNN_STEPS):
        gb = next(batches)
        if i == 0:
            staged = [f.cpu().numpy() for f in gb]
        t1 = time.perf_counter()
        losses.append(float(step(gb)))  # syncs
        step_s.append(time.perf_counter() - t1)
    batches.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts()
    summary = loader.metrics.summary()
    peak = torch.cuda.max_memory_allocated(dev)

    # the first staged batch against the same graphs read one at a time
    one = [GraphSample(*(store.get_ragged(f"graphs/{v}", int(i))
                         for v in ("nodes", "edge_index", "edge_attr")),
                       store.get("graphs/y", int(i))[0])
           for i in idx[:GNN_G]]
    want = pack_graph_batch(one, 1, GNN_G, ds.node_budget, ds.edge_budget)
    for name, a, b in zip(GraphBatch._fields, staged, want):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"staged GraphBatch.{name} != pack_graph_batch of get_ragged")
    remote = float(np.mean(store.owner_of_rows("graphs/nodes/index", idx)
                           != rank))

    ev = tgnn.make_eval_step(model, group=dist.group.WORLD)
    eval_loader = DeviceLoader(
        ds, DistributedSampler(len(ds), GNN_RANKS, rank, shuffle=False),
        GNN_G, device=dev)
    t1 = time.perf_counter()
    eval_losses = [float(ev(gb)) for gb in
                   itertools.islice(eval_loader, GNN_EVAL_BATCHES)]
    eval_s = time.perf_counter() - t1

    # more steps, under the profiler on rank 0 (every rank runs the same
    # number: each one is a collective)
    sampler.set_epoch(1)
    batches = iter(DeviceLoader(ds, sampler, GNN_G, device=dev))

    def steps():
        for _ in range(GNN_PROFILE_STEPS):
            float(step(next(batches)))

    if rank == 0:
        prof = device_profile(f"gnn ddp {GNN_PROFILE_STEPS} steps, rank 0",
                              steps)
    else:
        steps()
        steps()
        prof = None
    gb = next(batches)
    batches.close()
    local = tgnn.MPNN(n_graphs=GNN_G, device=dev)
    local.load_state_dict(model.state_dict())
    local_step = tgnn.make_train_step(
        local, tgnn.create_train_state(local, lr=GNN_LR)[1])
    ragged = ragged_fetch_check(store, rank, dev, seed)
    return {"breakdown": step_breakdown(model, lambda: local_step(gb), dev),
            "ragged": ragged,
            "losses": losses, "step_s": step_s, "wall_s": wall,
            "gen_s": gen_s, "setup_s": setup_s, "graph_bytes": graph_bytes,
            "eval_losses": eval_losses, "eval_s": eval_s,
            "launches": launches, "summary": summary, "peak_bytes": peak,
            "remote": remote, "profile": prof,
            "budgets": (ds.node_budget, ds.edge_budget),
            "checksums": group.allgather(param_digest(model))}


def ragged_fetch_check(store, rank, dev, seed):
    """Phase 9's ragged check, in phase 8's ranks after their counted
    run: device_fetch_ragged_batch of one global batch of the GNN's
    ``nodes`` against get_ragged_batch + pad_ragged of this rank's
    slice."""
    name = "graphs/nodes"
    idx = np.random.default_rng(seed + 5).integers(
        0, store.ragged_total(name), 4 * GNN_G * GNN_RANKS)
    per = len(idx) // GNN_RANKS
    t0 = time.perf_counter()
    padded, lens = device_fetch_ragged_batch(store, name, idx,
                                             RAGGED_MAX_LEN, device=dev)
    torch.cuda.synchronize()
    fetch_s = time.perf_counter() - t0
    values, want_lens = store.get_ragged_batch(
        name, idx[rank * per:(rank + 1) * per])
    want, _ = pad_ragged(values, want_lens, RAGGED_MAX_LEN)
    return {"equal": bool(padded.is_cuda and np.array_equal(lens, want_lens)
                          and padded.cpu().numpy().tobytes()
                          == want.tobytes()),
            "shape": list(padded.shape), "fetch_s": fetch_s}


def phase_gnn(dev, seed, card):
    """The GNN DDP slice (phase 8)."""
    gnn_card_vs_cpu(dev, seed, card)
    print(f"gnn ddp: {GNN_RANKS} rank processes on cuda:0, gradients "
          f"all-reduced over gloo; the store's remote graphs over TCP "
          f"(DDSTORE_CMA=0)", flush=True)
    t0 = time.perf_counter()
    ranks = run_ranks("gnn", GNN_RANKS, seed)
    wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        losses, m = res["losses"], res["summary"]
        med = float(np.median(res["step_s"]))
        print(f"gnn ddp rank {r} | {card}: {len(losses)} steps of "
              f"{GNN_G} graphs (budgets {res['budgets']}); median step "
              f"{med * 1e3:.3f} ms = {GNN_G / med:.1f} graphs/s; run wall "
              f"{res['wall_s']:.3f} s = "
              f"{len(losses) * GNN_G / res['wall_s']:.1f} graphs/s; "
              f"input_pipeline_efficiency "
              f"{m['input_pipeline_efficiency']:.4f}; fetch (three ragged "
              f"reads and one fixed of {GNN_G} graphs, packed) p50 "
              f"{m['host_fetch']['p50_s'] * 1e3:.3f} ms p99 "
              f"{m['host_fetch']['p99_s'] * 1e3:.3f} ms; {res['remote']:.4f}"
              f" of the graphs read from the other rank; peak device "
              f"memory {res['peak_bytes'] / 2**20:.1f} MiB; graphs made in "
              f"{res['gen_s']:.3f} s, store set-up {res['setup_s']:.3f} s, "
              f"{res['graph_bytes'] / 1e6:.1f} MB in the store; eval "
              f"{len(res['eval_losses'])} batches in {res['eval_s']:.3f} s,"
              f" mean loss {np.mean(res['eval_losses']):.5f}; transport "
              f"{res['transport']}, CMA ops {res['cma_ops']}; launches "
              f"{res['launches']}; scheduler {json.dumps(m.get('sched'))}",
              flush=True)
        check(len(losses) == GNN_STEPS, f"rank {r}: {len(losses)} steps")
        check(all(math.isfinite(x) for x in losses + res["eval_losses"]),
              "gnn loss not finite")
        first = float(np.mean(losses[:GNN_TREND]))
        last = float(np.mean(losses[-GNN_TREND:]))
        check(last < first, f"gnn loss did not fall: first {GNN_TREND} "
                            f"{first}, last {last}")
        check(0.45 <= res["remote"] <= 0.55,
              f"rank {r}: {res['remote']} of the graphs were remote")
        check(not any(res["launches"].values()),
              f"attention kernels launched on the GNN path: "
              f"{res['launches']}")
        check(len(set(res["checksums"])) == 1,
              f"ranks' parameters differ: {res['checksums']}")
    check(ranks[0]["losses"] == ranks[1]["losses"],
          "the ranks' all-reduced losses differ")
    meds = [float(np.median(res["step_s"])) for res in ranks]
    wall_ms, busy_ms = ranks[0]["profile"]
    print(f"gnn ddp total | {card}: {sum(GNN_G / x for x in meds):.1f} "
          f"graphs/s at the ranks' median steps, "
          f"{sum(len(r['losses']) * GNN_G / r['wall_s'] for r in ranks):.1f}"
          f" over the runs' walls; losses (mean of the first and last "
          f"{GNN_TREND}) {np.mean(ranks[0]['losses'][:GNN_TREND]):.5f} -> "
          f"{np.mean(ranks[0]['losses'][-GNN_TREND:]):.5f}; device busy "
          f"over {GNN_PROFILE_STEPS} profiled steps {busy_ms:.3f} of "
          f"{wall_ms:.3f} ms ({busy_ms / wall_ms:.1%}); phase wall "
          f"{wall:.1f} s (spawn included)", flush=True)
    br = ranks[0]["breakdown"]
    print(f"gnn ddp step breakdown, rank 0 | {card}: median step "
          f"{meds[0] * 1e3:.3f} ms; alone: the same step without DDP "
          f"{br['step_without_ddp_ms']:.3f} ms, gloo all-reduce of the "
          f"{br['grad_elements']} f32 gradients on the card "
          f"{br['allreduce_grads_card_ms']:.3f} ms (on the host "
          f"{br['allreduce_grads_host_ms']:.3f} ms), of the loss "
          f"{br['allreduce_loss_ms']:.3f} ms", flush=True)
    gnn_nccl(dev, seed, card)
    return {"launches": {k: sum(r["launches"][k] for r in ranks)
                         for k in ranks[0]["launches"]},
            "ragged": [r["ragged"] for r in ranks]}


def gnn_nccl(dev, seed, card):
    """GNN_NCCL_STEPS DDP steps of the MPNN in a one-process NCCL group,
    with PyTorch's deterministic algorithms: the scatter's atomics would
    otherwise sum in a different order in the two models."""
    models = [tgnn.MPNN(n_graphs=GNN_G, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed)) for _ in "ab"]
    graphs = synthetic_graphs(np.random.default_rng(seed + 2),
                              GNN_NCCL_STEPS * GNN_G)
    inputs = [((gnn_batch_on(pack_graph_batch(
        graphs[i * GNN_G:(i + 1) * GNN_G], 1, GNN_G, GNN_G * 12,
        GNN_G * 36), dev),), {}) for i in range(GNN_NCCL_STEPS)]
    torch.use_deterministic_algorithms(True)
    try:
        nccl_vs_plain("gnn", models, lambda m, g: tgnn.make_train_step(
            m, tgnn.create_train_state(m, lr=GNN_LR)[1], group=g), inputs,
            card)
    finally:
        torch.use_deterministic_algorithms(False)


def phase_collective(dev, seed, card, va, gn):
    """Phase 9: the device-collective fetch and the shuffles beyond phase
    7's epoch. Here, in a one-process NCCL group over a world-1 store:
    20 batches of the loader's collective path against the host path,
    the A/B at the bench geometry, global_shuffle_epoch and
    permute_rows on the card. Then the checks phases 7 and 8 ran in
    their rank processes: the A/B over gloo, the ragged fetch of the
    GNN's nodes, and host_global_shuffle of the VAE variable."""
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    store = DDStore()
    try:
        check(dist.get_backend() == "nccl", "not an NCCL group")
        data = synthetic_mnist(VAE_SAMPLES, seed)[0]
        ds = ShardedDataset(store, data)
        sampler = DistributedSampler(len(ds), 1, 0, seed=seed)
        loader = DeviceLoader(ds, sampler, VAE_BATCH, device=dev,
                              device_collective=True)
        check(loader._collective_ready,
              f"collective unusable: {loader.collective_fallback_reason}")
        zero_launch_counts()
        batches = iter(loader)
        staged = [next(batches) for _ in range(COLL_NCCL_BATCHES)]
        batches.close()
        launches = launch_counts()
        m = loader.metrics.summary()
        idx = sampler.epoch_indices()
        want = hashlib.sha256()
        for b in range(COLL_NCCL_BATCHES):
            want.update(ds.fetch(
                idx[b * VAE_BATCH:(b + 1) * VAE_BATCH]).tobytes())
        coll = m["collective"]
        print(f"collective nccl (one process, NCCL group of 1) | {card}: "
              f"{COLL_NCCL_BATCHES} batches of {VAE_BATCH}, exchange on "
              f"{coll['exchange_device']}, exchanges {coll['exchanges']}; "
              f"staging p50 {m['host_fetch']['p50_s'] * 1e3:.3f} ms, "
              f"exchange p50 {m['device_put']['p50_s'] * 1e3:.3f} ms; "
              f"launches {launches}", flush=True)
        check(all(x.is_cuda for x in staged), "batches not on the card")
        check(batches_digest(staged) == want.hexdigest(),
              "NCCL collective batches differ from get_batch")
        check(coll["exchange_device"].startswith("cuda"),
              f"NCCL exchange on {coll['exchange_device']}")
        check(coll["exchanges"] == COLL_NCCL_BATCHES,
              f"{coll['exchanges']} exchanges for {COLL_NCCL_BATCHES}")
        check(loader.collective_fallback_reason is None and
              m["faults"]["collective_batch_fallbacks"] == 0,
              "the NCCL collective fell back")
        check(not any(launches.values()), f"attention launched {launches}")
        ab = [fetch_ab(store, dev, seed)] + va["ab"]
        x = torch.from_numpy(data[:8192]).to(dev)
        t1 = time.perf_counter()
        y = global_shuffle_epoch(x, seed)
        torch.cuda.synchronize()
        shuffle_ms = (time.perf_counter() - t1) * 1e3
        perm = np.random.default_rng(seed + 3).permutation(len(x))
        t1 = time.perf_counter()
        z = permute_rows(x, perm)
        torch.cuda.synchronize()
        permute_ms = (time.perf_counter() - t1) * 1e3
        check(y.is_cuda and torch.equal(y, global_shuffle_epoch(x, seed))
              and _multiset(y.cpu().numpy()) == _multiset(data[:8192])
              and not torch.equal(y, x),
              "global_shuffle_epoch is not a seeded permutation")
        check(torch.equal(z, x[torch.from_numpy(perm).to(dev)]),
              "permute_rows != x[perm]")
        print(f"shuffles nccl | {card}: global_shuffle_epoch of "
              f"{tuple(x.shape)} uint8 {shuffle_ms:.3f} ms, permute_rows "
              f"{permute_ms:.3f} ms (first calls, one rank)", flush=True)
    finally:
        store.close()
        dist.destroy_process_group()
    for a in ab:
        print(f"device_fetch A/B ({a['world']} rank(s), "
              f"{'NCCL' if a['world'] == 1 else 'gloo'}, exchange on "
              f"{a['exchange_device']}) | {card}: {AB_BATCHES} batches of "
              f"{AB_BATCH} from {AB_ROWS} x {AB_DIM} f32, every batch equal "
              f"first; median per batch: get_batch + copy to the card "
              f"{a['host_ms']:.3f} ms, device_fetch_batch "
              f"{a['collective_ms']:.3f} ms; per batch and rank the host "
              f"path pulls {a['host_dcn_bytes']} bytes over TCP, the "
              f"collective {json.dumps(a['ledger'])}", flush=True)
    for r, (g, sh) in enumerate(zip(gn["ragged"], va["shuffle"])):
        print(f"rank {r} | {card}: device_fetch_ragged_batch of "
              f"graphs/nodes {g['shape']} equal {g['equal']} "
              f"({g['fetch_s'] * 1e3:.3f} ms, first call); "
              f"host_global_shuffle of the VAE variable ({sh['rows']} rows "
              f"a rank) {sh['shuffle_s']:.3f} s, shard = plain "
              f"permutation {sh['equal']}, multiset kept "
              f"{sh['multiset_equal']}", flush=True)
        check(g["equal"], "device_fetch_ragged_batch != get_ragged_batch")
        check(sh["equal"] and sh["multiset_equal"],
              "host_global_shuffle is not the seeded permutation")
    wall = time.perf_counter() - t0
    print(f"phase 9 wall {wall:.1f} s (phase 7 {va['wall_s']:.1f} s, its "
          f"rank processes holding the two-rank checks)", flush=True)
    return {"launches": launches}


def kernel_table(kern, bwd, sl, tr, va, gn, co):
    """The kernels' JSON line: launches are the training path's (the
    path that runs all three), with each path's counts beside them."""
    by_path = {k: {"serving": sl["launches"][k], "training": v,
                   "vae_ddp": va["launches"][k],
                   "gnn_ddp": gn["launches"][k],
                   "vae_collective": va["collective_launches"][k],
                   "collective_nccl": co["launches"][k]}
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

    # 2. build: the kernels, and the store's native core beside them
    def timed_native_build():
        t0 = time.perf_counter()
        return native_build.build(), time.perf_counter() - t0

    with ThreadPoolExecutor(1) as ex:
        native = ex.submit(timed_native_build)
        build_s = _build.build_all()
        native_path, native_s = native.result()
    print(f"build native store core: {native_s:.2f} s "
          f"({len(native_build.SOURCES)} translation units) -> "
          f"{native_path}", flush=True)
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

    # 4.-9. the small reference check, then the slices on the store
    small_reference_check(dev, args.seed)
    store, ds = make_store(args.seed)
    sl = phase_slice(dev, args.seed, ds)
    tr = phase_train(dev, args.seed, ds)
    store.close()
    va = phase_vae(dev, args.seed, card)
    gn = phase_gnn(dev, args.seed, card)
    co = phase_collective(dev, args.seed, card, va, gn)

    print(json.dumps(kernel_table(kern, bwd, sl, tr, va, gn, co)),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
