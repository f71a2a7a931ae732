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
   checkout;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shapes and at edge cases, with timings of the
   kernel, the plain version and one library call (yardstick only);
4. slice: the serving path at the full width of the repo's LM config
   (vocab 32768, dim 1024, 16 heads, 8 layers; ``bench.py:3169``):
   4096 token windows of 2048 in the store -> sampler -> loader -> card
   -> eval loss on 4 batches of (8, 2048) -> greedy generation of 32
   tokens after 8 prompts of 2048. Launch counts are zeroed just before
   and read just after; the flash kernel must have run 8 layers x 5
   forwards = 40 times. A small model is first checked on the card
   against the same model on the CPU; after the counted run, one
   prefill and 4 decode steps run under torch.profiler to show where
   the device time goes.

Then it prints the kernel table as one JSON line, the card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``.
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
from ddstore_tpu_torch.store import DDStore

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bound of
# a kernel is max(bytes / memory rate, operations / peak rate).
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# The repo's LM config (bench.py:3169) and the slice's traffic.
VOCAB, DIM, HEADS, LAYERS = 32768, 1024, 16, 8
WINDOWS, SEQ, BATCH = 4096, 2048, 8
LOSS_BATCHES, NEW_TOKENS = 4, 32

# Kernel against plain version: bf16 out / lse, f32 out and lse (max abs
# error), and the largest error of a live row of out relative to that
# row of the plain version (L2 norms over the head dim): bf16 rounds out
# and P at 2**-8 relative, so an exact kernel stays below about 5e-3.
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 1e-4)}
ROW_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


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


def attention_work(b, h, sq, sk, d, itemsize, causal, q_offset, kv_offset):
    """(flops, bytes) the attention forward needs on these inputs: the
    score pairs that are not masked, two matmuls of 2*d each; q, k, v
    read once, out and the f32 lse written once."""
    if causal:
        # row i sees keys j with kv_offset + j <= q_offset + i
        rows = [min(sk, max(0, q_offset + i - kv_offset + 1))
                for i in range(sq)]
        pairs = sum(rows)
    else:
        pairs = sq * sk
    flops = 4.0 * b * h * d * pairs
    nbytes = (b * h * (2 * sq + 2 * sk) * d * itemsize) + b * h * sq * 4
    return flops, nbytes


def qkv_views(g, dev, b, h, s, d, dt):
    """q, k, v as ``Block.qkv_heads`` gives them to the kernel: (B, H, S,
    D) views of one (B, S, 3 * H * D) projection (row stride 3 * H * D)."""
    dim = h * d
    qkv = torch.randn((b, s, 3 * dim), generator=g, device=dev).to(dt)
    return tuple(t.reshape(b, s, h, d).transpose(1, 2)
                 for t in qkv.split(dim, dim=-1))


def phase_kernels(dev):
    """Kernel vs plain version on the card; timings at the LM shape."""
    g = torch.Generator(device=dev).manual_seed(1234)
    cases = [
        # name, (b, h, sq, sk, d), dtype, causal, q_offset, kv_offset;
        # the lm_* cases take the main path's layout (qkv_views)
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
    ]
    errs, rel_errs = {}, {}
    for name, (b, h, sq, sk, d), dt, causal, qo, ko in cases:
        if name.startswith("lm_"):
            q, k, v = qkv_views(g, dev, b, h, sq, d, dt)
        else:
            q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dt)
            k, v = (torch.randn((b, h, sk, d), generator=g,
                                device=dev).to(dt) for _ in range(2))
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
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= \
        nbytes / HBM_BYTES_PER_S else "bytes"
    ms = {k2: sum(v2) / len(v2) for k2, v2 in t.items()}
    print(f"kernel flash_fwd timing at (B,H,S,D)=({b},{h},{s},{d}) bf16 "
          f"causal: kernel_ms={ms['kernel']:.4f} plain_ms={ms['plain']:.4f}"
          f" library_ms(sdpa)={ms['library']:.4f} bound_ms={bound:.4f} "
          f"({bound_by}: {flops:.4e} FLOP, {nbytes:.4e} B) "
          f"rounds={json.dumps(t)} achieved_TFLOPs="
          f"{flops / ms['kernel'] / 1e9:.1f}", flush=True)
    return {"errs": errs, "rel_errs": rel_errs, "ms": ms, "bound_ms": bound,
            "bound_by": bound_by}


def small_reference_check(dev, seed):
    """A small model on the card (flash kernel) against the same model on
    the CPU (plain attention): f32 logits atol 1e-4, f32 loss atol 1e-5,
    greedy tokens equal after a 60-token prompt (padded to 64 for the
    kernel, one launch per layer); bf16 loss atol 2e-2."""
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
        print(msg, flush=True)
        check(math.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= tol, msg)


def phase_slice(dev, seed):
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    # Repeated-pattern corpus, as examples/lm_longcontext.py:133-143.
    base = rng.integers(0, VOCAB, size=64)
    corpus = np.tile(base, WINDOWS * SEQ // 64 + 2)
    starts = rng.integers(0, len(corpus) - SEQ - 1, size=WINDOWS)
    at = starts[:, None] + np.arange(SEQ)
    windows = corpus[at].astype(np.int32)
    nexts = corpus[at + 1].astype(np.int32)
    store = DDStore()
    ds = ShardedDataset(store, windows, nexts)
    del corpus, at, windows, nexts
    sampler = DistributedSampler(WINDOWS, 1, 0, seed=seed)
    loader = DeviceLoader(ds, sampler, BATCH, device=dev)
    model = ttr.TransformerLM(vocab=VOCAB, dim=DIM, heads=HEADS,
                              layers=LAYERS, compute_dtype=torch.bfloat16,
                              device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    data_mib = sum(store.row_nbytes(v) * store.total_rows(v)
                   for v in store.variables()) / 2**20
    print(f"slice setup: store {data_mib:.1f} MiB in "
          f"{len(store.variables())} variables, model "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"params, {time.perf_counter() - t0:.2f} s", flush=True)
    positions = torch.arange(SEQ, dtype=torch.int32,
                             device=dev).expand(BATCH, SEQ)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.flash_fwd_launches = 0  # count the main path alone
    t_start = time.perf_counter()
    batches = iter(loader)
    losses, loss_s = [], []
    for _ in range(LOSS_BATCHES):
        tok, tgt = next(batches)
        check(tok.device == torch.device(dev) and
              tok.shape == (BATCH, SEQ), "loader batch")
        t1 = time.perf_counter()
        loss = float(ttr.lm_loss(model, tok, tgt, positions))  # syncs
        loss_s.append(time.perf_counter() - t1)
        losses.append(loss)
    prompts = next(batches)[0]
    batches.close()
    stats = {}
    out = tdec.generate(model, prompts, NEW_TOKENS, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = attention.flash_fwd_launches
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    want = LAYERS * (LOSS_BATCHES + 1)
    print(f"slice: eval losses {losses} (s each: {loss_s}); generate "
          f"out {tuple(out.shape)}; prefill {stats['prefill_s']:.4f} s = "
          f"{BATCH * SEQ / stats['prefill_s']:.1f} tokens/s; decode "
          f"{stats['decode_s'] / stats['decode_steps'] * 1e3:.3f} ms per "
          f"step ({BATCH} sequences, one token each, "
          f"{stats['decode_steps']} steps); input_pipeline_efficiency "
          f"{loader.metrics.efficiency:.4f}; loader "
          f"{json.dumps(loader.metrics.summary())}; peak memory "
          f"{peak_gib:.3f} GiB; wall {wall:.3f} s; flash_fwd_launches "
          f"{launches} (want {want})", flush=True)
    check(all(math.isfinite(x) and 0 < x < 30 for x in losses),
          f"eval losses not finite/plausible: {losses}")
    check(out.shape == (BATCH, SEQ + NEW_TOKENS), "generate shape")
    check(bool(torch.equal(out[:, :SEQ], prompts)),
          "generate changed the prompt")
    check(bool(((out >= 0) & (out < VOCAB)).all()),
          "generated tokens out of range")
    check(launches == want, f"flash_fwd_launches {launches} != {want}")
    store.close()
    profile_breakdown(model, prompts, positions)
    return {"launches": launches}


def profile_breakdown(model, prompts, positions):
    """Where the device time goes, after the counted run: one prefill
    forward and 4 decode steps under torch.profiler. Prints the busy
    share of each window (self device time of all kernels over the
    window's host wall time) and its largest kernels."""
    def prefill():
        model(prompts, positions, return_features=True, return_kv=True)

    cache = tdec.init_cache(model, BATCH, SEQ + 4)

    def decode():
        for s in range(SEQ, SEQ + 4):
            tdec.decode_step(model, cache, s, prompts[:, -1:])

    for name, fn in (("prefill", prefill), ("decode x4", decode)):
        with torch.no_grad():
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
        top = "; ".join(f"{k[:60]} {ms:.3f} ms x{n}"
                        for k, ms, n in rows[:8])
        print(f"profile {name}: host wall {wall_ms:.3f} ms, device busy "
              f"{busy:.3f} ms ({busy / wall_ms:.1%}); top kernels: "
              f"{top or 'no device time captured'}", flush=True)


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
        regs = [ln.strip() for ln in _build.build_logs.get(name, "")
                .splitlines() if "registers" in ln or "spill" in ln]
        print(f"build {name}: {regs}", flush=True)
    print(f"build: {len(_build.SOURCES)} kernel(s) in {build_s:.2f} s",
          flush=True)

    # 3. kernels against their plain versions
    kern = phase_kernels(dev)

    # 4. the slice
    small_reference_check(dev, args.seed)
    sl = phase_slice(dev, args.seed)

    # 5. records
    ms = kern["ms"]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ddstore_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ddstore_tpu/ops/attention.py:92",
        "replaces_function": "_flash_kernel",
        "launches": sl["launches"],
        "max_abs_err": max(kern["errs"].values()),
        "lm_shape_max_abs_err": kern["errs"]["lm_causal"],
        "max_row_rel_err": max(kern["rel_errs"].values()),
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": ms["library"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
