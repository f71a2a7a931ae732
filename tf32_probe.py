"""Probe of the port's f32 flash-backward kernels (3xTF32 ``wgmma``) on the
card, quicker than ``chip_smoke.py``.

    python3 tf32_probe.py [--quick] [--variants]

Builds ``ddstore_tpu_torch/ops/csrc/*.cu``, prints ptxas's report of the
f32 kernels (registers, spills, any C75xx advisory), holds the f32 dq and
dk/dv kernels to their plain versions, row by row at 1e-4, on edge cases
(ragged tiles, offsets, fully-masked rows, head dims 8 to 1000; dq, dk, dv
bit-identical over two launches), then at (8, H, 2048, d) causal, H = 1024
// d, on the LM's qkv views, and times them there against SDPA's f32
backward. ``--quick`` runs three cases and d 64 only. ``--variants`` then
builds timing-only variants of ``flash_bwd.cu`` into ``build/`` (which git
ignores) and times them in turns with the built one at d 64, 256 and 512:
``nosplit`` skips the producer's split of the landed tiles (wrong results:
what the split costs), ``dkv256bq64`` gives the dk/dv kernel 64-query tiles
at d 256 (its report says whether that spills). Each variant's dq is
compared bit for bit with the built one's. Needs one CUDA card; exits 2
without one.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import torch

from ddstore_tpu_torch.ops import _build, attention

# name -> [(source file, text, replacement)], applied to a copy of csrc/
VARIANTS = {
    "nosplit": [("flash_bwd.cu",
                 "      convert(j, smem + s * L::kStageBytes, pt - 32);\n",
                 "")],
    "dkv256bq64": [("flash_bwd.cu", "launch_dkv_tf32<256, 32>",
                    "launch_dkv_tf32<256, 64>")],
}
# (b, h, sq, sk, d, causal, q_offset, kv_offset)
CASES = [(1, 2, 64, 64, 64, False, 0, 0), (1, 2, 64, 64, 32, False, 0, 0),
         (2, 3, 256, 256, 64, True, 0, 0), (2, 3, 200, 200, 64, False, 0, 0),
         (2, 3, 136, 136, 128, True, 0, 0), (2, 3, 72, 72, 64, True, 0, 0),
         (2, 3, 72, 136, 128, False, 0, 0),
         (2, 3, 256, 256, 64, True, 192, 64),
         (2, 3, 128, 128, 64, True, 0, 64),
         (2, 3, 136, 520, 64, True, 384, 0), (2, 3, 200, 200, 8, True, 0, 0),
         (2, 3, 200, 200, 72, True, 0, 0), (2, 3, 200, 200, 136, True, 0, 0),
         (2, 3, 200, 200, 256, True, 0, 0), (2, 3, 72, 136, 264, False, 0, 0),
         (2, 3, 200, 200, 512, True, 0, 0), (1, 2, 40, 40, 1000, True, 0, 0)]
ROW_REL = 1e-4


def spill_lines(log):
    """ptxas's nonzero spill lines, each after the kernel it is about."""
    out, entry = [], "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif "spill" in ln and \
                "0 bytes spill stores, 0 bytes spill loads" not in ln:
            out.append(f"{entry}: {ln.strip()}")
    return out


def rows_err(got, want, dead):
    """(largest row error relative to the row, or to a thousandth of the
    largest row, as chip_smoke.row_rel; rows in ``dead`` not 0)."""
    got, want = got.float(), want.float()
    nonzero = int((got[dead] != 0).sum())
    norm = want.norm(dim=-1)
    err = (got - want).norm(dim=-1)[~dead] / \
        norm[~dead].clamp_min(1e-3 * float(norm.max()))
    return (float(err.max()) if err.numel() else 0.0), nonzero


def case(dev, b, h, sq, sk, d, causal, qo, ko):
    g = torch.Generator(device=dev).manual_seed(sq + sk + d)
    q = torch.randn((b, h, sq, d), generator=g, device=dev)
    k, v = (torch.randn((b, h, sk, d), generator=g, device=dev)
            for _ in range(2))
    do = torch.randn((b, h, sq, d), generator=g, device=dev)
    dlse = torch.randn((b, h, sq), generator=g, device=dev)
    kw = dict(causal=causal, q_offset=qo, kv_offset=ko, scale=d ** -0.5)
    with torch.no_grad():
        out, lse = attention.flash_attention(q, k, v, causal=causal,
                                             q_offset=qo, kv_offset=ko)
        c = attention.flash_bwd_prep(do, out, dlse)
        got = [attention._flash_bwd_dq_cuda(q, k, v, do, lse, c, **kw),
               *attention._flash_bwd_dkv_cuda(q, k, v, do, lse, c, **kw)]
        again = [attention._flash_bwd_dq_cuda(q, k, v, do, lse, c, **kw),
                 *attention._flash_bwd_dkv_cuda(q, k, v, do, lse, c, **kw)]
        torch.cuda.synchronize()
        want = [attention.flash_bwd_dq_reference(q, k, v, do, lse, c, **kw),
                *attention.flash_bwd_dkv_reference(q, k, v, do, lse, c,
                                                   **kw)]
    kpos = ko + torch.arange(sk, device=dev)
    dead_k = (kpos > qo + sq - 1 if causal else
              torch.zeros_like(kpos, dtype=torch.bool)).expand(b, h, sk)
    res = {n: rows_err(x, y, dead) for n, x, y, dead in zip(
        ("dq", "dk", "dv"), got, want,
        (~torch.isfinite(lse), dead_k, dead_k))}
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    ok = same and all(e <= ROW_REL and nz == 0 for e, nz in res.values())
    print(f"case {(b, h, sq, sk, d, causal, qo, ko)}: " + " ".join(
        f"{n} rel={e:.3e} dead_nonzero={nz}" for n, (e, nz) in res.items())
          + f" bit-identical={same} {'OK' if ok else 'FAIL'}", flush=True)
    return ok


def time_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def lm_shape(dev, d):
    """q, k, v as the LM's qkv views at (8, 1024 // d, 2048, d), do, lse,
    c and the backward's keyword arguments."""
    b, h, s = 8, 1024 // d, 2048
    base = torch.randn((b, s, 3 * h * d), device=dev).requires_grad_()
    ql, kl, vl = (t.reshape(b, s, h, d).transpose(1, 2)
                  for t in base.split(h * d, dim=-1))
    q, k, v = (t.detach() for t in (ql, kl, vl))
    do = torch.randn((b, s, h, d), device=dev).transpose(1, 2)
    with torch.no_grad():
        out, lse = attention.flash_attention(q, k, v, causal=True)
        c = attention.flash_bwd_prep(do, out)
    kw = dict(causal=True, q_offset=0, kv_offset=0, scale=d ** -0.5)
    return (ql, kl, vl), (q, k, v, do, lse, c), kw


def timing(dev, d):
    (ql, kl, vl), ops, kw = lm_shape(dev, d)
    q, k, v, do, lse, c = ops
    with torch.no_grad():
        got = [attention._flash_bwd_dq_cuda(*ops, **kw),
               *attention._flash_bwd_dkv_cuda(*ops, **kw)]
        want = [attention.flash_bwd_dq_reference(*ops, **kw),
                *attention.flash_bwd_dkv_reference(*ops, **kw)]
    live = torch.zeros(lse.shape, dtype=torch.bool, device=dev)
    errs = {n: rows_err(x, y, live)[0]
            for n, x, y in zip(("dq", "dk", "dv"), got, want)}
    del got, want
    sd = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl,
                                                          is_causal=True)
    with torch.no_grad():
        r = {"dq": time_ms(lambda: attention._flash_bwd_dq_cuda(*ops, **kw),
                           10),
             "dkv": time_ms(lambda: attention._flash_bwd_dkv_cuda(*ops,
                                                                  **kw), 10)}
    r["sdpa_backward"] = time_ms(lambda: torch.autograd.grad(
        sd, (ql, kl, vl), do, retain_graph=True), 10)
    print(f"d={d} (8,{1024 // d},2048,{d}) f32 causal: row errors {errs}; "
          f"dq {r['dq']:.4f} ms dkv {r['dkv']:.4f} ms sum "
          f"{r['dq'] + r['dkv']:.4f} sdpa_backward {r['sdpa_backward']:.4f}"
          f" ms", flush=True)
    return max(errs.values()) <= ROW_REL, r


def variants(dev):
    """Builds each of VARIANTS from a copy of csrc/ under build/, then times
    the built library and each variant in turns (all, then reversed)."""
    src = os.path.join("ddstore_tpu_torch", "ops", "csrc")
    procs = {}
    for name, edits in VARIANTS.items():
        dst = os.path.join("build", "tf32_probe_" + name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
        for fn, old, new in edits:
            path = os.path.join(dst, fn)
            with open(path) as f:
                text = f.read()
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {fn}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        so = os.path.abspath(os.path.join(dst, "libflash_bwd.so"))
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(dst, "flash_bwd.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {"built": attention._load_bwd()}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        print(f"variant {name}: spills {spill_lines(log)}", flush=True)
        libs[name] = ctypes.CDLL(so)
    try:
        for d in (64, 256, 512):
            _, ops, kw = lm_shape(dev, d)
            res = {n: {"dq": [], "dkv": []} for n in libs}
            for order in (list(libs), list(libs)[::-1]):
                for n in order:
                    _build._libs["flash_bwd"] = libs[n]
                    with torch.no_grad():
                        res[n]["dq"].append(time_ms(
                            lambda: attention._flash_bwd_dq_cuda(*ops, **kw),
                            10))
                        res[n]["dkv"].append(time_ms(
                            lambda: attention._flash_bwd_dkv_cuda(*ops,
                                                                  **kw), 10))
            dq = {}
            for n in libs:  # each variant's dq beside the built one's
                _build._libs["flash_bwd"] = libs[n]
                with torch.no_grad():
                    dq[n] = attention._flash_bwd_dq_cuda(*ops, **kw)
            for n, r in res.items():
                print(f"variant {n} d={d}: dq ms {r['dq']} dkv ms "
                      f"{r['dkv']} dq bit-identical to the built "
                      f"{torch.equal(dq[n], dq['built'])}", flush=True)
    finally:
        _build._libs["flash_bwd"] = libs["built"]


def main() -> int:
    if not torch.cuda.is_available():
        print("tf32_probe: no CUDA device", file=sys.stderr)
        return 2
    quick = "--quick" in sys.argv
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    log = _build.build_logs.get("flash_bwd", "")
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if ("tf32" in ln and "Compiling entry" in ln) or "C75" in ln:
            print("\n".join(lines[i:i + 4]), flush=True)
    print(f"spills {spill_lines(log)}", flush=True)
    cases = CASES[:3] if quick else CASES
    n_ok = sum(case(dev, *c) for c in cases)
    print(f"cases within {ROW_REL} a row: {n_ok}/{len(cases)}", flush=True)
    ok, times = n_ok == len(cases), {}
    for d in (64,) if quick else (64, 128, 256, 512):
        good, times[d] = timing(dev, d)
        ok = ok and good
        torch.cuda.empty_cache()
    if "--variants" in sys.argv:
        variants(dev)
    print(json.dumps({"ok": ok, "times": times}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
