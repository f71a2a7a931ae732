"""Probe of the port's 16-bit dq kernels past head dim 128 on the card,
quicker than ``chip_smoke.py``.

    python3 dq16_probe.py [--quick]

Builds ``ddstore_tpu_torch/ops/csrc/*.cu`` and prints ptxas's report of
the split and chunked dq kernels and the chunked dk/dv kernel (registers,
spills) and any C75xx advisory. Then it holds the dq kernel to its plain
version, row by row at ``chip_smoke.ROW_REL_TOL``, in bf16 and fp16, on
edge cases (three chunks with the last partial, a causal frontier inside
a 64-query block, Sk not a multiple of 64, fully-masked rows, head dims
256 to 1024; bit-identical over two launches), and times dq and dk/dv at
(8, H, 2048, d) causal, H = 1024 // d, contiguous, at d 256, 264, 512 and
1024 (``--quick``: 512 only). Needs one CUDA card; exits 2 without one
and 1 if a case fails.
"""

import sys
import time

import torch

import chip_smoke as cs
from ddstore_tpu_torch.ops import _build
from ddstore_tpu_torch.ops import attention as A

KERNELS = ("dq_chunked", "dq_split", "dkv_chunked")
# (sq, sk, d, causal, q_offset, kv_offset), at (2, 3) batches and heads
CASES = [(200, 200, 520, True, 0, 0), (136, 136, 520, False, 0, 0),
         (128, 128, 1024, True, 32, 0), (128, 200, 512, False, 0, 0),
         (72, 136, 1024, True, 64, 0), (128, 128, 520, True, 0, 40),
         (256, 256, 512, True, 192, 64), (200, 200, 264, True, 0, 0),
         (136, 136, 300, False, 0, 0), (256, 256, 256, True, 0, 0),
         (200, 136, 264, True, 0, 40), (640, 640, 512, True, 0, 0)]
DTYPES = (torch.bfloat16, torch.float16)


def report():
    """The ptxas lines of KERNELS, then the advisories and spills."""
    t0 = time.time()
    _build.build_all()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    lines = _build.build_logs.get("flash_bwd", "").splitlines()
    for i, ln in enumerate(lines):
        if "entry function" in ln and any(k in ln for k in KERNELS):
            print("\n".join(x.strip() for x in lines[i:i + 4]), flush=True)
    print("C75:", [x for x in lines if "C75" in x], flush=True)
    print("spills:", [x for x in lines if "spill" in x and
                      "0 bytes spill stores, 0 bytes spill loads" not in x],
          flush=True)


def cases(dev, g):
    """Each case against the plain version; False if one fails."""
    ok = True
    for dt in DTYPES:
        for sq, sk, d, causal, qo, ko in CASES:
            q = torch.randn((2, 3, sq, d), generator=g, device=dev).to(dt)
            k, v = (torch.randn((2, 3, sk, d), generator=g, device=dev)
                    .to(dt) for _ in range(2))
            do = torch.randn((2, 3, sq, d), generator=g, device=dev).to(dt)
            dlse = torch.randn((2, 3, sq), generator=g, device=dev)
            kw = dict(causal=causal, q_offset=qo, kv_offset=ko,
                      scale=d ** -0.5)
            with torch.no_grad():
                out, lse = A.flash_attention(q, k, v, causal=causal,
                                             q_offset=qo, kv_offset=ko)
            c = A.flash_bwd_prep(do, out, dlse)
            dq = A._flash_bwd_dq_cuda(q, k, v, do, lse, c, **kw)
            again = A._flash_bwd_dq_cuda(q, k, v, do, lse, c, **kw)
            torch.cuda.synchronize()
            want = A.flash_bwd_dq_reference(q, k, v, do, lse, c, **kw)
            e_abs, e_rel, bad = cs.row_errors(dq, want,
                                              ~torch.isfinite(lse))
            same = torch.equal(dq, again)
            good = (e_rel <= cs.ROW_REL_TOL[str(dt).split(".")[-1]]
                    and bad == 0 and same and not torch.isnan(dq).any())
            ok &= good
            print(f"{dt} {(sq, sk, d, causal, qo, ko)}: abs {e_abs:.3e} "
                  f"row {e_rel:.3e} dead-nonzero {bad} same {same}"
                  + ("" if good else " FAIL"), flush=True)
    return ok


def timings(dev, g, dims):
    for dt in DTYPES:
        for d in dims:
            h = 1024 // d
            q, k, v, do = (torch.randn((8, h, 2048, d), generator=g,
                                       device=dev).to(dt) for _ in range(4))
            kw = dict(causal=True, q_offset=0, kv_offset=0, scale=d ** -0.5)
            with torch.no_grad():
                out, lse = A.flash_attention(q, k, v, causal=True)
            c = A.flash_bwd_prep(do, out)
            ms_dq = cs.time_ms(
                lambda: A._flash_bwd_dq_cuda(q, k, v, do, lse, c, **kw), 20)
            ms_dkv = cs.time_ms(
                lambda: A._flash_bwd_dkv_cuda(q, k, v, do, lse, c, **kw), 20)
            flops, nbytes = cs.attention_work(8, h, 2048, 2048, d, 2, True,
                                              0, 0, "dq")
            print(f"time {dt} d {d} h {h}: dq {ms_dq:.4f} ms (bound "
                  f"{cs.bound_of(flops, nbytes)[0]:.4f}), dk/dv "
                  f"{ms_dkv:.4f} ms", flush=True)
            del q, k, v, do, out, lse, c
            torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("dq16_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    report()
    print(cs.card_line(), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    ok = cases(dev, g)
    timings(dev, g, (512,) if "--quick" in sys.argv else
            (256, 264, 512, 1024))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
