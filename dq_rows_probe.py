"""Probe of the flash kernels' worst rows at S = 8 against their plain
versions and against f64, on the card.

    python3 dq_rows_probe.py [--root DIR] [--batch N]

Builds the kernels of the checkout at DIR (default: this one) and, for
f32 causal attention at S = 8, d = 64 over (N, 1), (1, N), (1024, 1) and
(2, 3) batches and heads, and at S = 40 over (2, 3), then bf16 over (N,
1), prints one line a case: for out, dq, dk and dv the largest row error
over the plain version's row (or a thousandth of its largest row where
the row is smaller: the check of ``tests/test_torch_cuda.py``), where it
lies, how many rows pass 1e-4, and that row's distance from the same
arithmetic in f64 for the kernel and for the plain version (which in f32
forms dP - c in f64 and rounds it once, as the f32 dq kernel does); and
out's largest error beside the two values. N defaults to 65,536 (65,535
for a tree whose grids cap batch and heads there). Needs one CUDA card;
exits 2 without one.
"""

import argparse
import json
import os
import sys


def row_errors(got, want, exact):
    got, want, exact = got.double(), want.double(), exact.double()
    norm = want.norm(dim=-1)
    floor = 1e-3 * float(norm.max())
    err = (got - want).norm(dim=-1) / norm.clamp_min(floor)
    at = [int(i) for i in divmod_index(int(err.flatten().argmax()),
                                       err.shape)]
    return {"max": float(err.max()), "at": at,
            "rows_over_1e-4": int((err > 1e-4).sum()),
            "row_norm": float(want[tuple(at)].norm()), "floor": floor,
            "kernel_to_f64": float((got[tuple(at)] - exact[tuple(at)]).norm()),
            "plain_to_f64": float((want[tuple(at)] - exact[tuple(at)]).norm())}


def divmod_index(i, shape):
    out = []
    for n in reversed(shape):
        i, r = divmod(i, n)
        out.append(r)
    return reversed(out)


def case(A, torch, dev, b, h, s, dt, d=64):
    g = torch.Generator(device=dev).manual_seed(b + h + s + d)
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev, dtype=dt)
               for _ in range(3))
    do = torch.randn((b, s, h, d), generator=g, device=dev,
                     dtype=dt).transpose(1, 2)
    kw = dict(causal=True, q_offset=0, kv_offset=0, scale=d ** -0.5)
    with torch.no_grad():
        out, lse = A.flash_attention(q, k, v, causal=True)
        c = A.flash_bwd_prep(do, out)
        got = {"out": out,
               "dq": A._flash_bwd_dq_cuda(q, k, v, do, lse, c, **kw)}
        got["dk"], got["dv"] = A._flash_bwd_dkv_cuda(q, k, v, do, lse, c,
                                                     **kw)
        want = {"out": A.mha_reference(q, k, v, causal=True)[0],
                "dq": A.flash_bwd_dq_reference(q, k, v, do, lse, c, **kw)}
        want["dk"], want["dv"] = A.flash_bwd_dkv_reference(q, k, v, do, lse,
                                                           c, **kw)
        # the same arithmetic in f64 on the same inputs (the kernel's lse,
        # the f32 c)
        Q, K, V, DO = (t.double() for t in (q, k, v, do))
        S = (Q @ K.transpose(-1, -2) * kw["scale"]).masked_fill(
            A._causal_mask(s, s, 0, 0, dev), float("-inf"))
        P = torch.softmax(S, dim=-1)
        P2 = torch.exp(S - lse.double()[..., None])
        DS = P2 * (DO @ V.transpose(-1, -2) - c.double()[..., None])
        exact = {"out": P @ V, "dq": DS @ K * kw["scale"],
                 "dk": DS.transpose(-1, -2) @ Q * kw["scale"],
                 "dv": P2.transpose(-1, -2) @ DO}
    torch.cuda.synchronize()
    res = {n: row_errors(got[n], want[n], exact[n]) for n in got}
    diff = (out.float() - want["out"].float()).abs().flatten()
    j = int(diff.argmax())
    res["out_max_abs"] = [float(diff[j]), float(out.flatten()[j]),
                          float(want["out"].flatten()[j])]
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--batch", type=int, default=65536)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("dq_rows_probe: no CUDA device", file=sys.stderr)
        return 2
    from ddstore_tpu_torch.ops import _build
    from ddstore_tpu_torch.ops import attention as A
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    n = args.batch
    for b, h, s, dt in ((n, 1, 8, torch.float32), (1, n, 8, torch.float32),
                        (1024, 1, 8, torch.float32),
                        (2, 3, 8, torch.float32), (2, 3, 40, torch.float32),
                        (n, 1, 8, torch.bfloat16)):
        res = case(A, torch, dev, b, h, s, dt)
        print(f"rows {args.root} b,h,s,d={b},{h},{s},64 {dt} causal "
              f"{json.dumps(res)}", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
