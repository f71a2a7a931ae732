"""The yardstick's arithmetic: the H100's published peaks, the model FLOPs
of a step, and the operations and bytes of each flash kernel.

Frozen copies of ``chip_smoke.py``'s ``lm_flops_per_step``,
``live_pairs``, ``attention_work`` and ``bound_of`` (and its peaks), so
that a later change to the program cannot move the yardstick. Nothing
here imports torch or the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float16": PEAK_BF16_FLOPS,
              "float32": 67e12, "tf32": 495e12, "float64": 67e12}


def lm_forward_flops(vocab: int, dim: int, layers: int, b: int, s: int
                     ) -> float:
    """Model FLOPs of one forward of the GPT block LM over (b, s) tokens:
    the matmuls (qkv 6Td^2, proj 2Td^2, MLP 16Td^2 a layer, head 2TdV)
    and causal attention (2bs^2d a layer)."""
    t = b * s
    return float(layers * (24 * t * dim * dim + 2 * b * s * s * dim)
                 + 2 * t * dim * vocab)


def lm_flops_per_step(vocab: int, dim: int, layers: int, b: int, s: int
                      ) -> float:
    """Model FLOPs of one train step: the forward, and a backward of twice
    the forward's (``chip_smoke.py``'s ``lm_flops_per_step``)."""
    return 3 * lm_forward_flops(vocab, dim, layers, b, s)


def live_pairs(sq: int, sk: int, causal: bool, q_offset: int = 0,
               kv_offset: int = 0) -> int:
    """Score pairs (query, key) the causal mask leaves live: row i sees
    keys j with kv_offset + j <= q_offset + i."""
    if not causal:
        return sq * sk
    if q_offset == kv_offset and sq == sk:
        return sq * (sq + 1) // 2
    return sum(min(sk, max(0, q_offset + i - kv_offset + 1))
               for i in range(sq))


def attention_work(b: int, h: int, sq: int, sk: int, d: int, itemsize: int,
                   causal: bool, kind: str = "fwd", q_offset: int = 0,
                   kv_offset: int = 0) -> Tuple[float, float]:
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
    nbytes = float(b * h * ((rows_q + rows_k) * d * itemsize + f32_rows * 4))
    return flops, nbytes


def bound_of(flops: float, nbytes: float, dname: str = "bfloat16"
             ) -> Tuple[float, str]:
    """(bound ms, what bounds it) on the H100 SXM's published peaks, the
    operations at the peak of dtype ``dname``."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def flash_bounds_ms(model: Dict, rows: int, seq: int) -> Dict[str, float]:
    """The bound of one launch of each flash kernel at a cell's shapes:
    ``{"fwd", "dq", "dkv"}`` -> ms. The LM's attention is causal over the
    whole row, one launch a layer and a pass, (rows, heads, seq, hd) in
    the model's compute dtype."""
    dt = model["compute_dtype"]
    hd = model["dim"] // model["heads"]
    out = {}
    for kind in ("fwd", "dq", "dkv"):
        flops, nbytes = attention_work(rows, model["heads"], seq, seq, hd,
                                       _ITEMSIZE[dt], True, kind)
        out[kind] = bound_of(flops, nbytes, dt)[0]
    return out
