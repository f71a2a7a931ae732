"""The yardstick's arithmetic for ``moonlight-16b-a3b``: the model FLOPs of
a train step of DeepSeek-V3's block at its true widths, the bound of each
flash kernel at latent attention's (192, 128) head dims, and the bound of
the held experts' products. The peaks are ``arith.py``'s; nothing here
imports torch or the program.
"""

from __future__ import annotations

from typing import Dict

from .arith import HBM_BYTES_PER_S, PEAK_FLOPS, bound_of, live_pairs

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def widths(m: Dict) -> tuple:
    """(d_qk, d_v) of a head."""
    return m["qk_nope"] + m["qk_rope"], m["v_dim"]


def forward_flops(m: Dict, rows: int, seq: int, held_assignments: float
                  ) -> float:
    """Model FLOPs of one forward over (rows, seq) tokens: every layer's
    projections (q, kv_a, kv_b, the output), causal attention (2 x live
    pairs x heads x (d_qk + d_v)), the dense layers' SwiGLU, the expert
    layers' router and shared experts, ``held_assignments`` (summed over
    the expert layers) through one routed SwiGLU each, and the head."""
    t = rows * seq
    d, nh = m["dim"], m["heads"]
    dqk, dv = widths(m)
    proj = 2 * t * (d * nh * dqk + d * (m["kv_rank"] + m["qk_rope"])
                    + m["kv_rank"] * nh * (m["qk_nope"] + dv) + nh * dv * d)
    attn = 2.0 * rows * live_pairs(seq, seq, True) * nh * (dqk + dv)
    dense = 6 * t * d * m["dense_hidden"]
    moe = 2 * t * d * m["experts"] \
        + 6 * t * d * m["shared"] * m["expert_hidden"]
    n_dense = m["dense_layers"]
    n_moe = m["layers"] - n_dense
    routed = 6.0 * held_assignments * d * m["expert_hidden"]
    head = 2 * t * d * m["vocab"]
    return float(m["layers"] * (proj + attn) + n_dense * dense
                 + n_moe * moe + routed + head)


def flops_per_step(m: Dict, rows: int, seq: int, held_assignments: float
                   ) -> float:
    """The forward and a backward of twice its FLOPs (no recomputation)."""
    return 3 * forward_flops(m, rows, seq, held_assignments)


def flash_bounds_ms(m: Dict, rows: int, seq: int) -> Dict[str, float]:
    """The bound of one launch of each flash kernel at the true widths:
    the forward 2 x pairs x H x (d_qk + d_v) FLOPs, dq 2 x pairs x H x
    (2 d_qk + d_v), dk/dv 2 x pairs x H x (2 d_qk + 2 d_v); each input read
    once and each output written once, lse and c in f32."""
    dt = m["compute_dtype"]
    it = _ITEMSIZE[dt]
    nh = m["heads"]
    dqk, dv = widths(m)
    pairs = rows * nh * live_pairs(seq, seq, True)
    rows_h = rows * nh * seq
    work = {"fwd": (2 * dqk + 2 * dv, rows_h * ((2 * dqk + 2 * dv) * it
                                                 + 4)),
            "dq": (4 * dqk + 2 * dv, rows_h * ((3 * dqk + 2 * dv) * it
                                                + 8)),
            "dkv": (4 * dqk + 4 * dv, rows_h * ((3 * dqk + 3 * dv) * it
                                                 + 8))}
    return {k: bound_of(float(pairs * f), nbytes, dt)[0]
            for k, (f, nbytes) in work.items()}


def expert_bound_ms(m: Dict, held_assignments: float) -> float:
    """The bound of the held experts' products over ``held_assignments``
    (summed over the expert layers) in a train step: the forward's gate,
    up and down products (6 N d h FLOPs) and the backward's twice that, at
    the compute dtype's peak, or the weights' and the assignments' bytes
    at the memory's rate where that is longer."""
    dt = m["compute_dtype"]
    d, h = m["dim"], m["expert_hidden"]
    flops = 18.0 * held_assignments * d * h
    n_moe = m["layers"] - m["dense_layers"]
    nbytes = n_moe * m["held"][1] * 3 * d * h * _ITEMSIZE[dt] * 3 \
        + held_assignments * (d + 2 * h) * _ITEMSIZE[dt] * 3
    return max(flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S) * 1e3
