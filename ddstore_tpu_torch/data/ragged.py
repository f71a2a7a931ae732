"""Ragged-batch utilities (the port of ``ddstore_tpu/data/ragged.py``):
pack and pad variable-length samples into static shapes.

Numpy only. :meth:`ddstore_tpu_torch.store.DDStore.get_ragged_batch`
returns ``(values, lengths)`` and these functions lower them to dense
padded arrays + masks/segment ids, so a device step sees one fixed
``max_len``/``budget`` regardless of per-batch raggedness.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["pad_ragged", "split_ragged", "segment_ids_from_lengths",
           "pack_ragged"]


def split_ragged(values: np.ndarray, lengths: np.ndarray) -> list:
    """Inverse of concatenation: list of per-sample arrays (views)."""
    out, pos = [], 0
    for l in lengths:
        out.append(values[pos:pos + int(l)])
        pos += int(l)
    return out


def pad_ragged(values: np.ndarray, lengths: np.ndarray, max_len: int,
               pad_value=0) -> Tuple[np.ndarray, np.ndarray]:
    """Dense ``(batch, max_len, *item)`` + boolean mask ``(batch, max_len)``.

    Samples longer than ``max_len`` are truncated (caller picks ``max_len``
    as a dataset-level bound so truncation is the explicit overflow policy,
    not a silent one).
    """
    lengths = np.asarray(lengths, np.int64)
    b = len(lengths)
    item = values.shape[1:]
    out = np.full((b, max_len) + item, pad_value, dtype=values.dtype)
    mask = np.zeros((b, max_len), np.bool_)
    pos = 0
    for i, l in enumerate(lengths):
        l = int(l)
        keep = min(l, max_len)
        out[i, :keep] = values[pos:pos + keep]
        mask[i, :keep] = True
        pos += l
    return out, mask


def segment_ids_from_lengths(lengths: np.ndarray, total: int,
                             pad_segment: Optional[int] = None
                             ) -> np.ndarray:
    """Flat segment ids for segment-sum (``index_add_``) aggregation:
    element j of sample i gets id i; positions past the real elements get
    ``pad_segment`` (default ``len(lengths)``, i.e. one trash segment)."""
    lengths = np.asarray(lengths, np.int64)
    n = int(lengths.sum())
    if total < n:
        raise ValueError(f"total {total} < sum(lengths) {n}")
    if pad_segment is None:
        pad_segment = len(lengths)
    ids = np.full(total, pad_segment, np.int32)
    ids[:n] = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
    return ids


def pack_ragged(values: np.ndarray, lengths: np.ndarray, budget: int,
                pad_value=0):
    """Pack concatenated samples into a fixed element ``budget`` (the
    graph-batching scheme: one flat buffer + segment ids, no per-sample
    padding waste). Returns ``(flat, segment_ids, n_fit)`` where ``flat``
    has exactly ``budget`` element rows, ``segment_ids`` marks sample
    membership (padding rows get segment ``len(lengths)``), and ``n_fit``
    is how many whole samples fit — callers requeue the remainder.
    """
    lengths = np.asarray(lengths, np.int64)
    cum = np.cumsum(lengths)
    n_fit = int(np.searchsorted(cum, budget, side="right"))
    if n_fit == 0 and len(lengths):
        # A requeue-the-remainder caller would spin forever on this sample.
        raise ValueError(
            f"pack_ragged: first sample ({int(lengths[0])} elements) "
            f"exceeds budget {budget}")
    used = int(cum[n_fit - 1]) if n_fit else 0
    item = values.shape[1:]
    flat = np.full((budget,) + item, pad_value, dtype=values.dtype)
    flat[:used] = values[:used]
    seg = segment_ids_from_lengths(lengths[:n_fit], budget,
                                   pad_segment=n_fit)
    return flat, seg, n_fit
