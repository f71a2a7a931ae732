"""The corpus and the index orders, made from the seed.

Token ``p`` of the corpus's stream is a hash of ``(seed, p)``, so any
window can be made again on its own: the store's shards in set-up, and the
rows the index order named when the run is judged. Window ``i`` (a global
row of the store) holds tokens ``[i*S, (i+1)*S)`` of the stream and its
targets the next ``S`` tokens, ``[i*S+1, (i+1)*S+1)``.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser on int64 tensors holding values in
    [0, 2^32); products wrap in 64 bits and are cut back to 32."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def stream(seed: int, positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """Tokens (int32) at ``positions`` (int64, any shape) of the stream of
    ``seed``, uniform over ``[0, vocab)``."""
    lo, hi = seed & _M32, (seed >> 32) & _M32
    h = _fmix32((positions * 0x9E3779B1 + lo) & _M32)
    h = _fmix32(h ^ hi ^ 0x5BD1E995)
    return (h % vocab).to(torch.int32)


def windows(seed: int, rows: torch.Tensor, seq: int, vocab: int
            ) -> tuple:
    """(tokens, targets), each (len(rows), seq) int32 on ``rows``' device,
    of the global windows ``rows`` (int64)."""
    pos = rows.to(torch.int64)[:, None] * seq \
        + torch.arange(seq + 1, device=rows.device, dtype=torch.int64)
    toks = stream(seed, pos, vocab)
    return toks[:, :-1].contiguous(), toks[:, 1:].contiguous()


def shard(seed: int, begin: int, count: int, seq: int, vocab: int,
          device, chunk: int = 8192) -> tuple:
    """(tokens, targets) numpy int32 arrays (count, seq) of global windows
    ``[begin, begin + count)``, hashed on ``device`` in chunks of
    ``chunk`` windows and copied to the host."""
    toks = np.empty((count, seq), np.int32)
    tgts = np.empty((count, seq), np.int32)
    for lo in range(0, count, chunk):
        n = min(chunk, count - lo)
        rows = torch.arange(begin + lo, begin + lo + n, device=device)
        t, g = windows(seed, rows, seq, vocab)
        toks[lo:lo + n] = t.cpu().numpy()
        tgts[lo:lo + n] = g.cpu().numpy()
    return toks, tgts


def order(seed: int, total: int, kind: str) -> np.ndarray:
    """The global index order of a run: ``"random"`` a permutation of the
    ``total`` windows drawn from the seed, ``"sequential"`` the windows in
    turn from one drawn from the seed (a validation pass), wrapping."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.permutation(total).astype(np.int64)
    if kind == "sequential":
        start = int(rng.integers(total))
        return (start + np.arange(total, dtype=np.int64)) % total
    raise ValueError(f"unknown index order {kind!r}")
