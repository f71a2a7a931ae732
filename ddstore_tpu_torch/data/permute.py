"""O(1)-memory seeded index permutations (the port's copy of
``ddstore_tpu/data/permute.py``).

A Feistel network over the index bits is a deterministic seeded
bijection on ``[0, n)``: ``perm(i)`` for any ``i`` in O(1) memory,
vectorized over blocks, so the sampler streams an epoch instead of
allocating it.

Construction: split the index into two halves of ``k`` bits (domain
``4^k`` is the smallest power of 4 >= n), run a 4-round Feistel with a
splitmix-style round function keyed per round from the seed, and
cycle-walk any output >= n back through the network (walk length is
geometric with mean < 4 since the domain is < 4n). The numbers are
identical to the reference's for the same ``(n, seed)``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["FeistelPermutation", "DENSE_MAX"]

# Below this row count a materialized np.permutation is cheap (128 MB of
# int64 at the threshold); above it the Feistel bijection evaluates
# slices on demand.
DENSE_MAX = 1 << 24

_M1 = np.uint64(0x9E3779B97F4A7C15)
_M2 = np.uint64(0xBF58476D1CE4E5B9)
_M3 = np.uint64(0x94D049BB133111EB)


def _mix(x: np.ndarray, key: np.uint64) -> np.ndarray:
    """splitmix64-style avalanche of x under key (vectorized uint64)."""
    x = (x + key) * _M1
    x ^= x >> np.uint64(29)
    x *= _M2
    x ^= x >> np.uint64(32)
    x *= _M3
    x ^= x >> np.uint64(31)
    return x


class FeistelPermutation:
    """Seeded bijection on ``[0, n)``; ``perm(idx)`` is vectorized and
    allocates only O(len(idx))."""

    def __init__(self, n: int, seed, rounds: int = 4):
        if n <= 0:
            raise ValueError(f"n must be positive, got {n}")
        self.n = int(n)
        k = 1
        while (1 << (2 * k)) < self.n:
            k += 1
        self._k = np.uint64(k)
        self._mask = np.uint64((1 << k) - 1)
        g = np.random.default_rng(seed)
        self._keys = [np.uint64(v) for v in
                      g.integers(0, 1 << 63, size=rounds, dtype=np.int64)]

    def _walk_once(self, x: np.ndarray) -> np.ndarray:
        l, r = x >> self._k, x & self._mask
        for key in self._keys:
            l, r = r, l ^ (_mix(r, key) & self._mask)
        return (l << self._k) | r

    def __call__(self, idx) -> np.ndarray:
        x = np.asarray(idx, dtype=np.uint64)
        scalar = x.ndim == 0
        x = np.atleast_1d(x)
        if x.size and int(x.max()) >= self.n:
            raise IndexError(f"index out of range for permutation over "
                             f"[0, {self.n})")
        out = self._walk_once(x)
        bad = out >= self.n
        while bad.any():
            out[bad] = self._walk_once(out[bad])
            bad = out >= self.n
        res = out.astype(np.int64)
        return res[0] if scalar else res
