"""Store-backed dataset adapter and the global index sampler (the port's
copy of ``ddstore_tpu/data/dataset.py:24-224``).

One global row is one sample; labels (for the LM: next-token targets)
are a co-variable fetched with the same indices. The sampler's index
order is identical to the reference's for the same ``(total, world,
rank, seed, epoch, drop_last, mode)``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..store import DDStore
from .permute import DENSE_MAX, FeistelPermutation

__all__ = ["nsplit", "ShardedDataset", "DistributedSampler"]


def nsplit(n: int, parts: int) -> list:
    """Row counts for splitting n rows into ``parts`` near-equal
    contiguous chunks."""
    base, rem = divmod(n, parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]


class ShardedDataset:
    """Partition a dataset across the store group and serve any sample.

    Each rank passes its FULL local copy (or its slice, with
    ``pre_sharded=True``) of ``data``/``labels``; the adapter registers
    this rank's contiguous chunk of both and serves global indices
    ``[0, total)``.
    """

    def __init__(self, store: DDStore, data: np.ndarray,
                 labels: Optional[np.ndarray] = None, name: str = "ds",
                 pre_sharded: bool = False):
        self.store = store
        self.name = name
        self._data_var = f"{name}/data"
        self._label_var = f"{name}/labels" if labels is not None else None

        if pre_sharded:
            shard = np.ascontiguousarray(data)
            lshard = None if labels is None else np.ascontiguousarray(labels)
        else:
            counts = nsplit(len(data), store.world)
            begin = int(sum(counts[: store.rank]))
            end = begin + counts[store.rank]
            shard = np.ascontiguousarray(data[begin:end])
            lshard = None if labels is None else np.ascontiguousarray(
                labels[begin:end])
        if labels is not None and len(shard) != len(lshard):
            raise ValueError("data/labels length mismatch")

        store.add(self._data_var, shard)
        if self._label_var:
            store.add(self._label_var, lshard)
        self._total = store.total_rows(self._data_var)

    def __len__(self) -> int:
        return self._total

    @property
    def data_var(self) -> str:
        return self._data_var

    @property
    def label_var(self) -> Optional[str]:
        return self._label_var

    def _vars(self) -> List[str]:
        return [self._data_var] + ([self._label_var]
                                   if self._label_var else [])

    def specs(self) -> List[Tuple[Tuple[int, ...], np.dtype]]:
        """``(sample_shape, dtype)`` of each array :meth:`fetch` returns,
        in order (what a caller preallocates to pass as ``out``)."""
        return [self.store.sample_spec(v) for v in self._vars()]

    def __getitem__(self, idx: int):
        got = [self.store.get(v, int(idx))[0] for v in self._vars()]
        return got[0] if len(got) == 1 else tuple(got)

    def fetch(self, indices: Sequence[int], out=None):
        """Batched fetch of the samples (and labels) at ``indices``. With
        ``out`` (an array, or a tuple shaped like the return value) the
        rows are gathered straight into the caller's buffers."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        names = self._vars()
        outs = [None] * len(names) if out is None else \
            ([out] if len(names) == 1 else list(out))
        got = [self.store.get_batch(v, idx, out=o)
               for v, o in zip(names, outs)]
        return got[0] if len(got) == 1 else tuple(got)

    def free(self) -> None:
        for v in self._vars():
            self.store.free(v)


class DistributedSampler:
    """Deterministic per-epoch partition of the global index space: rank r
    draws indices r, r+world, ... of a seeded permutation, padded by
    wrapping so every rank yields the same count.

    ``mode="dense"`` materializes ``np.random.default_rng((seed,
    epoch)).permutation``; ``mode="streamed"`` evaluates a Feistel
    bijection in ``block``-sized chunks; ``"auto"`` streams above
    ``DENSE_MAX`` rows.
    """

    DENSE_MAX = DENSE_MAX

    def __init__(self, total: int, world: int, rank: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, mode: str = "auto",
                 block: int = 1 << 20):
        if not 0 <= rank < world:
            raise ValueError("rank out of range")
        if mode not in ("auto", "dense", "streamed"):
            raise ValueError(f"unknown mode: {mode!r}")
        self.total = total
        self.world = world
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.block = block
        self.mode = mode
        if drop_last:
            self.num_samples = total // world
        else:
            self.num_samples = (total + world - 1) // world

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def _streamed(self) -> bool:
        return self.mode == "streamed" or (self.mode == "auto"
                                           and self.total > self.DENSE_MAX)

    def _stream_blocks(self, start: int, stop: int):
        """This rank's indices for global positions [start, stop), in
        O(block) memory. Position p maps to perm(p % total): the same
        wrap padding as the dense path's np.resize tiling."""
        perm = FeistelPermutation(self.total, (self.seed, self.epoch)) \
            if self.shuffle else None
        for lo in range(start, stop, self.block * self.world):
            hi = min(stop, lo + self.block * self.world)
            pos = np.arange(lo + self.rank, hi, self.world,
                            dtype=np.int64) % self.total
            yield perm(pos) if perm is not None else pos

    def __iter__(self):
        if self._streamed():
            def gen():
                for chunk in self._stream_blocks(
                        0, self.num_samples * self.world):
                    yield from chunk.tolist()
            return gen()
        if self.shuffle:
            g = np.random.default_rng((self.seed, self.epoch))
            order = g.permutation(self.total)
        else:
            order = np.arange(self.total)
        if self.drop_last:
            order = order[: self.num_samples * self.world]
        else:
            order = np.resize(order, self.num_samples * self.world)
        return iter(order[self.rank:: self.world])

    def batches(self, batch_size: int):
        """This rank's epoch as consecutive index arrays of
        ``batch_size`` (the last batch may be short)."""
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got "
                             f"{batch_size}")

        def chunks():
            if self._streamed():
                yield from self._stream_blocks(
                    0, self.num_samples * self.world)
            else:
                yield self.epoch_indices()

        carry = np.empty((0,), np.int64)
        for c in chunks():
            carry = c if carry.size == 0 else np.concatenate([carry, c])
            while carry.size >= batch_size:
                yield carry[:batch_size]
                carry = carry[batch_size:]
        if carry.size:
            yield carry

    def epoch_indices(self) -> np.ndarray:
        """This rank's full epoch as one array."""
        if self._streamed():
            chunks = list(self._stream_blocks(
                0, self.num_samples * self.world))
            return np.concatenate(chunks) if chunks else \
                np.empty((0,), np.int64)
        return np.fromiter(iter(self), dtype=np.int64,
                           count=self.num_samples)
