"""In-process sample store (the port's ``DDStore``).

Semantics of the reference ``DDStore(SingleGroup(), backend="local")``
(``ddstore_tpu/store.py:188-1581``) for a one-process group: each member
of the group owns one shard of every registered variable, the global row
space is the concatenation of the shards in rank order, and any row is
read by its global index. Shards are held as numpy arrays in host memory;
the loader gathers from them into pinned buffers for the copy to the card.

The reference's native core (transports, replication, tiering) is not
part of this slice: a group of more than one process raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .rendezvous import ProcessGroup, SingleGroup

__all__ = ["DDStore", "DDStoreError", "ERR_INVALID_ARG", "ERR_OUT_OF_RANGE",
           "ERR_EXISTS"]

# Error codes of the reference's native core (``native/store.h:47-55``),
# kept so callers that branch on ``DDStoreError.code`` read the same
# numbers.
ERR_INVALID_ARG = -1
ERR_OUT_OF_RANGE = -3
ERR_EXISTS = -7
_MESSAGES = {ERR_INVALID_ARG: "invalid argument",
             ERR_OUT_OF_RANGE: "row range out of bounds",
             ERR_EXISTS: "variable already exists"}


class DDStoreError(RuntimeError):
    """A store operation the reference's core would refuse; ``code``
    carries the reference's error code."""

    def __init__(self, code: int, context: str = ""):
        self.code = code
        msg = _MESSAGES.get(code, f"error {code}")
        super().__init__(f"{context}: {msg}" if context else msg)


class _Var:
    __slots__ = ("shard", "sample_shape", "all_nrows")

    def __init__(self, shard: np.ndarray, all_nrows):
        self.shard = shard
        self.sample_shape = tuple(shard.shape[1:])
        self.all_nrows = list(all_nrows)


class DDStore:
    """Sample store over a process group (one process in this slice).
    :meth:`add` copies each shard into store-owned memory."""

    def __init__(self, group: Optional[ProcessGroup] = None):
        self.group = group if group is not None else SingleGroup()
        if self.group.size != 1:
            raise NotImplementedError(
                "multi-process DDStore: the port's store holds one "
                "process's shards; groups over torch.distributed come "
                "with the multi-process slice")
        self._vars: Dict[str, _Var] = {}
        self._closed = False

    # -- registration ------------------------------------------------------

    def add(self, name: str, arr: np.ndarray) -> None:
        """Register this rank's shard, sample-major: shape
        ``(nrows, *sample_shape)``; one global row is one sample."""
        if not name or any(ord(c) < 0x20 for c in name):
            raise ValueError(f"invalid variable name {name!r}")
        if name in self._vars:
            raise DDStoreError(ERR_EXISTS, f"add({name})")
        arr = np.asarray(arr)
        if arr.ndim == 0:
            raise ValueError("shard must have a leading sample dimension")
        shard = np.array(arr, order="C", copy=True)
        metas = self.group.allgather(
            (shard.shape[0], shard.dtype.str, shard.shape[1:]))
        self._vars[name] = _Var(shard, [m[0] for m in metas])
        self.barrier()

    # -- reads -------------------------------------------------------------

    def get(self, name: str, start: int, count: int = 1,
            out: Optional[np.ndarray] = None) -> np.ndarray:
        """Read ``count`` consecutive global rows from ``start``; the range
        must lie within one rank's shard."""
        v = self._require(name)
        out = self._check_out(name, v, out, count)
        begin, end = self.my_row_range(name)
        if start < begin or start >= end:
            raise DDStoreError(ERR_INVALID_ARG, f"get({name}, {start})")
        if start + count > end:
            raise DDStoreError(ERR_OUT_OF_RANGE, f"get({name}, {start})")
        out[...] = v.shard[start - begin:start - begin + count]
        return out

    def get_batch(self, name: str, indices,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
        """Read arbitrary global rows (duplicates and any order) into
        ``out`` (allocated when None)."""
        v = self._require(name)
        idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
        out = self._check_out(name, v, out, len(idx))
        if idx.size and (idx.min() < 0 or idx.max() >= len(v.shard)):
            raise DDStoreError(ERR_OUT_OF_RANGE, f"get_batch({name})")
        np.take(v.shard, idx, axis=0, out=out)
        return out

    # -- metadata ----------------------------------------------------------

    def total_rows(self, name: str) -> int:
        return int(sum(self._require(name).all_nrows))

    def local_rows(self, name: str) -> int:
        return int(self._require(name).all_nrows[self.rank])

    def my_row_range(self, name: str) -> Tuple[int, int]:
        """Global [begin, end) owned by this rank."""
        v = self._require(name)
        begin = int(sum(v.all_nrows[: self.rank]))
        return begin, begin + v.all_nrows[self.rank]

    def row_starts(self, name: str) -> np.ndarray:
        """Cumulative shard starts (length world + 1; the last entry is
        ``total_rows``)."""
        v = self._require(name)
        return np.concatenate(
            ([0], np.cumsum(np.asarray(v.all_nrows, np.int64))))

    def owner_of_rows(self, name: str, indices) -> np.ndarray:
        """Owning group rank of each global row index."""
        idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
        starts = self.row_starts(name)
        if idx.size and (idx.min() < 0 or idx.max() >= starts[-1]):
            raise IndexError(f"owner_of_rows({name}): index out of "
                             f"range [0, {int(starts[-1])})")
        return np.searchsorted(starts, idx, side="right") - 1

    def row_nbytes(self, name: str) -> int:
        """Bytes of one sample row."""
        v = self._require(name)
        return int(v.shard.dtype.itemsize
                   * int(np.prod(v.sample_shape, dtype=np.int64)))

    def sample_spec(self, name: str) -> Tuple[Tuple[int, ...], np.dtype]:
        """``(sample_shape, dtype)`` of a variable's rows."""
        v = self._require(name)
        return v.sample_shape, v.shard.dtype

    def variables(self):
        return sorted(self._vars)

    # -- sync / teardown ---------------------------------------------------

    def barrier(self) -> None:
        self.group.barrier()

    def free(self, name: Optional[str] = None) -> None:
        self.barrier()
        if name is None:
            self._vars.clear()
        else:
            self._vars.pop(name, None)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.barrier()
            self._vars.clear()

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def world(self) -> int:
        return self.group.size

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals ---------------------------------------------------------

    def _require(self, name: str) -> _Var:
        if name not in self._vars:
            raise KeyError(f"unknown variable {name!r}; registered: "
                           f"{self.variables()}")
        return self._vars[name]

    @staticmethod
    def _check_out(name: str, v: _Var, out: Optional[np.ndarray],
                   count: int) -> np.ndarray:
        want = (count,) + v.sample_shape
        if out is None:
            return np.empty(want, dtype=v.shard.dtype)
        if out.dtype != v.shard.dtype or tuple(out.shape) != want:
            raise ValueError(
                f"get({name}): out must be {want} {v.shard.dtype}, got "
                f"{tuple(out.shape)} {out.dtype}")
        return out
