"""The host path's side of the bytes-moved ledger (the port's copy of
``host_bytes_over_dcn``, ``ddstore_tpu/data/device_fetch.py:195``). The
device-collective fetch over NCCL comes with a later slice."""

from __future__ import annotations

import numpy as np

__all__ = ["host_bytes_over_dcn"]


def host_bytes_over_dcn(store, name: str, indices) -> int:
    """Bytes the host path pulls over the network transport for this
    batch: every requested row whose owner is another rank (local rows
    never leave the host)."""
    idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
    if idx.size == 0:
        return 0
    owner = store.owner_of_rows(name, idx)
    return int((owner != store.rank).sum()) * store.row_nbytes(name)
