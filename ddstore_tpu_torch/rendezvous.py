"""Process groups for the control plane (the port's copy of
``ddstore_tpu/rendezvous.py:33-66``).

A :class:`ProcessGroup` gives ``rank``/``size``/``allgather``/``barrier``/
``split``/``broadcast``. Only setup-time metadata moves through it; the
data plane reads shards directly. This slice carries the one-process
:class:`SingleGroup`; groups over ``torch.distributed`` come with the
multi-process store.
"""

from __future__ import annotations

from typing import Any, List

__all__ = ["ProcessGroup", "SingleGroup"]


class ProcessGroup:
    """Abstract control-plane group."""

    rank: int
    size: int

    def allgather(self, obj: Any) -> List[Any]:
        raise NotImplementedError

    def barrier(self) -> None:
        self.allgather(None)

    def split(self, color: int) -> "ProcessGroup":
        """Partition into subgroups of ranks sharing ``color``; rank order
        within a subgroup follows parent rank order."""
        raise NotImplementedError

    def broadcast(self, obj: Any, root: int = 0) -> Any:
        return self.allgather(obj)[root]


class SingleGroup(ProcessGroup):
    def __init__(self):
        self.rank = 0
        self.size = 1

    def allgather(self, obj: Any) -> List[Any]:
        return [obj]

    def split(self, color: int) -> "ProcessGroup":
        return SingleGroup()
