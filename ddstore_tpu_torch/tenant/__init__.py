"""Multi-tenant service layer of the port (``ddstore_tpu/tenant``).

For now it holds the pure helper the cost-model scheduler needs,
``share_split``. The tenant handles (``TenantHandle``: namespaces,
quotas, QoS shares, snapshot epochs) come with the store's tenant
setters; until then the scheduler's tenant branch stays inert, since no
tenant has a configured share.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["share_split"]


def share_split(total: int, shares: Dict[str, int]) -> Dict[str, int]:
    """Weighted split of an integer resource (async width, lane count)
    across tenants: ``max(1, total * share / sum)`` each — every tenant
    always makes progress, exactly the native admission gate's rule, so
    the planner's exported budgets and the gate's enforcement agree."""
    if not shares:
        return {}
    s = sum(shares.values()) or 1
    return {t: max(1, min(int(total), (int(total) * w) // s))
            for t, w in shares.items()}
