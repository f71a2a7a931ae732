"""Multi-tenant store service layer (the port of ``ddstore_tpu/tenant``).

The store becomes a long-lived shared service: a trainer, an eval job,
and an inference reader ``attach()`` to the SAME resident shards
concurrently, each through a :class:`TenantHandle` that composes the
primitives the engine already has —

* **namespaces** over the one native variable registry (scoped
  ``"\\x02<tenant>\\x02<name>"`` names; the default tenant ``""`` is the
  bare name, keeping the whole pre-tenancy tree byte- and
  error-code-identical),
* **quotas + admission control** (a native byte/var budget checked
  atomically at registration — ``ERR_QUOTA``, a distinct non-fatal
  class — plus weighted shares on the async admission gate),
* **QoS lane budgets** (share-weighted caps on the striped-lane width a
  tenant's reads engage, planned by the cost-model scheduler as
  additional cells rather than a new tuner), and
* **read-only snapshot epochs** (``attach(snapshot=True)`` pins every
  shard's current content version; the owner's ``update`` + epoch fence
  publishes new versions while snapshot readers keep serving the pinned
  ones — copy-on-publish kept versions for updated shards only,
  reclaimed at last detach). This is what makes the paper's ``update``
  path a safe ONLINE write API.

Environment: ``DDSTORE_TENANT_QUOTAS="t=bytes[:vars],..."``,
``DDSTORE_TENANT_SHARES="t=weight,..."`` (runtime setters exist too).
See README "Multi-tenant service".
"""

from __future__ import annotations

from typing import Dict, Tuple

from .handle import (SNAP_PREFIX, TENANT_SEP, TenantHandle, scoped_name,
                     snapshot_name)

__all__ = ["TenantHandle", "TENANT_SEP", "SNAP_PREFIX", "scoped_name",
           "snapshot_name", "parse_quota_spec", "parse_share_spec",
           "share_split"]


def parse_quota_spec(spec: str) -> Dict[str, Tuple[int, int]]:
    """``DDSTORE_TENANT_QUOTAS`` parser (mirrors the native one):
    ``"t=bytes[:vars],..."`` -> ``{tenant: (max_bytes, max_vars)}``
    with -1 = unlimited. Malformed entries are skipped, like the
    native side — config parsing never fails construction."""
    out: Dict[str, Tuple[int, int]] = {}
    for entry in (spec or "").split(","):
        if "=" not in entry:
            continue
        tenant, _, val = entry.partition("=")
        if not tenant or any(ord(c) < 0x20 for c in tenant):
            continue  # control chars collide with the native formats
        nbytes, _, nvars = val.partition(":")
        try:
            out[tenant] = (int(nbytes), int(nvars) if nvars else -1)
        except ValueError:
            continue
    return out


def parse_share_spec(spec: str) -> Dict[str, int]:
    """``DDSTORE_TENANT_SHARES`` parser: ``"t=weight,..."`` ->
    ``{tenant: weight}`` (weights >= 1; malformed entries skipped)."""
    out: Dict[str, int] = {}
    for entry in (spec or "").split(","):
        if "=" not in entry:
            continue
        tenant, _, val = entry.partition("=")
        if not tenant or any(ord(c) < 0x20 for c in tenant):
            continue  # control chars collide with the native formats
        try:
            w = int(val)
        except ValueError:
            continue
        if w >= 1:
            out[tenant] = w
    return out


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
