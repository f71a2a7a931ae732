"""Overload-safe serving gateway — the client side (the port of
``ddstore_tpu/gateway``).

The native side (native/gateway.cc) multiplexes ephemeral readers onto
each rank's existing TCP framing: a reader ``attach``es with a tenant
label over the dedicated control connection (kOpAttach), receives a
session token backed by a heartbeat-renewed lease, and its reads share
the rank's striped lane pools under the tenant's QoS budget. An
admission gate in front of Get/GetBatch/ReadRuns consults the live
latency histograms + tenant SLOs: when a protected tenant's predicted
p99 approaches its objective, over-share tenants are deferred in a
bounded queue and then refused with the non-fatal ``ERR_ADMISSION``
carrying a retry-after hint. Lease expiry — a reader SIGKILLed
mid-session, a dropped control connection — atomically releases the
session's snapshot pins, quota reservation and lane-budget share
within O(lease). ``drain()`` stops admitting, lets in-flight reads
finish under a deadline and sheds the rest.

This package is the Python session object over that machinery:
:class:`GatewaySession` attaches, renews the lease from a daemon
thread, retries ``ERR_ADMISSION`` with seeded-jitter backoff honoring
the server's retry-after hint (bounded by ``DDSTORE_GW_RETRY_MAX``),
and releases everything on ``close()``/``__exit__``. Everything is
inert unless ``DDSTORE_GATEWAY=1`` (default off: byte-, error-code-
and seeded-fault-counter-identical to the ungated tree).

Environment: ``DDSTORE_GATEWAY``, ``DDSTORE_GW_LEASE_MS``,
``DDSTORE_GW_DEFER_MS``, ``DDSTORE_GW_QUEUE``,
``DDSTORE_GW_ADMIT_MARGIN``, ``DDSTORE_GW_LANE_SHARE``,
``DDSTORE_GW_RETRY_MAX``, ``DDSTORE_SNAP_PIN_TTL_MS``. See README
"Serving gateway".
"""

from __future__ import annotations

from .session import GatewaySession

__all__ = ["GatewaySession"]
