"""Both packages' store services side by side, for the parity tests of
the port's checkpoint, profile, elastic, obs, tenant and gateway
modules.

``PKGS["jax"]`` and ``PKGS["torch"]`` expose the same names (the store,
its groups and errors, the binding's trace and fault controls, ``obs``,
the tenant helpers, the gateway session, ``PipelineMetrics``, the
readahead engine, the scheduler, the shard checkpoint functions), so one
test body runs against each package and the two results are compared.
The native cores are separate libraries, so their process-global state
(the fault injector, the trace rings) is separate too."""

import uuid
from types import SimpleNamespace

import ddstore_tpu as _r
import ddstore_tpu_torch as _t
from ddstore_tpu import binding as _rb
from ddstore_tpu import gateway as _rg
from ddstore_tpu import obs as _ro
from ddstore_tpu import tenant as _rt
from ddstore_tpu.data.readahead import EpochReadahead as _RRa
from ddstore_tpu.sched.planner import Scheduler as _RSched
from ddstore_tpu.utils import checkpoint as _rck
from ddstore_tpu.utils.metrics import PipelineMetrics as _RPm
from ddstore_tpu_torch import binding as _tb
from ddstore_tpu_torch import gateway as _tg
from ddstore_tpu_torch import obs as _to
from ddstore_tpu_torch import rendezvous as _trdv
from ddstore_tpu_torch import tenant as _tt
from ddstore_tpu_torch.data.readahead import EpochReadahead as _TRa
from ddstore_tpu_torch.sched.planner import Scheduler as _TSched
from ddstore_tpu_torch.utils import checkpoint as _tck
from ddstore_tpu_torch.utils.metrics import PipelineMetrics as _TPm
from torch_workers import run_threads


def _ns(name, store_mod, binding, obs, tenant, gateway, pm, ra, sched, ck,
        groups):
    return SimpleNamespace(
        name=name, DDStore=store_mod.DDStore,
        DDStoreError=binding.DDStoreError, ThreadGroup=groups.ThreadGroup,
        FileGroup=groups.FileGroup, fault_configure=binding.fault_configure,
        binding=binding, obs=obs, tenant=tenant,
        GatewaySession=gateway.GatewaySession, PipelineMetrics=pm,
        EpochReadahead=ra, Scheduler=sched, save_shard=ck.save_shard,
        load_shard=ck.load_shard)


PKGS = {
    "jax": _ns("jax", _r, _rb, _ro, _rt, _rg, _RPm, _RRa, _RSched, _rck, _r),
    "torch": _ns("torch", _t, _tb, _to, _tt, _tg, _TPm, _TRa, _TSched,
                 _tck, _trdv),
}


def both(fn, *args, **kw):
    """``fn(P, *args, **kw)`` for each package: ``(jax's, torch's)``."""
    return tuple(fn(PKGS[k], *args, **kw) for k in ("jax", "torch"))


def run_group(P, world, fn, timeout=120):
    """``fn(rank, group)`` on ``world`` threads, each with its member of
    one ThreadGroup of package ``P``; the results by rank."""
    name = uuid.uuid4().hex
    return run_threads(world,
                       lambda r: fn(r, P.ThreadGroup(name, r, world)),
                       timeout=timeout)


def run_pair(P, body0, rows, dim, world=2):
    """A two-rank ThreadGroup TCP store of package ``P`` whose rank r's
    shard of "v" is all (r + 1) in float32; rank 0 runs ``body0(store)``
    and its result is returned."""
    import numpy as np

    def member(rank, group):
        with P.DDStore(group, backend="tcp") as s:
            s.add("v", np.full((rows, dim), rank + 1, np.float32))
            out = body0(s) if rank == 0 else None
            s.barrier()
            return out

    return run_group(P, world, member, timeout=180)[0]
