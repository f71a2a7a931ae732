"""Spawned worlds for the port's multi-process tests: ``spawn`` starts
``world`` processes with the ``spawn`` context, each running
``target(rank, world, tmp, *args)``, and returns their results by rank;
a rank that raises fails the test with its traceback. The rank functions
here import only the port (and numpy/torch), so the children start
without jax. ``torch_world`` brings up a gloo ``torch.distributed`` job
through a rendezvous file under ``tmp``."""

import multiprocessing as mp
import os
import threading
import traceback

import numpy as np


def spawn(world, target, tmp, *args, timeout=240):
    from ddstore_tpu_torch import _build

    _build.build()  # here, not in every rank
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_run, args=(q, target, r, world, tmp) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    try:
        for _ in range(world):
            rank, ok, value = q.get(timeout=timeout)
            (results if ok else errors)[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    assert not errors, f"rank failures: {errors}"
    return [results[r] for r in range(world)]


def run_threads(world, fn):
    """Run ``fn(rank)`` on ``world`` threads (the ranks of a
    ``ThreadGroup``); their results by rank. A failing rank fails the
    test."""
    out, errs = [None] * world, []

    def member(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append((r, e))

    ts = [threading.Thread(target=member, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errs, errs
    return out


def _run(q, target, rank, world, tmp, *args):
    os.environ["DDSTORE_HOST"] = "127.0.0.1"
    os.environ["OMP_NUM_THREADS"] = "1"  # several ranks share the cores
    try:
        q.put((rank, True, target(rank, world, tmp, *args)))
    except Exception:  # noqa: BLE001 — the parent reports it
        q.put((rank, False, traceback.format_exc()))


def torch_world(rank, world, tmp):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=world)
    return dist


def shard(rank, num=32, dim=16, seed=0):
    """This rank's shard: random float64 rows whose first column is the
    owning rank + 1 (the rank stamp)."""
    rows = np.random.default_rng((seed, rank)).normal(size=(num, dim))
    rows[:, 0] = rank + 1
    return rows


def read_all(store, name, world, num, seed):
    """Every kind of read a store serves, over rows of every rank: the
    batches as bytes, and the rank stamps they carry."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, world * num, size=200)
    idx[:3] = [world * num - 1, 0, 0]
    got = [store.get_batch(name, idx).tobytes()]
    out = np.empty((len(idx), store.row_nbytes(name) // 8))
    store.get_batch(name, idx, out=out)
    got.append(out.tobytes())
    got.append(store.get_batch_async(name, idx[::-1]).wait().tobytes())
    for r in range(world):
        got.append(store.get(name, r * num + 2, 5).tobytes())
    stamps = store.get_batch(name, idx)[:, 0]
    assert (stamps == idx // num + 1).all(), "rank stamps"
    return got


def tcp_parity(rank, world, tmp, wire, num=32):
    """A JAX-package store and a port store open side by side in one
    process, each over TCP (``DDSTORE_TRANSPORT=wire``) with its own
    file rendezvous, fed the same shards: the bytes each serves to this
    rank."""
    os.environ["DDSTORE_TRANSPORT"] = wire
    import ddstore_tpu as ref

    from ddstore_tpu_torch import rendezvous
    from ddstore_tpu_torch.store import DDStore

    stores = {
        "ref": ref.DDStore(ref.FileGroup(os.path.join(tmp, "ref"), rank,
                                         world), backend="tcp"),
        "port": DDStore(rendezvous.FileGroup(os.path.join(tmp, "port"),
                                             rank, world), backend="tcp")}
    try:
        for s in stores.values():
            s.add("v", shard(rank, num))
            s.init("z", num, (4,), np.int32)
            s.update("z", np.full((num, 4), rank + 7, np.int32))
            s.barrier()
        return {key: (read_all(s, "v", world, num, seed=rank),
                      s.get_batch("z", np.arange(world * num)[::-1])
                      .tobytes(), s.transport_facts()["wire"])
                for key, s in stores.items()}
    finally:
        for s in stores.values():
            s.close()


def torch_group_ops(rank, world, tmp):
    """TorchGroup's collectives over gloo: allgather, barrier, split,
    broadcast."""
    from ddstore_tpu_torch.rendezvous import TorchGroup

    dist = torch_world(rank, world, tmp)
    try:
        g = TorchGroup()
        out = {"rank": g.rank, "size": g.size,
               "gathered": g.allgather(("r", rank, {"x": [rank]}))}
        g.barrier()
        sub = g.split(rank % 2)
        out["sub"] = (sub.rank, sub.size, sub.allgather(rank * 10))
        out["bcast"] = g.broadcast(f"from{rank}", root=world - 1)
        return out
    finally:
        dist.destroy_process_group()


def pod_bootstrap_rank(rank, world, tmp, port):
    """pod_bootstrap from an explicit coordinator (gloo without CUDA)."""
    from ddstore_tpu_torch import rendezvous

    env = {"DDSTORE_COORDINATOR": f"127.0.0.1:{port}",
           "DDSTORE_NUM_PROCESSES": str(world),
           "DDSTORE_PROCESS_ID": str(rank)}
    g = rendezvous.pod_bootstrap(env=env, timeout=60)
    import torch.distributed as dist

    try:
        again = rendezvous.pod_bootstrap(env=env)  # already up: untouched
        return (type(g).__name__, g.rank, g.size, g.allgather(rank),
                type(rendezvous.auto_group()).__name__, again.size)
    finally:
        dist.destroy_process_group()


def store_and_collectives_interleave(rank, world, tmp, rows=64, dim=8):
    """Remote reads of a TCP store over a TorchGroup, each followed by a
    gloo all-reduce, with store barriers between."""
    import torch

    from ddstore_tpu_torch.rendezvous import TorchGroup
    from ddstore_tpu_torch.store import DDStore

    dist = torch_world(rank, world, tmp)
    store = DDStore(TorchGroup(), backend="tcp")
    try:
        store.add("v", np.full((rows, dim), rank + 1, np.float64))
        rng = np.random.default_rng(rank)
        for it in range(25):
            idx = rng.integers(0, world * rows, size=16)
            got = store.get_batch("v", idx)
            assert (got == (idx // rows + 1)[:, None]).all(), it
            x = torch.full((8, 4), float(rank + it))
            dist.all_reduce(x)
            assert float(x[0, 0]) == sum(r + it for r in range(world)), it
            if it % 5 == 0:
                store.barrier()
        return store.fault_stats()["retry_giveups"]
    finally:
        store.close()
        dist.destroy_process_group()


def vae_ddp_step(rank, world, tmp, params, batch, eps):
    """One data-parallel train step of the port's f32 VAE on this rank's
    slice of ``batch`` and ``eps``: (loss, gradients, parameters after the
    step), the trees as ``weights.to_flax`` gives them."""
    import torch

    from ddstore_tpu_torch import weights
    from ddstore_tpu_torch.models import vae

    dist = torch_world(rank, world, tmp)
    try:
        model = vae.VAE(compute_dtype=torch.float32, device="cpu")
        weights.from_flax(params, model)
        _, opt = vae.create_train_state(model)
        step = vae.make_train_step(model, opt, group=dist.group.WORLD)
        n = len(batch) // world
        part = slice(rank * n, (rank + 1) * n)
        loss = step(torch.from_numpy(batch[part]),
                    eps=torch.from_numpy(eps[part]))
        grads = weights.to_flax({k: p.grad
                                 for k, p in model.named_parameters()})
        return float(loss), grads, weights.to_flax(model)
    finally:
        dist.destroy_process_group()


def vae_store_fed(rank, world, tmp, samples, batch, epochs, device="cpu"):
    """Store -> loader -> DDP VAE over a TorchGroup and a TCP store: the
    loader's threads read remote rows while the main thread is inside
    DDP's all-reduce (over gloo; on ``device="cuda"`` every rank uses card
    0). Returns the per-epoch summed losses, every rank's parameter
    checksum (gathered through the group), the bytes that crossed the
    network and the rows read."""
    import hashlib

    import torch

    if device == "cuda":
        torch.cuda.set_device(0)  # before any other CUDA call

    from ddstore_tpu_torch.data.dataset import (DistributedSampler,
                                                ShardedDataset)
    from ddstore_tpu_torch.data.formats import synthetic_mnist
    from ddstore_tpu_torch.data.loader import DeviceLoader
    from ddstore_tpu_torch.models import vae
    from ddstore_tpu_torch.rendezvous import TorchGroup
    from ddstore_tpu_torch.store import DDStore

    dist = torch_world(rank, world, tmp)
    group = TorchGroup()
    store = DDStore(group, backend="tcp")
    try:
        ds = ShardedDataset(store, synthetic_mnist(samples, seed=0)[0])
        # different weights on each rank: DDP must broadcast rank 0's
        model = vae.VAE(device=device).init_weights(
            torch.Generator(device=device).manual_seed(rank))
        _, opt = vae.create_train_state(model)
        step = vae.make_train_step(model, opt, group=dist.group.WORLD)
        sampler = DistributedSampler(len(ds), group.size, group.rank)
        gen = torch.Generator(device=device).manual_seed(100 + rank)
        losses, dcn, rows = [], 0, 0
        for epoch in range(epochs):
            sampler.set_epoch(epoch)
            loader = DeviceLoader(ds, sampler, batch, device=device)
            losses.append(sum(float(step(xb, generator=gen))
                              for xb in loader))
            dcn += loader.metrics.bytes_moved()["bytes_over_dcn"]
            rows += len(loader) * batch
        digest = hashlib.sha256(b"".join(
            p.detach().cpu().numpy().tobytes() for p in model.parameters()))
        sums = group.allgather(digest.hexdigest())
        return {"losses": losses, "checksums": sums, "bytes_over_dcn": dcn,
                "rows": rows, "row_bytes": store.row_nbytes(ds.data_var)}
    finally:
        store.close()
        dist.destroy_process_group()


def gnn_ddp_step(rank, world, tmp, params, batch):
    """One data-parallel train step of the port's f32 MPNN on slot
    ``rank`` of ``batch`` (a tuple of numpy ``GraphBatch`` fields with
    one slot per rank): (loss, gradients, parameters after the step), the
    trees as ``weights.to_flax`` gives them."""
    import torch

    from ddstore_tpu_torch import weights
    from ddstore_tpu_torch.data.graphs import GraphBatch
    from ddstore_tpu_torch.models import gnn

    dist = torch_world(rank, world, tmp)
    try:
        gb = GraphBatch(*(torch.from_numpy(np.ascontiguousarray(
            f[rank:rank + 1])) for f in batch))
        model = gnn.MPNN(hidden=32, layers=2, n_graphs=gb.y.shape[1],
                         compute_dtype=torch.float32, device="cpu")
        weights.from_flax(params, model)
        _, opt = gnn.create_train_state(model)
        step = gnn.make_train_step(model, opt, group=dist.group.WORLD)
        loss = step(gb)
        grads = weights.to_flax({k: p.grad
                                 for k, p in model.named_parameters()})
        return float(loss), grads, weights.to_flax(model)
    finally:
        dist.destroy_process_group()


def _stamped(rank, num, dim, dtype=np.float32):
    """Rank-stamped rows: column 0 is the owning rank + 1, column 1 the
    global row id, the rest seeded noise."""
    rows = np.random.default_rng((7, rank)).normal(size=(num, dim))
    rows[:, 0] = rank + 1
    rows[:, 1] = rank * num + np.arange(num)
    return rows.astype(dtype)


def collective_fetch(rank, world, tmp, num, batches, ragged_batches):
    """The device-collective fetch over a TCP store and a gloo group:
    ``device_fetch_batch`` (float and uint8 rows) and
    ``device_fetch_ragged_batch`` against the host reads of this rank's
    slice, with this rank's ledger share per batch."""
    import torch

    from ddstore_tpu_torch.data import device_fetch as df
    from ddstore_tpu_torch.data.ragged import pad_ragged
    from ddstore_tpu_torch.rendezvous import TorchGroup
    from ddstore_tpu_torch.store import DDStore
    from ddstore_tpu_torch.utils.metrics import PipelineMetrics

    dist = torch_world(rank, world, tmp)
    store = DDStore(TorchGroup(), backend="tcp")
    try:
        store.add("v", _stamped(rank, num, 6))
        store.add("u8", (_stamped(rank, num, 5) * 7 % 256).astype(np.uint8))
        store.add_ragged("g", [np.full((i % 5 + 1, 3), rank * 100 + i,
                                       np.float32) for i in range(num)])
        out = {"fixed": [], "ragged": [], "ledgers": []}
        for idx in batches:
            per = len(idx) // world
            mine = idx[rank * per:(rank + 1) * per]
            for name in ("v", "u8"):
                m = PipelineMetrics()
                got = df.device_fetch_batch(store, name, idx, metrics=m)
                assert isinstance(got, torch.Tensor)
                want = store.get_batch(name, mine)
                out["fixed"].append(got.numpy().tobytes() ==
                                    want.tobytes())
                out["ledgers"].append((name, m.bytes_moved()))
            stamps = df.device_fetch_batch(store, "v", idx)[:, 0].numpy()
            assert (stamps == mine // num + 1).all(), "rank stamps"
        for idx in ragged_batches:
            per = len(idx) // world
            mine = idx[rank * per:(rank + 1) * per]
            padded, lens = df.device_fetch_ragged_batch(store, "g", idx,
                                                        max_len=4)
            values, want_lens = store.get_ragged_batch("g", mine)
            want, _ = pad_ragged(values, want_lens, 4)
            out["ragged"].append(
                np.array_equal(lens, want_lens)
                and padded.numpy().tobytes() == want.tobytes())
        store.barrier()
        return out
    finally:
        store.close()
        dist.destroy_process_group()


def exchange_parity(rank, world, tmp, staged, inv, cap):
    """The port's exchange of this rank's slice of a reference staged
    buffer: ``exchange_staged`` over a gloo group."""
    from ddstore_tpu_torch.data import device_fetch as df

    dist = torch_world(rank, world, tmp)
    try:
        plan = df.DeviceFetchPlan(None, world, world, len(inv) // world, 1,
                                  cap, None, None, None, None, None, inv,
                                  None, None)
        send = staged[rank * world * cap:(rank + 1) * world * cap]
        return df.exchange_staged(df.StagedFetch(plan, send, rank)).numpy()
    finally:
        dist.destroy_process_group()


def _loader_epochs(ds, batch, epochs, **kw):
    """``epochs`` epochs of a loader over the global index stream (every
    rank the same sampler), as numpy arrays."""
    from ddstore_tpu_torch.data.dataset import DistributedSampler
    from ddstore_tpu_torch.data.loader import DeviceLoader

    samp = DistributedSampler(len(ds), 1, 0, seed=5)
    ld = DeviceLoader(ds, samp, batch, device="cpu", **kw)
    out = []
    for epoch in range(epochs):
        samp.set_epoch(epoch)
        out.append([tuple(t.numpy().copy() for t in b)
                    if isinstance(b, tuple) else b.numpy().copy()
                    for b in ld])
    return out, ld


def collective_loader(rank, world, tmp, num, batch):
    """``DeviceLoader(device_collective=True)`` over a TCP store and a
    gloo group against the host reads of this rank's slices, plain and
    through readahead; a staging failure on rank 1 only; the fallback
    reasons."""
    import torch  # noqa: F401

    from ddstore_tpu_torch.binding import ERR_TRANSPORT, DDStoreError
    from ddstore_tpu_torch.data import device_fetch as df
    from ddstore_tpu_torch.data.dataset import (DistributedSampler,
                                                ShardedDataset)
    from ddstore_tpu_torch.data.loader import DeviceLoader
    from ddstore_tpu_torch.rendezvous import TorchGroup
    from ddstore_tpu_torch.store import DDStore

    dist = torch_world(rank, world, tmp)
    store = DDStore(TorchGroup(), backend="tcp")
    try:
        data = np.concatenate([_stamped(r, num, 4) for r in range(world)])
        labels = np.arange(world * num, dtype=np.int64)
        ds = ShardedDataset(store, data, labels)
        out = {}

        def want_epochs(n):
            samp = DistributedSampler(len(ds), 1, 0, seed=5)
            per = batch // world
            res = []
            for epoch in range(n):
                samp.set_epoch(epoch)
                idx = samp.epoch_indices()
                res.append([ds.fetch(idx[b * batch + rank * per:
                                         b * batch + (rank + 1) * per])
                            for b in range(len(idx) // batch)])
            return res

        want = want_epochs(2)

        def same(got):
            return all(len(g) == len(w) and all(
                gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()
                for (gx, gy), (wx, wy) in zip(g, w))
                for g, w in zip(got, want))

        got, ld = _loader_epochs(ds, batch, 2, device_collective=True,
                                 workers=2)
        m = ld.metrics.summary()
        out["plain"] = (ld._collective_ready, ld.collective_fallback_reason,
                        same(got), m["bytes_moved"], m["collective"],
                        m["faults"], len(ld))
        got, ld = _loader_epochs(ds, batch, 2, device_collective=True,
                                 readahead_windows=2,
                                 readahead_window_batches=2)
        m = ld.metrics.summary()
        out["readahead"] = (ld._readahead_ready, ld.readahead_fallback_reason,
                            same(got), m["bytes_moved"], m["collective"],
                            m["readahead"]["windows"], store.async_pending())

        # rank 1's staging raises once: both ranks read that batch
        # through the host path, nobody hangs
        real = df.stage_batch
        calls = {"n": 0}

        def flaky(*a, **k):
            calls["n"] += 1
            if rank == 1 and calls["n"] == 3:
                raise DDStoreError(ERR_TRANSPORT, "injected staging fault")
            return real(*a, **k)

        df.stage_batch = flaky
        try:
            got, ld = _loader_epochs(ds, batch, 1, device_collective=True,
                                     workers=1)
        finally:
            df.stage_batch = real
        m = ld.metrics.summary()
        out["failure"] = (same(got[:1]) and len(got[0]) == len(want[0]),
                          m["faults"]["collective_batch_fallbacks"],
                          m["collective"]["exchanges"], len(ld),
                          ld.collective_fallback_reason)

        samp = DistributedSampler(len(ds), 1, 0, seed=5)
        sub = dist.new_group([0])
        reasons = {
            "transform": DeviceLoader(ds, samp, batch, device="cpu",
                                      transform=lambda b: b,
                                      device_collective=True),
            "divisible": DeviceLoader(ds, samp, batch + 1, device="cpu",
                                      device_collective=True),
            "callable": DeviceLoader(lambda i: data[i], samp, batch,
                                     device="cpu", device_collective=True),
        }
        if rank == 0:
            reasons["group"] = DeviceLoader(ds, samp, batch, device="cpu",
                                            device_collective=True,
                                            group=sub)
        out["reasons"] = {k: (v._collective_ready,
                              v.collective_fallback_reason)
                          for k, v in reasons.items()}
        # the fallback still yields this rank's slice of each batch
        first = next(iter(reasons["transform"]))
        out["fallback_slice"] = first[0].numpy().tobytes() == \
            want[0][0][0].tobytes()
        store.barrier()
        return out
    finally:
        store.close()
        dist.destroy_process_group()


def device_shuffles(rank, world, tmp, x, staged, inv, perm):
    """The port's device-path shuffle functions on this rank's shard of
    ``x`` over a gloo group: all_to_all_rows, exchange_rows (this rank's
    slice of a staged buffer and inv), permute_rows, and
    global_shuffle_epoch under two seeds (twice under the first)."""
    import torch

    from ddstore_tpu_torch.parallel import shuffle

    dist = torch_world(rank, world, tmp)
    try:
        n = len(x) // world
        mine = torch.from_numpy(x[rank * n:(rank + 1) * n])
        cap = len(staged) // (world * world)
        per = len(inv) // world
        send = torch.from_numpy(
            staged[rank * world * cap:(rank + 1) * world * cap])
        return {
            "a2a": shuffle.all_to_all_rows(mine).numpy(),
            "exchange": shuffle.exchange_rows(
                send, inv[rank * per:(rank + 1) * per]).numpy(),
            "permute": shuffle.permute_rows(mine, perm).numpy(),
            "epoch": [shuffle.global_shuffle_epoch(mine, s).numpy()
                      for s in (1, 1, 2)],
        }
    finally:
        dist.destroy_process_group()


def host_shuffles(rank, world, tmp, data, samples, seed):
    """host_global_shuffle of a fixed-width variable and
    ragged_global_shuffle of a ragged one over a TCP store and a gloo
    group: this rank's shard of each afterwards, and the errors for
    shuffling half of a ragged pair."""
    from ddstore_tpu_torch.data.dataset import nsplit
    from ddstore_tpu_torch.parallel import shuffle
    from ddstore_tpu_torch.rendezvous import TorchGroup
    from ddstore_tpu_torch.store import DDStore

    dist = torch_world(rank, world, tmp)
    store = DDStore(TorchGroup(), backend="tcp")
    try:
        counts = nsplit(len(data), world)
        lo = sum(counts[:rank])
        store.add("v", data[lo:lo + counts[rank]])
        counts = nsplit(len(samples), world)
        lo = sum(counts[:rank])
        store.add_ragged("g", samples[lo:lo + counts[rank]])
        errors = []
        for name in ("g/index", "g/values", "g"):
            try:
                shuffle.host_global_shuffle(store, name, seed)
            except ValueError as e:
                errors.append(str(e))
        shuffle.host_global_shuffle(store, "v", seed)
        shuffle.ragged_global_shuffle(store, "g", seed)
        b, e = store.my_row_range("v")
        fixed = store.get_batch("v", np.arange(b, e))
        b, e = store.my_row_range("g/index")
        values, lens = store.get_ragged_batch("g", np.arange(b, e))
        store.barrier()
        return fixed, values, lens, errors
    finally:
        store.close()
        dist.destroy_process_group()


def nccl_collective(rank, world, tmp, steps=6):
    """A one-process NCCL group on card 0 over a world-1 store: the
    device-collective fetch and a collective loader epoch, each against
    the host path, with the exchange on the card."""
    import torch
    import torch.distributed as dist

    from ddstore_tpu_torch.data import device_fetch as df
    from ddstore_tpu_torch.data.dataset import (DistributedSampler,
                                                ShardedDataset)
    from ddstore_tpu_torch.data.loader import DeviceLoader
    from ddstore_tpu_torch.store import DDStore

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=world)
    store = DDStore()
    try:
        data = np.random.default_rng(0).integers(0, 256, (256, 784),
                                                 dtype=np.uint8)
        ds = ShardedDataset(store, data, np.arange(256, dtype=np.int64))
        idx = np.random.default_rng(1).integers(0, 256, 64)
        got = df.device_fetch_batch(store, ds.data_var, idx, device=dev)
        out = {"fetch": got.is_cuda and torch.equal(
                   got.cpu(), torch.from_numpy(data[idx])),
               "exchange_device": str(df.exchange_device(None, dev))}
        samp = DistributedSampler(256, 1, 0, seed=2)
        host = [(x.cpu(), y.cpu()) for x, y in
                DeviceLoader(ds, samp, 32, device=dev)]
        ld = DeviceLoader(ds, samp, 32, device=dev, device_collective=True)
        coll = [(x.cpu(), y.cpu()) for x, y in ld]
        out["loader"] = (len(coll) == len(host) == 8 and all(
            torch.equal(a, c) and torch.equal(b, d)
            for (a, b), (c, d) in zip(host, coll)))
        out["summary"] = ld.metrics.summary()["collective"]
        out["reason"] = ld.collective_fallback_reason
        return out
    finally:
        store.close()
        dist.destroy_process_group()
