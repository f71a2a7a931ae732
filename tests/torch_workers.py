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
