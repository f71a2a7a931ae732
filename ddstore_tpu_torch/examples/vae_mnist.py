"""Data-parallel VAE trained from the distributed store (the port of
``examples/vae_mnist.py``).

The dataset lives in the store, one shard per process; a
``DistributedSampler`` over the whole world hands every rank global
indices (most of them owned by other ranks), the ``DeviceLoader`` reads
them into pinned host buffers and stages them on the card, and the VAE
trains under ``DistributedDataParallel`` with the gradients summed over
the world.

One process (the card, or ``--device cpu``)::

    python -m ddstore_tpu_torch.examples.vae_mnist --epochs 2

Two processes on one host, through a file rendezvous (the gradients then
go over gloo; NCCL takes one card per rank)::

    d=$(mktemp -d); for r in 0 1; do DDSTORE_RANK=$r DDSTORE_WORLD=2 \\
        DDSTORE_RDV_DIR=$d python -m ddstore_tpu_torch.examples.vae_mnist \\
        --epochs 1 & done; wait

Under a scheduler (``DDSTORE_COORDINATOR``/``DDSTORE_NUM_PROCESSES``/
``DDSTORE_PROCESS_ID``, SLURM, LSF, or ``DDSTORE_POD_AUTODETECT=1`` with
torchrun's environment) ``pod_bootstrap`` brings up torch.distributed.

Trains on the MNIST idx files under ``--data-dir`` (plain or .gz), else on
synthetic MNIST-shaped data.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m ddstore_tpu_torch.examples.vae_mnist",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=128,
                   help="global batch size")
    p.add_argument("--samples", type=int, default=None,
                   help="dataset size cap (default: 4096 synthetic "
                        "samples; the full file with --data-dir)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--width", type=int, default=None,
                   help="replica-group width (ranks per store group)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=None,
                   help="cap steps per epoch (smoke runs)")
    p.add_argument("--data-dir", type=str, default=None,
                   help="directory with MNIST idx files (plain or .gz); "
                        "omit for synthetic data")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ddstore_tpu_torch.data.dataset import (DistributedSampler,
                                                ShardedDataset)
    from ddstore_tpu_torch.data.formats import load_mnist, synthetic_mnist
    from ddstore_tpu_torch.data.loader import DeviceLoader
    from ddstore_tpu_torch.models import vae
    from ddstore_tpu_torch.rendezvous import (FileGroup, auto_group,
                                              detect_pod_env, pod_bootstrap)
    from ddstore_tpu_torch.store import DDStore

    cuda = args.device == "cuda"
    if cuda:
        # before any CUDA call: one card per process where there are enough
        rank_hint = int(os.environ.get(
            "LOCAL_RANK", os.environ.get("DDSTORE_RANK", "0")))
        torch.cuda.set_device(rank_hint % torch.cuda.device_count())
    scheduled = detect_pod_env() is not None or \
        os.environ.get("DDSTORE_POD_AUTODETECT") == "1"
    group = pod_bootstrap() if scheduled else auto_group()
    world, rank = group.size, group.rank
    # NCCL takes one card per rank; ranks that share a card use gloo
    backend = "nccl" if cuda and world <= torch.cuda.device_count() \
        else "gloo"
    if world > 1 and not dist.is_initialized():
        if not isinstance(group, FileGroup):
            raise RuntimeError(f"no torch.distributed job for the "
                               f"{type(group).__name__} of {world}")
        # the store's file rendezvous directory carries the job's as well
        dist.init_process_group(
            backend, init_method=f"file://{group.root}/torch_pg",
            rank=rank, world_size=world)
    ddp_group = dist.group.WORLD if world > 1 else None

    store = DDStore(group, width=args.width)
    if args.data_dir is not None:
        data, _ = load_mnist(args.data_dir, split="train", normalize=False)
        if args.samples is not None and args.samples < len(data):
            data = data[: args.samples]
    else:
        data, _ = synthetic_mnist(args.samples or 4096, args.seed)
    ds = ShardedDataset(store, data)

    dev = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")
    model = vae.VAE(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(args.seed))
    _, opt = vae.create_train_state(model, lr=args.lr)
    step = vae.make_train_step(model, opt, group=ddp_group)
    per_rank = args.batch_size // world
    # indices over the whole world, not the replica group: with --width
    # every replica group holds a full copy, and groups draw disjoint rows
    sampler = DistributedSampler(len(ds), store.world_group.size,
                                 store.world_group.rank, seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1 + rank)
    for epoch in range(args.epochs):
        sampler.set_epoch(epoch)
        loader = DeviceLoader(ds, sampler, per_rank, device=dev)
        t0 = time.perf_counter()
        total, nb = 0.0, 0
        for i, xb in enumerate(loader):
            if args.steps is not None and i >= args.steps:
                break
            total += float(step(xb, generator=gen))
            nb += 1
        dt = time.perf_counter() - t0
        m = loader.metrics.summary()
        if rank == 0:
            print(f"epoch {epoch}: loss/sample="
                  f"{total / max(1, nb) / (per_rank * world):.3f} "
                  f"samples/s={nb * per_rank * world / dt:.0f} "
                  f"pipeline_eff={m['input_pipeline_efficiency']:.3f} "
                  f"fetch_p50={m['host_fetch']['p50_s'] * 1e3:.2f}ms"
                  + (" bytes_moved=" + str(m["bytes_moved"])
                     if "bytes_moved" in m else ""), flush=True)
    store.close()
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
