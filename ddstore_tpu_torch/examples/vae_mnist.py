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

``--device-collective`` stages batches with the device-collective fetch:
every rank draws the same global batch, reads only the rows it owns
(locally), and one ``all_to_all_single`` over the torch.distributed
group delivers each rank its share. One process joins a one-process
group of its own (NCCL on the card, gloo on the CPU); ranks sharing a
card run gloo, since NCCL takes one card per rank::

    python -m ddstore_tpu_torch.examples.vae_mnist --device-collective
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--readahead-windows", type=int, default=0,
                   help="epoch-window readahead depth (0: per-batch "
                        "reads)")
    p.add_argument("--readahead-window-batches", type=int, default=8,
                   help="batches per readahead window")
    p.add_argument("--device-collective", action="store_true",
                   help="stage batches with the device-collective fetch "
                        "(each rank reads the rows it owns locally, one "
                        "all_to_all_single delivers them); falls back to "
                        "the host path, saying why, where it cannot run")
    args = p.parse_args(argv)

    import torch

    from ddstore_tpu_torch.data.dataset import (DistributedSampler,
                                                ShardedDataset)
    from ddstore_tpu_torch.data.formats import load_mnist, synthetic_mnist
    from ddstore_tpu_torch.data.loader import DeviceLoader
    from ddstore_tpu_torch.examples._launch import (finish, launch,
                                                    one_process_group)
    from ddstore_tpu_torch.models import vae
    from ddstore_tpu_torch.store import DDStore

    group, ddp_group, dev = launch(args.device)
    world, rank = group.size, group.rank
    if args.device_collective and world == 1:
        one_process_group(dev)
    store = DDStore(group, width=args.width)
    if args.data_dir is not None:
        data, _ = load_mnist(args.data_dir, split="train", normalize=False)
        if args.samples is not None and args.samples < len(data):
            data = data[: args.samples]
    else:
        data, _ = synthetic_mnist(args.samples or 4096, args.seed)
    ds = ShardedDataset(store, data)

    model = vae.VAE(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(args.seed))
    _, opt = vae.create_train_state(model, lr=args.lr)
    step = vae.make_train_step(model, opt, group=ddp_group)
    per_rank = args.batch_size // world
    # indices over the whole world, not the replica group: with --width
    # every replica group holds a full copy, and groups draw disjoint rows
    sampler = DistributedSampler(len(ds), store.world_group.size,
                                 store.world_group.rank, seed=args.seed)
    if args.device_collective:
        # the global index stream on every rank: the loader slices each
        # global batch, and the exchange delivers every rank its share
        sampler = DistributedSampler(len(ds), 1, 0, seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1 + rank)
    for epoch in range(args.epochs):
        sampler.set_epoch(epoch)
        loader = DeviceLoader(
            ds, sampler,
            args.batch_size if args.device_collective else per_rank,
            device=dev, readahead_windows=args.readahead_windows,
            readahead_window_batches=args.readahead_window_batches,
            device_collective=args.device_collective)
        if args.device_collective and rank == 0 and epoch == 0 \
                and loader.collective_fallback_reason is not None:
            print(f"device-collective fallback: "
                  f"{loader.collective_fallback_reason}", flush=True)
        if args.readahead_windows and rank == 0 and epoch == 0 \
                and loader.readahead_fallback_reason is not None:
            print(f"readahead fallback: "
                  f"{loader.readahead_fallback_reason}", flush=True)
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
                     if "bytes_moved" in m else "")
                  + (" readahead=" + str(m["readahead"])
                     if "readahead" in m else ""), flush=True)
    finish(store)


if __name__ == "__main__":
    main()
