"""Data-parallel training of a message-passing GNN on store-held graphs
(the port of ``examples/gnn_molecules.py``).

Each process holds a shard of variable-size molecular graphs in the
store as ragged variables, any process fetches any graph one-sidedly,
batches are packed into fixed node/edge budgets, and the MPNN trains
under ``DistributedDataParallel`` with one packed slot of
``--graphs-per-slot`` graphs per rank.

One process (the card, or ``--device cpu``)::

    python -m ddstore_tpu_torch.examples.gnn_molecules --epochs 2

Two processes on one host, through a file rendezvous (the gradients then
go over gloo; NCCL takes one card per rank)::

    d=$(mktemp -d); for r in 0 1; do DDSTORE_RANK=$r DDSTORE_WORLD=2 \\
        DDSTORE_RDV_DIR=$d python -m \\
        ddstore_tpu_torch.examples.gnn_molecules --epochs 1 & done; wait

Trains on real QM9 xyz files when ``--data-dir`` points at a directory of
``.xyz``/``.xyz.gz`` molecule files (each rank loads the directory and
takes its contiguous shard); otherwise on QM9-shaped synthetic molecules.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m ddstore_tpu_torch.examples.gnn_molecules",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--graphs", type=int, default=2048,
                   help="graphs per process shard")
    p.add_argument("--graphs-per-slot", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--width", type=int, default=None,
                   help="replica-group width (ranks per store group)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=None,
                   help="cap steps per epoch (smoke runs)")
    p.add_argument("--data-dir", type=str, default=None,
                   help="directory of QM9 .xyz/.xyz.gz files; omit for "
                        "synthetic molecules")
    p.add_argument("--target-index", type=int, default=1,
                   help="comment-line property used as regression target "
                        "(real QM9 comment lines are 'gdb <id> <props...>'"
                        " — index 0 is the molecule serial number, so the "
                        "default 1 is the first physical property, A)")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ddstore_tpu_torch.data.dataset import DistributedSampler, nsplit
    from ddstore_tpu_torch.data.formats import load_qm9_dir
    from ddstore_tpu_torch.data.graphs import (GraphShardedDataset,
                                               synthetic_graphs)
    from ddstore_tpu_torch.data.loader import DeviceLoader
    from ddstore_tpu_torch.examples._launch import finish, launch
    from ddstore_tpu_torch.models import gnn
    from ddstore_tpu_torch.store import DDStore

    group, ddp_group, dev = launch(args.device)
    store = DDStore(group, width=args.width)
    if args.data_dir is not None:
        all_graphs = load_qm9_dir(args.data_dir,
                                  target_index=args.target_index,
                                  limit=args.graphs * store.world
                                  if args.graphs else None)
        counts = nsplit(len(all_graphs), store.world)
        begin = int(sum(counts[: store.rank]))
        graphs = all_graphs[begin: begin + counts[store.rank]]
    else:
        graphs = synthetic_graphs(
            np.random.default_rng(args.seed + store.rank), args.graphs)
    ds = GraphShardedDataset(store, graphs,
                             graphs_per_slot=args.graphs_per_slot)
    # the feature widths are the data's (a rank may hold no graph)
    g0 = graphs[0] if graphs else None
    fn, fe, t = next(d for d in group.allgather(
        g0 and (g0.nodes.shape[1], g0.edge_attr.shape[1], g0.y.shape[0]))
        if d)

    model = gnn.MPNN(out_dim=t, n_graphs=args.graphs_per_slot, fn=fn, fe=fe,
                     device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(args.seed))
    _, opt = gnn.create_train_state(model, lr=args.lr)
    step = gnn.make_train_step(model, opt, group=ddp_group)
    # one packed slot per rank
    per_rank = args.graphs_per_slot
    world = store.world_group.size
    sampler = DistributedSampler(len(ds), world, store.world_group.rank,
                                 seed=args.seed)
    for epoch in range(args.epochs):
        sampler.set_epoch(epoch)
        loader = DeviceLoader(ds, sampler, per_rank, device=dev)
        t0 = time.perf_counter()
        total, nb = 0.0, 0
        for i, gb in enumerate(loader):
            if args.steps is not None and i >= args.steps:
                break
            total += float(step(gb))
            nb += 1
        dt = time.perf_counter() - t0
        m = loader.metrics.summary()
        if store.rank == 0:
            print(f"epoch {epoch}: loss={total / max(1, nb):.4f} "
                  f"graphs/s={nb * per_rank * world / dt:.0f} "
                  f"pipeline_eff={m['input_pipeline_efficiency']:.3f} "
                  f"fetch_p50={m['host_fetch']['p50_s'] * 1e3:.2f}ms",
                  flush=True)
    finish(store)


if __name__ == "__main__":
    main()
