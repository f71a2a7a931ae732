"""Long-context LM training: store-fed token windows, a dp x sp mesh, ring
attention and rematerialized blocks, with tensor parallelism, an
expert-parallel MoE and pipeline stages (the port of
``examples/lm_longcontext.py``).

Sequences are sharded across the ``sp`` axis of the mesh, so each rank
holds ``S/sp`` of every window's activations; K/V chunks go round the
ring inside attention, and ``--remat`` trades recompute for the rest of
the activation memory. The token windows live in the distributed store
and stream through the loader, each rank staging only its sequence chunk
of its dp slot's rows.

The port runs one rank per device: with ``W`` ranks, ``dp = min(--dp,
W)``, ``--pp`` ranks hold one pipeline stage each, ``--tp`` ranks split
each block's heads and MLP, and the ranks left over, ``W // (dp * pp *
tp)``, go to ``ep`` when ``--experts`` asks for an MoE, else to ``sp``
(the reference's ``:105-123``). The sampler hands out dp slots' rows
(``DistributedSampler(n, dp, dp_index)``), and the ranks of one dp slot
read the same windows.

Two processes on the CPU, through a file rendezvous (dp 1 x sp 2)::

    d=$(mktemp -d); for r in 0 1; do DDSTORE_RANK=$r DDSTORE_WORLD=2 \\
        DDSTORE_RDV_DIR=$d python -m \\
        ddstore_tpu_torch.examples.lm_longcontext --device cpu --dp 1 \\
        --seq 256 --epochs 1 --steps 4 & done; wait

On the card drop ``--device cpu``: ranks that share a card talk over
gloo (NCCL takes one card per rank), one rank per card uses NCCL.
``--accum-steps N`` trains the same batch in 1/N the activation memory;
``--generate N`` ends the run with a KV-cached greedy continuation of a
training window's prefix, its prompt prefilled over the ring (on whole
parameters gathered from the tensor and expert shards). ``--tp 2`` or
``--experts 4 --moe-top-k 2`` over 2 ranks run those layouts. ``--pp 2``
trains the pipelined step (``--schedule``, ``--microbatches`` per dp
slot's batch of ``2 * microbatches`` rows, ``--virtual-stages`` under the
interleaved schedules; ``--remat`` re-runs each stage in GPipe's
backward), and ``--generate`` then decodes on rank 0 from the stages
reassembled by ``lm_from_stages``.
"""

from __future__ import annotations

import argparse
import contextlib
import time


def rank_axes(world: int, dp: int, pp: int, tp: int, experts: int) -> dict:
    """The mesh's axis sizes over ``world`` ranks: the ranks left after dp
    x pp x tp serve the experts when ``experts`` asks for an MoE, else the
    sequence (``examples/lm_longcontext.py:118-123``)."""
    rest = world // (dp * pp * tp)
    ep, sp = (rest, 1) if experts else (1, rest)
    return {"pp": pp, "dp": dp, "ep": ep, "sp": sp, "tp": tp}


def main(argv=None) -> dict:
    """Run the example; returns this rank's mesh axes, its heads and its
    step losses."""
    p = argparse.ArgumentParser(
        prog="python -m ddstore_tpu_torch.examples.lm_longcontext",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--windows", type=int, default=256,
                   help="token windows per process shard")
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=None,
                   help="attention heads (default dim // 32, the "
                        "reference's)")
    p.add_argument("--dp", type=int, default=2)
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages (>1 selects the pipelined train "
                        "step; composes with dp, sp, --tp and --experts)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel axis size (splits each block's "
                        "heads and MLP columns)")
    p.add_argument("--microbatches", type=int, default=2,
                   help="microbatches per step under --pp")
    p.add_argument("--schedule",
                   choices=("gpipe", "1f1b", "interleaved",
                            "interleaved_1f1b"),
                   default="gpipe", help="pipeline schedule under --pp")
    p.add_argument("--virtual-stages", type=int, default=2,
                   help="model chunks per pp device under the "
                        "interleaved schedules")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat-policy", type=str, default=None,
                   help="selective remat, a jax.checkpoint_policies name "
                        "the port maps (e.g. dots_with_no_batch_dims_"
                        "saveable)")
    p.add_argument("--profile", type=str, default=None, metavar="LOGDIR",
                   help="capture a torch.profiler trace of epoch 0 into "
                        "LOGDIR")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation chunks per optimizer "
                        "update")
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after training, decode N tokens from the first "
                        "training window's prefix (greedy unless "
                        "--temperature)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature for --generate (0=greedy)")
    p.add_argument("--top-k", type=int, default=None,
                   help="restrict sampling to the k most likely tokens")
    p.add_argument("--top-p", type=float, default=None,
                   help="nucleus sampling: smallest token set with "
                        "cumulative probability >= p")
    p.add_argument("--experts", type=int, default=0,
                   help="swap the MLP for an expert-parallel MoE with this "
                        "many experts (sharded over the ranks left after "
                        "dp * tp)")
    p.add_argument("--moe-top-k", type=int, default=1,
                   help="experts per token (1=Switch, 2=GShard)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from ddstore_tpu_torch.data.dataset import (DistributedSampler,
                                                ShardedDataset)
    from ddstore_tpu_torch.data.loader import DeviceLoader, batch_slot
    from ddstore_tpu_torch.examples._launch import finish, launch
    from ddstore_tpu_torch.models import decode, transformer
    from ddstore_tpu_torch.parallel import make_mesh
    from ddstore_tpu_torch.store import DDStore
    from ddstore_tpu_torch.utils import profile

    group, _, dev = launch(args.device)
    world, rank = group.size, group.rank
    dp, pp, tp = min(args.dp, world), args.pp, args.tp
    if world % (dp * pp * tp):
        raise SystemExit(f"{world} ranks do not split into dp={dp} x "
                         f"pp={pp} x tp={tp}")
    axes = rank_axes(world, dp, pp, tp, args.experts)
    ep, sp = axes["ep"], axes["sp"]
    mesh = make_mesh(axes, dev.type) if world > 1 else None

    store = DDStore(group)
    rng = np.random.default_rng(args.seed + store.rank)
    # Repeated-pattern corpus (learnable quickly; swap in real token ids).
    base = rng.integers(0, args.vocab, size=64)
    corpus = np.tile(base, args.windows * args.seq // 64 + 2)
    starts = rng.integers(0, len(corpus) - args.seq - 1, size=args.windows)
    at = starts[:, None] + np.arange(args.seq)
    windows = corpus[at].astype(np.int32)
    nexts = corpus[at + 1].astype(np.int32)
    ds = ShardedDataset(store, windows, nexts)

    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    heads = args.heads or args.dim // 32
    model = transformer.TransformerLM(
        vocab=args.vocab, dim=args.dim, heads=heads,
        layers=args.layers, compute_dtype=dtype, device=dev, mesh=mesh,
        n_experts=args.experts, moe_top_k=args.moe_top_k,
        remat=args.remat or args.remat_policy is not None,
        remat_policy=args.remat_policy)
    model.init_weights(torch.Generator(device=dev).manual_seed(args.seed))
    if pp > 1:
        # the pipelined step: stages over pp (Megatron over tp, the ring
        # over sp, the experts over ep inside each stage)
        if args.accum_steps != 1:
            raise SystemExit("--accum-steps composes with the sequential "
                             "step only; under --pp use --microbatches")
        nv = args.virtual_stages \
            if args.schedule.startswith("interleaved") else 1
        state, opt = transformer.create_pp_train_state(
            model, pp, lr=args.lr, mesh=mesh, n_virtual=nv)
        step = transformer.make_pp_train_step(
            state.model, opt, mesh, pp, args.microbatches,
            schedule=args.schedule, n_virtual=nv, remat=args.remat,
            state=state)
        batch = args.microbatches * 2  # the reference's microbatches*2*dp
    else:
        state, opt = transformer.create_train_state(model, lr=args.lr,
                                                    mesh=mesh)
        step = transformer.make_train_step(model, opt, state=state,
                                           mesh=mesh,
                                           accum_steps=args.accum_steps)
        batch = 2  # a dp slot's rows (the reference's 2 * dp over all)
    spec = ("dp", "sp") if sp > 1 else ("dp",)
    slot, slots = batch_slot(mesh, spec)  # this rank's dp slot
    sampler = DistributedSampler(len(ds), slots, slot, seed=args.seed)
    losses = []
    for epoch in range(args.epochs):
        sampler.set_epoch(epoch)
        loader = DeviceLoader(ds, sampler, batch, device=dev, mesh=mesh,
                              spec=spec)
        pos = loader.seq_positions(batch)
        tracing = profile.trace(args.profile) \
            if (args.profile and epoch == 0) else contextlib.nullcontext()
        t0 = time.perf_counter()
        tot, nb = 0.0, 0
        with tracing:
            for i, (tok, tgt) in enumerate(loader):
                if args.steps is not None and i >= args.steps:
                    break
                with profile.step_annotate(i):
                    losses.append(float(step(tok, tgt, pos)))
                tot += losses[-1]
                nb += 1
        dt = time.perf_counter() - t0
        m = loader.metrics.summary()
        if rank == 0:
            tps = nb * batch * dp * args.seq / dt
            print(f"epoch {epoch}: loss={tot / max(1, nb):.4f} "
                  f"tokens/s={tps:.0f} "
                  f"pipeline_eff={m['input_pipeline_efficiency']:.3f}",
                  flush=True)
    if args.generate > 0:
        # KV-cached greedy continuation of rank 0's first window's prefix,
        # its prompt prefilled over the ring (every rank takes part; under
        # pp rank 0 alone decodes, on the stages reassembled)
        unit = 8 * sp if pp == 1 else 8
        plen = min(args.seq, -(-max(32, unit) // unit) * unit)
        want = np.full(args.generate, -1, np.int64)  # -1: past the corpus
        tail = corpus[starts[0] + plen:starts[0] + plen + args.generate]
        want[:len(tail)] = tail
        first = torch.from_numpy(np.concatenate(
            [windows[0, :plen].astype(np.int64), want])).to(dev)
        if world > 1:
            dist.broadcast(first, 0)
        prompt = first[None, :plen]
        prefill_mesh = mesh if sp > 1 else None
        if pp > 1:
            model = transformer.lm_from_stages(state.model, mesh)
            prefill_mesh = None
        elif ep * tp > 1:  # decode on whole parameters
            model = transformer.unshard(model)
        if model is not None:
            out = decode.generate(model, prompt, args.generate,
                                  temperature=args.temperature,
                                  generator=torch.Generator(device=dev)
                                  .manual_seed(args.seed + 1),
                                  top_k=args.top_k, top_p=args.top_p,
                                  prefill_mesh=prefill_mesh)
            cont = out[0, plen:].cpu().numpy()
            want = first[plen:].cpu().numpy()
            n = int((want >= 0).sum())  # the corpus may end mid-way
            acc = float((cont[:n] == want[:n]).mean()) if n \
                else float("nan")
            if rank == 0:
                print(f"generate: {args.generate} tokens, pattern accuracy "
                      f"{acc:.2f}: {cont[:24].tolist()}", flush=True)
    finish(store)
    return {"axes": axes, "heads": heads, "losses": losses}


if __name__ == "__main__":
    main()
