"""The train job: the port's Adam step (``create_train_state``,
``make_train_step``, over a ``dp`` mesh where there are ranks) fed by its
``DeviceLoader`` over a ``ShardedDataset`` in the store.

Set-up builds the one step object and drives it, through the loader and
the step the window uses, through the first ``checked_steps`` steps:
their losses, each leaf's first gradient (from Adam's first moment after
step one) and each leaf's change after the last are kept for the judge.
``warmup_steps`` more follow; then the window. The reference follows the
checked steps after the window, once the program's state is freed.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark import corpus, harness, reference, weights
from benchmark.harness import Context

KIND = "train"


def _grad1_norms(model, opt) -> Dict[str, float]:
    """Each leaf's first gradient as the optimizer got it: Adam's first
    moment after one step is (1 - b1) times it (0 where the step made
    none)."""
    b1 = opt.param_groups[0]["betas"][0]
    out = {}
    for k, p in model.named_parameters():
        m = opt.state.get(p, {}).get("exp_avg")
        out[k] = 0.0 if m is None else float(torch.linalg.vector_norm(
            m, dtype=torch.float64)) / (1 - b1)
    return out


def _change_norms(ctx: Context, model) -> Dict[str, float]:
    p0 = weights.make(ctx.model, ctx.seed, ctx.dev)
    with torch.no_grad():
        return {k: float(torch.linalg.vector_norm(
            p.detach() - p0[k], dtype=torch.float64))
            for k, p in model.named_parameters()}


def run(ctx: Context) -> Dict:
    from ddstore_tpu_torch.data.loader import DeviceLoader
    from ddstore_tpu_torch.models import transformer as tr
    from ddstore_tpu_torch.parallel.mesh import make_mesh

    t, w = ctx.traffic, ctx.workload
    group = harness.launch(ctx)
    harness.mark(ctx, "launched")
    store, ds = harness.make_store(ctx, group)
    harness.mark(ctx, "corpus in the store")
    model = harness.make_model(ctx)
    mesh = make_mesh({"dp": ctx.world}) if ctx.world > 1 else None
    state, opt = tr.create_train_state(model, lr=t["lr"], mesh=mesh)
    step_fn = tr.make_train_step(model, opt, state=state, mesh=mesh)
    harness.mark(ctx, "model and optimizer made")
    pos = harness.positions(ctx)
    order = harness.rank_order(ctx)
    loader = DeviceLoader(ds, order, t["rows"], device=ctx.dev)
    batches = iter(loader)

    def step(tok, tgt):
        return step_fn(tok, tgt, pos)

    checked, kept = [], []
    grad1 = {}
    for i in range(t["checked_steps"]):
        tok, tgt = next(batches)
        kept.append((tok.clone(), tgt.clone()))
        checked.append(step(tok, tgt))
        if i == 0:
            grad1 = _grad1_norms(model, opt)
            harness.mark(ctx, "first step done")
    change = _change_norms(ctx, model)
    harness.mark(ctx, "checked steps done")
    for _ in range(t["warmup_steps"]):
        tok, tgt = next(batches)
        kept.append((tok.clone(), tgt.clone()))
        step(tok, tgt)
    rec, _, rows = harness.run_window(ctx, KIND, loader, batches, step,
                                      kept, order)
    losses = [float(x) for x in checked]
    # the reference makes its own inputs: the windows the order named
    ref_batches = [corpus.windows(
        ctx.seed, torch.as_tensor(r, device=ctx.dev), t["seq"],
        ctx.model["vocab"]) for r in rows[:t["checked_steps"]]]
    del batches, loader, step_fn, state, opt, model
    harness.free(ctx, store)

    gp = None
    if ctx.world > 1:
        import torch.distributed as dist
        gp = dist.group.WORLD
    t0 = time.perf_counter()
    ref_losses, ref_grad1, ref_change = reference.train(
        ctx.model, lambda: weights.make(ctx.model, ctx.seed, ctx.dev),
        ref_batches, t["lr"], w["ref_rows"], "f32", gp)
    rec["reference_s"] = time.perf_counter() - t0
    rec["judge"] = judge(losses, grad1, change, ref_losses, ref_grad1,
                         ref_change)
    return rec


def judge(losses, grad1, change, ref_losses, ref_grad1, ref_change
          ) -> Dict[str, float]:
    """The numbers compared: the widest relative gap of a step's loss,
    and the worst leaf's gap of the first gradient's norm and of the
    change's norm (over the leaves the reference moves)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    grad_gap, grad_leaf = reference.worst_leaf_gap(grad1, ref_grad1)
    keep = reference.moving_leaves(ref_grad1)
    change_gap, change_leaf = reference.worst_leaf_gap(change, ref_change,
                                                       keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_leaf": grad_leaf,
            "change_leaf": change_leaf,
            "losses": losses, "ref_losses": ref_losses,
            "leaves_left_out": len(ref_grad1) - len(keep)}
