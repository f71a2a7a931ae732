"""The train job of DeepSeek-V3's block (``configs/moonlight-16b-a3b.json``):
the port's ``TransformerLM`` with latent attention, RMSNorm, rope, a
SwiGLU dense layer and held experts, through ``create_train_state``,
``make_train_step`` and its ``DeviceLoader`` over a ``ShardedDataset`` in
the store, as ``train.py`` runs the GPT block.

Set-up drives the step through its first ``checked_steps`` steps and keeps
their losses, each leaf's first gradient and change, and step 1's
assignment counts of every expert layer over all the layer's experts;
``warmup_steps`` more follow; then the window, and in a traced run
``trace_steps`` more under the profiler, whose record also holds the
program's ``ddstore:`` spans on the device's clock (``spans.py``). The
held experts' counters (assignments a step, tokens a held expert) are
read over the window and over the traced steps. The reference
(``reference_moonlight.py``) follows the checked steps after the window,
once the program's state is freed.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import corpus, harness, reference_moonlight, weights_moonlight
from benchmark.harness import Context, Window
from benchmark.jobs.train import _grad1_norms, judge
from benchmark.spans import reduce_spans
from benchmark.trace import Tracer, reduce_events

KIND = "train"


def make_model(ctx: Context):
    """The port's ``TransformerLM`` with the configuration's DeepSeek-V3
    options, holding the seed's weights (the selection biases at 0)."""
    from ddstore_tpu_torch.models import transformer as tr
    from ddstore_tpu_torch.models.moe import RoutedSpec

    m = ctx.model
    spec = tr.DeepSeekSpec(
        mla=tr.MlaSpec(m["kv_rank"], m["qk_nope"], m["qk_rope"],
                       m["v_dim"]),
        routed=RoutedSpec(m["experts"], m["top_k"], m["expert_hidden"],
                          held=tuple(m["held"]), shared=m["shared"],
                          scale=m["scale"], bias_rate=m["bias_rate"],
                          balance=m["balance"]),
        dense_hidden=m["dense_hidden"], dense_layers=m["dense_layers"],
        norm_eps=m["norm_eps"], rope_theta=m["rope_theta"])
    model = tr.TransformerLM(
        vocab=m["vocab"], dim=m["dim"], heads=m["heads"],
        layers=m["layers"], compute_dtype=harness.DTYPES[m["compute_dtype"]],
        device=ctx.dev, deepseek=spec)
    missing, unexpected = model.load_state_dict(
        weights_moonlight.make(m, ctx.seed, ctx.dev), strict=False)
    if unexpected or not all(k.endswith("score_bias") for k in missing):
        raise KeyError(f"the weights' layout and the model disagree: "
                       f"missing {missing}, unexpected {unexpected}")
    return model


def _routed_counts(model) -> List[List[int]]:
    """Each expert layer's assignment counts of its last forward."""
    from ddstore_tpu_torch.models.moe import RoutedExperts
    return [m.stats["counts"].tolist() for m in model.modules()
            if isinstance(m, RoutedExperts)]


def _held(before: Dict, after: Dict, steps: int, experts: int) -> Dict:
    """The held experts' counters over ``steps`` steps: assignments a
    step (summed over the expert layers), and tokens a held expert in one
    layer's forward, the most and the mean."""
    fwd = max(1, after["forwards"] - before["forwards"])
    n = after["assignments"] - before["assignments"]
    return {"held_per_step": n / max(1, steps),
            "tokens_per_expert_max": after["max_per_expert"],
            "tokens_per_expert_mean": n / (fwd * experts)}


def _traced_tail(ctx: Context, batches, step, w: Window) -> Dict:
    """``harness.trace_tail`` with the program's spans reduced too; returns
    the held counters over the traced steps."""
    from ddstore_tpu_torch.models.moe import held_counters

    n = ctx.traffic["trace_steps"]
    warm = Tracer(1)
    warm.start()
    harness._run_step(w, batches, step, warm)
    warm.close()
    harness.barrier(ctx)
    before = held_counters(reset=True)
    tracer = Tracer(n)
    tracer.start()
    for _ in range(n):
        harness._run_step(w, batches, step, tracer)
    harness.sync(ctx)
    tracer.prof.stop()
    events = tracer.prof.events()
    w.trace = reduce_events(events, n)
    w.trace["spans"] = reduce_spans(events, n)
    ctx.log(f"spans (ms a traced step): {json.dumps(w.trace['spans'])}")
    return _held(before, held_counters(), n, ctx.model["held"][1])


def run_window(ctx: Context, loader, batches, step, kept: List[tuple],
               order: np.ndarray) -> tuple:
    """``harness.run_window`` with the held counters and the spans:
    (the rank's record, the index rows of every batch)."""
    from ddstore_tpu_torch.models.moe import held_counters

    harness.barrier(ctx)
    setup_s = time.perf_counter() - ctx.t_start
    peak_setup = harness.peak_memory(ctx)
    if ctx.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.dev)
    launches0 = harness.flash_launches()
    marks = harness.loader_marks(loader)
    held0 = held_counters(reset=True)

    win = harness.measure(ctx, batches, step)

    held = _held(held0, held_counters(), win.steps, ctx.model["held"][1])
    ctx.log(f"held experts over the window: {json.dumps(held)}")
    peak_window = harness.peak_memory(ctx)
    launches = {k: v - launches0[k]
                for k, v in harness.flash_launches().items()}
    lw = harness.loader_window(loader, marks)
    held_traced = _traced_tail(ctx, batches, step, win) if ctx.trace \
        else None
    batches.close()
    outputs = torch.stack(win.outputs).float().cpu().numpy()
    t = ctx.traffic
    nb = len(kept) + len(win.batches)
    rows = order[:nb * t["rows"]].reshape(nb, t["rows"])
    mismatch = harness.expected_mismatch(ctx, rows, kept + win.batches)
    kept.clear()
    rec = {"kind": KIND, "steps": win.steps, "window_s": win.window_s,
           "step_ms": win.step_ms, "tokens_per_step": t["rows"] * t["seq"],
           "setup_s": setup_s, "peak_window_bytes": peak_window,
           "peak_bytes": max(peak_setup, peak_window),
           "launches": launches, "fetch_s": lw["fetch_s"],
           "wait_s": lw["wait_s"], "trace": win.trace,
           "moe": held, "moe_traced": held_traced,
           "attempted": win.steps,
           "failed": int((~np.isfinite(outputs[:win.steps])).sum()),
           "batch_mismatch": mismatch}
    return rec, rows


def run(ctx: Context) -> Dict:
    from ddstore_tpu_torch.data.loader import DeviceLoader
    from ddstore_tpu_torch.models import transformer as tr

    # a port without DeepSeek-V3's block fails here, before any set-up
    from ddstore_tpu_torch.models.transformer import DeepSeekSpec  # noqa

    t, m = ctx.traffic, ctx.model
    if ctx.world != 1:
        raise ValueError("the held-expert cell runs on one rank: it is one "
                         "rank of an expert-parallel deployment")
    group = harness.launch(ctx)
    harness.mark(ctx, "launched")
    store, ds = harness.make_store(ctx, group)
    harness.mark(ctx, "corpus in the store")
    model = make_model(ctx)
    state, opt = tr.create_train_state(model, lr=t["lr"])
    step_fn = tr.make_train_step(model, opt, state=state)
    harness.mark(ctx, "model and optimizer made")
    pos = harness.positions(ctx)
    order = harness.rank_order(ctx)
    loader = DeviceLoader(ds, order, t["rows"], device=ctx.dev)
    batches = iter(loader)

    def step(tok, tgt):
        return step_fn(tok, tgt, pos)

    checked, kept = [], []
    grad1, counts1 = {}, []
    for i in range(t["checked_steps"]):
        tok, tgt = next(batches)
        kept.append((tok.clone(), tgt.clone()))
        checked.append(step(tok, tgt))
        if i == 0:
            grad1 = _grad1_norms(model, opt)
            counts1 = _routed_counts(model)
            harness.mark(ctx, "first step done")
    change = _change_norms_moonlight(ctx, model)
    harness.mark(ctx, "checked steps done")
    for _ in range(t["warmup_steps"]):
        tok, tgt = next(batches)
        kept.append((tok.clone(), tgt.clone()))
        step(tok, tgt)
    rec, rows = run_window(ctx, loader, batches, step, kept, order)
    losses = [float(x) for x in checked]
    ref_batches = [corpus.windows(
        ctx.seed, torch.as_tensor(r, device=ctx.dev), t["seq"], m["vocab"])
        for r in rows[:t["checked_steps"]]]
    del batches, loader, step_fn, state, opt, model
    harness.free(ctx, store)

    t0 = time.perf_counter()
    ref_losses, ref_grad1, ref_change, ref_counts = \
        reference_moonlight.train(
            m, lambda: weights_moonlight.make(m, ctx.seed, ctx.dev),
            ref_batches, t["lr"])
    rec["reference_s"] = time.perf_counter() - t0
    rec["judge"] = judge_moonlight(
        (losses, grad1, change, counts1),
        (ref_losses, ref_grad1, ref_change, ref_counts))
    return rec


def judge_moonlight(prog: tuple, ref: tuple) -> Dict:
    """``train.py``'s numbers and ``routing_gap`` of the program's (losses,
    first-gradient norms, change norms, step 1's counts) against the
    reference's: what the run's limits are held to, and what
    ``control_moonlight`` reads its faults with."""
    out = judge(*prog[:3], *ref[:3])
    out["routing_gap"] = reference_moonlight.routing_gap(prog[3], ref[3])
    return out


def _change_norms_moonlight(ctx: Context, model) -> Dict[str, float]:
    """Each leaf's change from the seed's weights (``train.py``'s, on this
    configuration's layout)."""
    p0 = weights_moonlight.make(ctx.model, ctx.seed, ctx.dev)
    with torch.no_grad():
        return {k: float(torch.linalg.vector_norm(
            p.detach() - p0[k], dtype=torch.float64))
            for k, p in model.named_parameters()}

