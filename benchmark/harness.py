"""What the jobs share: the run's context, the program's set-up (the
store holding the corpus, the loader over it, the model with the seed's
weights) and the measured window.

The program is entered through its public modules only:
``ddstore_tpu_torch.store``, ``data.dataset``, ``data.loader``,
``models.transformer``, ``parallel.mesh``, ``ops.attention``'s launch
counters and ``examples._launch`` (one card a rank, the store's file
rendezvous, NCCL between cards).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import corpus, weights
from .trace import Tracer

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


@dataclasses.dataclass
class Context:
    """One rank's view of a run."""

    cell: Dict
    seed: int
    seconds: float
    trace: bool
    device: str
    rank: int
    world: int
    t_start: float
    dev: Optional[torch.device] = None
    gloo = None  # a host-side group of the ranks, for the stop flag
    log: Callable = print

    @property
    def model(self) -> Dict:
        return self.cell["config"]["model"]

    @property
    def traffic(self) -> Dict:
        return self.cell["traffic"]

    @property
    def workload(self) -> Dict:
        return self.cell["workload"]


def mark(ctx: Context, what: str) -> None:
    """Log how far into the run set-up has come (standard error)."""
    ctx.log(f"rank {ctx.rank}: {what} at "
            f"{time.perf_counter() - ctx.t_start:.3f} s")


def launch(ctx: Context):
    """Join the store's group and, over ranks, a ``torch.distributed`` job
    (NCCL between cards, gloo on the CPU), as the port's examples do; a
    gloo group of the same ranks carries the window's stop flag. Returns
    the store's group."""
    from ddstore_tpu_torch.examples._launch import launch as port_launch

    group, _ddp, dev = port_launch(ctx.device)
    ctx.dev = dev
    if ctx.world > 1:
        import torch.distributed as dist
        ctx.gloo = dist.new_group(backend="gloo")
    return group


def make_store(ctx: Context, group):
    """The store over the ranks and this rank's shard of the corpus:
    ``shard_windows`` windows of ``seq`` tokens and their targets (int32),
    global rows ``[rank * shard_windows, (rank + 1) * shard_windows)``.
    Returns (store, dataset)."""
    from ddstore_tpu_torch.data.dataset import ShardedDataset
    from ddstore_tpu_torch.store import DDStore

    t = ctx.traffic
    n, seq = t["shard_windows"], t["seq"]
    toks, tgts = corpus.shard(ctx.seed, ctx.rank * n, n, seq,
                              ctx.model["vocab"], ctx.dev)
    store = DDStore(group)
    ds = ShardedDataset(store, toks, tgts, name="corpus", pre_sharded=True)
    return store, ds


def make_model(ctx: Context):
    """The port's ``TransformerLM`` at the configuration's widths, holding
    the seed's weights."""
    from ddstore_tpu_torch.models import transformer as tr

    m = ctx.model
    model = tr.TransformerLM(vocab=m["vocab"], dim=m["dim"],
                             heads=m["heads"], layers=m["layers"],
                             mlp_ratio=m["mlp_ratio"],
                             compute_dtype=DTYPES[m["compute_dtype"]],
                             device=ctx.dev)
    model.load_state_dict(weights.make(m, ctx.seed, ctx.dev))
    return model


def rank_order(ctx: Context) -> np.ndarray:
    """This rank's index order: rank r takes positions r, r + world, ...
    of the run's global order over every rank's windows."""
    total = ctx.traffic["shard_windows"] * ctx.world
    return corpus.order(ctx.seed, total, ctx.traffic["order"])[
        ctx.rank::ctx.world]


def positions(ctx: Context) -> torch.Tensor:
    t = ctx.traffic
    return torch.arange(t["seq"], dtype=torch.int32,
                        device=ctx.dev).expand(t["rows"], t["seq"])


def sync(ctx: Context) -> None:
    if ctx.dev.type == "cuda":
        torch.cuda.synchronize(ctx.dev)


def barrier(ctx: Context) -> None:
    sync(ctx)
    if ctx.world > 1:
        import torch.distributed as dist
        dist.barrier(group=ctx.gloo)


def _agree(ctx: Context, stop: bool) -> bool:
    """Rank 0's decision, on every rank (the ranks' steps are collective,
    so every rank has to run as many)."""
    if ctx.world == 1:
        return stop
    import torch.distributed as dist
    flag = torch.tensor([int(stop)])
    dist.broadcast(flag, 0, group=ctx.gloo)
    return bool(flag.item())


def _event(ctx: Context):
    if ctx.dev.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed_ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


@dataclasses.dataclass
class Window:
    """What the measured window ran: its steps, their outputs and
    batches (a traced run's extra steps' too), the time between step
    ends, the host window, the reduced trace."""

    steps: int = 0
    window_s: float = 0.0
    step_ms: List[float] = dataclasses.field(default_factory=list)
    outputs: List[torch.Tensor] = dataclasses.field(default_factory=list)
    batches: List[tuple] = dataclasses.field(default_factory=list)
    trace: Dict = dataclasses.field(default_factory=dict)


def _run_step(w: "Window", batches, step: Callable,
              tracer: Optional[Tracer] = None) -> None:
    span = tracer.span if tracer else lambda _: contextlib.nullcontext()
    with span("next_batch"):
        tok, tgt = next(batches)
    w.batches.append((tok.clone(), tgt.clone()))
    with span("step"):
        w.outputs.append(step(tok, tgt))


def measure(ctx: Context, batches, step: Callable) -> Window:
    """Run ``step(tokens, targets)`` on the loader's batches until the
    host clock has passed ``ctx.seconds`` (rank 0's clock, over ranks),
    then wait for the device. Every step's output (a device scalar) and
    batch are kept for the judge; an event after each step gives the time
    between step ends on the device, with no wait on the host."""
    w = Window()
    ends = []
    barrier(ctx)
    start = _event(ctx)
    t0 = time.perf_counter()
    while True:
        _run_step(w, batches, step)
        ends.append(_event(ctx))
        w.steps += 1
        if _agree(ctx, time.perf_counter() - t0 >= ctx.seconds):
            break
    sync(ctx)
    w.window_s = time.perf_counter() - t0
    w.step_ms = [_elapsed_ms(a, b) for a, b in zip([start] + ends, ends)]
    return w


def trace_tail(ctx: Context, batches, step: Callable, w: Window) -> None:
    """In a traced run, profile ``trace_steps`` (the traffic's) more steps
    after the window, from a drained device to a drained device, keeping
    their outputs and batches with the window's. One step under a
    throwaway profile first sets the profiler up."""
    if not ctx.trace:
        return
    n = ctx.traffic["trace_steps"]
    warm = Tracer(1)
    warm.start()
    _run_step(w, batches, step, warm)
    warm.close()
    barrier(ctx)
    tracer = Tracer(n)
    tracer.start()
    for _ in range(n):
        _run_step(w, batches, step, tracer)
    w.trace = tracer.close()


def expected_mismatch(ctx: Context, rows: np.ndarray, batches: List[tuple]
                      ) -> int:
    """How many of the batches' rows differ from the windows the index
    order named (``rows``, one row of indices a batch)."""
    bad = 0
    for idx, (tok, tgt) in zip(rows, batches):
        want_t, want_g = corpus.windows(
            ctx.seed, torch.as_tensor(idx, device=tok.device),
            ctx.traffic["seq"], ctx.model["vocab"])
        bad += int(((tok != want_t) | (tgt != want_g)).any(dim=1).sum())
    return bad


def peak_memory(ctx: Context) -> int:
    """Bytes at the allocator's peak since its last reset (0 off the
    card)."""
    if ctx.dev.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(ctx.dev))


def flash_launches() -> Dict[str, int]:
    from ddstore_tpu_torch.ops import attention
    return {"fwd": attention.flash_fwd_launches,
            "dq": attention.flash_bwd_dq_launches,
            "dkv": attention.flash_bwd_dkv_launches}


def run_window(ctx: Context, kind: str, loader, batches, step: Callable,
               kept: List[tuple], order: np.ndarray) -> tuple:
    """Close set-up, measure the window (and trace after it), and check
    every batch, set-up's ``kept`` ones and the window's, against the
    windows the index order named. Returns (the rank's record, the
    window's outputs on the host, the index rows of every batch); the
    loader's iterator is closed and the batches are dropped."""
    barrier(ctx)
    setup_s = time.perf_counter() - ctx.t_start
    peak_setup = peak_memory(ctx)
    if ctx.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.dev)
    launches0 = flash_launches()
    marks = loader_marks(loader)

    win = measure(ctx, batches, step)

    peak_window = peak_memory(ctx)
    launches = {k: v - launches0[k] for k, v in flash_launches().items()}
    lw = loader_window(loader, marks)
    trace_tail(ctx, batches, step, win)
    batches.close()
    outputs = torch.stack(win.outputs).float().cpu().numpy()
    t = ctx.traffic
    nb = len(kept) + len(win.batches)
    rows = order[:nb * t["rows"]].reshape(nb, t["rows"])
    mismatch = expected_mismatch(ctx, rows, kept + win.batches)
    kept.clear()
    rec = {"kind": kind, "steps": win.steps, "window_s": win.window_s,
           "step_ms": win.step_ms, "tokens_per_step": t["rows"] * t["seq"],
           "setup_s": setup_s, "peak_window_bytes": peak_window,
           "peak_bytes": max(peak_setup, peak_window),
           "launches": launches, "fetch_s": lw["fetch_s"],
           "wait_s": lw["wait_s"], "trace": win.trace,
           "attempted": win.steps,
           "failed": int((~np.isfinite(outputs[:win.steps])).sum()),
           "batch_mismatch": mismatch}
    return rec, outputs, rows


def free(ctx: Context, store) -> None:
    """Close the store and hand the allocator's cached blocks back, once
    the program's state is dropped, before the reference runs."""
    store.close()
    if ctx.dev.type == "cuda":
        torch.cuda.empty_cache()


def loader_marks(loader) -> Dict:
    """Where the loader's fetch and wait records stand (to read the
    window's share of them later)."""
    m = loader.metrics
    return {"fetch_n": len(m.fetch._samples), "wait_total": m.wait.total}


def loader_window(loader, marks: Dict) -> Dict:
    """The loader's fetch times recorded since ``marks`` and the seconds
    the consumer waited for batches since then."""
    m = loader.metrics
    return {"fetch_s": list(m.fetch._samples[marks["fetch_n"]:]),
            "wait_s": m.wait.total - marks["wait_total"]}
