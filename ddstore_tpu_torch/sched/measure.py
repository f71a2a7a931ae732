"""Warm-window measurement substrate — Python mirror of the native
contract (``native/measure.h``; the port's copy of
``ddstore_tpu/sched/measure.py``).

Three tuners used to carry private copies of the same sample hygiene
(the CMA/TCP router, the lane autotuner, the hand-tuned readahead
knobs); the rules now live in exactly two files that implement ONE
contract: ``native/measure.h`` for the in-transport tuners (they fold on
the read hot path and cannot call into Python) and this module for
host-side sample sources (the readahead engine's window-fetch timings,
the planner's delivered-throughput tracking). ``tests/test_torch_sched.py``
pins this copy to the reference's fold for fold.

The contract, in fold order (see measure.h for the full rationale):

1. **Dial-taint discard** — a window that included a connection dial
   timed the handshake, not the transport; discarded while the cell has
   no clean sample, bounded by a per-tuner skip budget.
2. **First-window (warm-up) discard** — each cell's first surviving
   window timed the path waking, not running.
3. **Paired-probe discard** — a steady-state probe pair's first window
   only re-warms the idle path; the caller arms a one-shot discard the
   fold consumes.
4. **EWMA fold** — survivors fold at ``WARM_EWMA_ALPHA`` (the first
   sample seeds the estimate outright).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: Clean samples a cell needs before a verdict may be read off it
#: (mirrors ``kWarmMinSamples``).
WARM_MIN_SAMPLES = 2
#: Dial-taint discards allowed per tuner before tainted numbers are
#: accepted anyway (mirrors ``kWarmMaxColdSkips``).
WARM_MAX_COLD_SKIPS = 4
#: EWMA smoothing: new = alpha * old + (1 - alpha) * sample (mirrors
#: ``kWarmEwmaAlpha``).
WARM_EWMA_ALPHA = 0.5


class Fold(enum.Enum):
    """Outcome of one :func:`fold_warm_sample` (mirrors ``WarmFold``)."""

    FOLDED = 0
    DROP_COLD = 1
    DROP_WARMUP = 2
    DROP_PROBE = 3


@dataclass
class ColdSkipBudget:
    """Per-TUNER dial-taint discard budget (rule 1). Shared across a
    tuner's cells — not per-cell — so a flapping peer cannot spend the
    budget once per knob level."""

    skips: int = 0


@dataclass
class ProbeDiscard:
    """One-shot armed discard for the probe pair's warm-up window
    (rule 3). The caller arms it when dispatching the pair's first
    window; the fold consumes it."""

    armed: bool = False


@dataclass
class WarmStat:
    """One warm-window estimator cell: a (traffic class, knob value)
    pair's throughput estimate plus its hygiene state."""

    ewma: float = 0.0  # bytes/s estimate; 0 = no clean sample yet
    n: int = 0         # clean samples folded
    warmed: bool = False  # warm-up window consumed (rule 2)

    def reset(self) -> None:
        self.ewma = 0.0
        self.n = 0
        self.warmed = False


def fold_warm_sample(stat: WarmStat, value: float, cold: bool = False,
                     budget: Optional[ColdSkipBudget] = None,
                     discard: Optional[ProbeDiscard] = None) -> Fold:
    """Fold one measured window into ``stat`` under the shared hygiene
    contract. Keep in lockstep with ``FoldWarmSample`` in measure.h —
    rule ORDER included (cold, warm-up, probe, fold)."""
    if cold and stat.n == 0 and budget is not None \
            and budget.skips < WARM_MAX_COLD_SKIPS:
        budget.skips += 1
        return Fold.DROP_COLD
    if not stat.warmed:
        stat.warmed = True
        return Fold.DROP_WARMUP
    if discard is not None and discard.armed:
        discard.armed = False
        return Fold.DROP_PROBE
    stat.ewma = value if stat.ewma == 0.0 else \
        WARM_EWMA_ALPHA * stat.ewma + (1.0 - WARM_EWMA_ALPHA) * value
    stat.n += 1
    return Fold.FOLDED


@dataclass
class _TunerCells:
    budget: ColdSkipBudget = field(default_factory=ColdSkipBudget)
    cells: Dict[float, WarmStat] = field(default_factory=dict)


class SampleSet:
    """Host-side warm-window cells keyed by ``(source, cls, knob)``,
    with the dial-taint budget scoped per ``(source, cls)`` tuner —
    exactly the native tuners' budget scoping. Rows snapshot in the
    same layout as :meth:`NativeStore.sched_cells`, so the planner
    consumes native and host cells uniformly."""

    def __init__(self) -> None:
        self._tuners: Dict[Tuple[str, int], _TunerCells] = {}

    def fold(self, source: str, cls: int, knob: float, nbytes: int,
             secs: float, cold: bool = False) -> Fold:
        """Fold one ``nbytes``-over-``secs`` window into the cell.
        Non-positive measurements are rejected without touching hygiene
        state (same guard as the native record paths)."""
        if nbytes <= 0 or secs <= 0.0:
            return Fold.DROP_COLD
        tuner = self._tuners.setdefault((source, int(cls)), _TunerCells())
        stat = tuner.cells.setdefault(float(knob), WarmStat())
        return fold_warm_sample(stat, nbytes / secs, cold=cold,
                                budget=tuner.budget)

    def cell(self, source: str, cls: int,
             knob: float) -> Optional[WarmStat]:
        tuner = self._tuners.get((source, int(cls)))
        return tuner.cells.get(float(knob)) if tuner else None

    def cells(self) -> List[dict]:
        """Snapshot rows in :data:`ddstore_tpu_torch.binding.SCHED_CELL_COLS`
        shape (``source`` kept as its string name)."""
        out: List[dict] = []
        for (source, cls), tuner in sorted(self._tuners.items()):
            for knob, stat in sorted(tuner.cells.items()):
                out.append({"source": source, "cls": cls, "knob": knob,
                            "ewma_bps": stat.ewma, "n": stat.n})
        return out

    def reset(self) -> None:
        self._tuners.clear()
