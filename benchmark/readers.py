"""The run's record as the metric readers see it (``metrics/*.py``).

A reader is a module with ``KIND`` (``"end_to_end"`` or ``"per_layer"``),
``UNIT``, ``BETTER``, ``SOURCE``, for a per-layer metric ``LAYER`` and
``MOVES`` (the end-to-end metric it should move), and ``read(run)``,
which returns the metric's value or None where the run has nothing for
it to read. It never returns 0 for a share of a roofline or a peak.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from benchmark import arith


class Run:
    """One run of a cell: its files and every rank's record."""

    def __init__(self, cell: Dict, records: List[Dict], device: str):
        self.cell = cell
        self.records = records
        self.device = device
        self.kind = records[0]["kind"]
        self.world = len(records)
        self.chips = int(cell["workload"]["chips"])

    @property
    def model(self) -> Dict:
        return self.cell["config"]["model"]

    @property
    def traffic(self) -> Dict:
        return self.cell["traffic"]

    @property
    def device_kind(self) -> str:
        if self.device != "cuda":
            return "cpu"
        import torch
        return torch.cuda.get_device_name(0)

    @property
    def on_card(self) -> bool:
        return self.device == "cuda"

    @property
    def steps(self) -> int:
        return self.records[0]["steps"]

    @property
    def window_s(self) -> float:
        """The measured window: the longest of the ranks'."""
        return max(r["window_s"] for r in self.records)

    @property
    def tokens(self) -> int:
        """Tokens the ranks' steps processed in the window, summed."""
        return sum(r["steps"] * r["tokens_per_step"] for r in self.records)

    def step_ms(self) -> np.ndarray:
        """The time between consecutive step ends, each step's the slowest
        rank's."""
        return np.max(np.array([r["step_ms"] for r in self.records]), 0)

    def model_flops_per_step(self) -> float:
        """Model FLOPs of one train step of one rank at the cell's
        shapes."""
        m, t = self.model, self.traffic
        return arith.lm_flops_per_step(m["vocab"], m["dim"], m["layers"],
                                       t["rows"], t["seq"])

    def traces(self) -> Optional[List[Dict]]:
        """Every rank's reduced trace, or None where the run was not
        traced or its trace holds no device time."""
        ts = [r["trace"] for r in self.records]
        if not all(t and t["busy_s"] > 0 for t in ts):
            return None
        return ts

    def flash_roofline(self, kinds) -> Optional[float]:
        """Percent: the bound of the traced launches of the flash kernels
        ``kinds`` (``"fwd"``, ``"dq"``, ``"dkv"``) over their device time,
        summed over the ranks."""
        from benchmark.trace import kernel_seconds

        ts = self.traces()
        if ts is None or not self.on_card:
            return None
        bounds = arith.flash_bounds_ms(self.model, self.traffic["rows"],
                                       self.traffic["seq"])
        need, took = 0.0, 0.0
        for t in ts:
            for k in kinds:
                sec, n = kernel_seconds(t["by_name"], "flash_" + {
                    "fwd": "fwd", "dq": "bwd_dq", "dkv": "bwd_dkv"}[k])
                need += n * bounds[k] / 1e3
                took += sec
        if took <= 0:
            return None
        return 100.0 * need / took
