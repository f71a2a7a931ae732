"""Input-pipeline metrics (the part of ``ddstore_tpu/utils/metrics.py``
the loader needs): latency histograms and the input-pipeline efficiency,
the fraction of an epoch's wall clock the consumer did not spend waiting
for a batch."""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

__all__ = ["LatencyHistogram", "PipelineMetrics"]


class LatencyHistogram:
    """Streaming latency recorder with percentile summaries. Thread-safe:
    the loader's worker pool records fetch/stage latencies concurrently."""

    def __init__(self, name: str = "latency", max_samples: int = 1 << 16):
        self.name = name
        self.max_samples = max_samples
        self._samples: List[float] = []
        self._mu = threading.Lock()
        self.count = 0
        self.total = 0.0

    def record(self, seconds: float) -> None:
        with self._mu:
            self.count += 1
            self.total += seconds
            if len(self._samples) < self.max_samples:
                self._samples.append(seconds)
            else:  # reservoir sampling keeps percentiles honest on long runs
                j = random.randrange(self.count)
                if j < self.max_samples:
                    self._samples[j] = seconds

    def timed(self):
        """Context manager: ``with hist.timed(): ...``"""
        return _Timer(self)

    def percentile(self, q: float) -> float:
        with self._mu:
            xs = sorted(self._samples)
        if not xs:
            return 0.0
        k = min(len(xs) - 1, max(0, int(round(q / 100 * (len(xs) - 1)))))
        return xs[k]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean_s": self.mean,
            "p50_s": self.percentile(50),
            "p95_s": self.percentile(95),
            "p99_s": self.percentile(99),
        }


class _Timer:
    def __init__(self, hist: LatencyHistogram):
        self.hist = hist

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.record(time.perf_counter() - self.t0)


class PipelineMetrics:
    """Input-pipeline efficiency: the loader records how long each
    ``__next__`` blocked (``wait``), the host gather (``fetch``) and the
    copy to the device (``stage``); efficiency = 1 - wait / epoch wall
    time."""

    def __init__(self):
        self.wait = LatencyHistogram("device_wait")
        self.fetch = LatencyHistogram("host_fetch")
        self.stage = LatencyHistogram("device_put")
        self._t_start: Optional[float] = None
        self._t_end: Optional[float] = None

    def epoch_start(self) -> None:
        self._t_start = time.perf_counter()
        self._t_end = None

    def epoch_end(self) -> None:
        self._t_end = time.perf_counter()

    @property
    def total_s(self) -> float:
        if self._t_start is None:
            return 0.0
        end = self._t_end if self._t_end is not None else time.perf_counter()
        return end - self._t_start

    @property
    def efficiency(self) -> float:
        total = self.total_s
        if total <= 0:
            return 1.0
        return max(0.0, 1.0 - self.wait.total / total)

    def summary(self) -> Dict:
        return {
            "input_pipeline_efficiency": self.efficiency,
            "total_s": self.total_s,
            "device_wait": self.wait.summary(),
            "host_fetch": self.fetch.summary(),
            "device_put": self.stage.summary(),
        }
