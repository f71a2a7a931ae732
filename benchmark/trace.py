"""The traced run: a ``torch.profiler`` trace of a few whole steps right
after the measured window, reduced to what the per-layer metrics and the
breakdown read. Tracing them after the window keeps the profiler's
start and its reduction out of the window's rates.

``busy`` is a frozen copy of ``chip_smoke.py``'s ``device_busy``: the
union of the device's kernel and copy intervals, leaving out the
profiler's user annotations on the device track and any device event
named like a host one. The traced window runs from the first device
event of the traced steps to the last; each idle gap in it is named by
what the host's main thread was doing at its middle: the benchmark's own
span (``bench:next_batch``, ``bench:step``) and the innermost operation
open under it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

SPAN_PREFIX = "bench:"


def kernel_name(name: str) -> str:
    """A device event's name without a leading return type or an
    anonymous namespace: ``flash_fwd_wgmma_kernel<64, ...>(...)``."""
    name = name[5:] if name.startswith("void ") else name
    return name.replace("(anonymous namespace)::", "")


class Tracer:
    """A profiler over whole steps: :meth:`start` after the device has
    drained, :meth:`span` around the calls into the program, :meth:`close`
    after the last step, which waits for the device before the profiler
    stops, so the trace holds exactly the steps run in between."""

    def __init__(self, steps: int):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            self.acts.append(ProfilerActivity.CUDA)
        self.steps = steps
        self.prof = profile(activities=self.acts)

    def start(self) -> None:
        self.prof.start()

    def span(self, name: str):
        import torch
        return torch.profiler.record_function(SPAN_PREFIX + name)

    def close(self) -> Dict:
        """The reduced trace."""
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        return reduce_events(self.prof.events(), self.steps)


def _union(intervals: List[Tuple[float, float]]
           ) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, the gaps between the covered stretches) of
    intervals."""
    busy, end, gaps = 0.0, None, []
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, gaps


def _host_at(cpu: List, t: float) -> str:
    """What the main thread was doing at time ``t``: the benchmark's span
    open there and the innermost operation open under it."""
    covering = [e for e in cpu if e[1] <= t <= e[2]]
    spans = [e for e in covering if e[0].startswith(SPAN_PREFIX)]
    if not spans:
        inner = max(covering, key=lambda e: e[1], default=None)
        return "outside the step" if inner is None else inner[0]
    span = min(spans, key=lambda e: e[1])
    inner = max((e for e in covering if e[3] == span[3]),
                key=lambda e: e[1])
    return span[0] if inner is span else f"{span[0]} / {inner[0]}"


def reduce_events(events, traced_steps: int, top: int = 10) -> Dict:
    """``{"busy_s", "window_s", "steps", "by_name": {kernel: [s, n]},
    "idle_gaps": [[what, s], ...]}`` of a profile's events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host = {e.name for e in events if e.device_type != cuda}
    work = [e for e in events if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and e.name not in host]
    by_name: Dict[str, List] = {}
    spans = []
    for e in work:
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        rec = by_name.setdefault(kernel_name(e.name), [0.0, 0])
        rec[0] += (b - a) / 1e6
        rec[1] += 1
    if not spans:
        return {"busy_s": 0.0, "window_s": 0.0, "steps": traced_steps,
                "by_name": {}, "idle_gaps": []}
    busy, gaps = _union(spans)
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    cpu = [(e.name, e.time_range.start, e.time_range.end, e.thread)
           for e in events if e.device_type != cuda]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle = [[_host_at(cpu, (a + b) / 2), (b - a) / 1e6] for a, b in longest]
    return {"busy_s": busy / 1e6, "window_s": window / 1e6,
            "steps": traced_steps, "by_name": by_name, "idle_gaps": idle}


def top_ops(by_name: Dict[str, List], top: int = 10) -> List[List]:
    """The ``top`` device operations by time, ``[[name, seconds], ...]``,
    names cut to 160 characters."""
    rows = sorted(by_name.items(), key=lambda r: -r[1][0])[:top]
    return [[k[:160], v[0]] for k, v in rows]


def kernel_seconds(by_name: Dict[str, List], prefix: str) -> Tuple[float,
                                                                   int]:
    """(seconds, launches) of the kernels whose names begin ``prefix``."""
    s, n = 0.0, 0
    for k, (sec, cnt) in by_name.items():
        if k.startswith(prefix):
            s += sec
            n += cnt
    return s, n
