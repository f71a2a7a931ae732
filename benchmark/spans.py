"""The program's own spans on the device's clock: a profile's device work
credited to the ``ddstore:`` ranges the port opens inside its train step
(``utils/profile.annotate``: ``ddstore:zero_grad``, ``ddstore:forward``
holding ``ddstore:head_fwd``, ``ddstore:backward`` holding
``ddstore:head_bwd``, ``ddstore:allreduce``, ``ddstore:optimizer``).

The device work is what ``trace.reduce_events`` counts as busy: kernels,
copies and memsets, without the profiler's user annotations on the
device track or device events named like host ones. Each event goes to
the innermost span open where it was launched:

* the launch is the CUDA API call (``cudaLaunchKernel``,
  ``cudaMemcpyAsync``, ``cuLaunchKernelEx``, ...) that carries the
  event's correlation id (``FunctionEvent.id``), placed by its host
  thread and start time. The profiler files such a call under the
  thread of the operation that made it; a call made outside any
  operation it recorded, as on the loader's worker threads, which it
  does not follow, keeps the system's thread id, where no span is open,
  and its work stays unattributed;
* the innermost span is the latest-opened one that is open at that time
  on the launching thread. The autograd engine runs the backward on a
  thread of its own, which opens no ``ddstore:backward``: a launch there
  with no span of its thread open, inside an
  ``autograd::engine::evaluate_function`` range, goes to the innermost
  span open then on the other threads. A span nests by the same rule,
  so ``ddstore:head_bwd``, opened on the engine's thread, nests in
  ``ddstore:backward``.

A span's ``device_ms`` is the union of the device intervals of its
events and its descendants'; ``self_ms`` leaves the descendants out. An
idle gap of the traced window (between the union's stretches) goes to
the innermost span open at its middle among those that hang from the
main thread's, the thread whose outermost spans last longest. Every
figure is milliseconds a traced step.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from .trace import _union

PREFIX = "ddstore:"
ENGINE = "autograd::engine::evaluate_function"
NONE = "none"  # the key of idle time no span was open over


class _Span:
    __slots__ = ("name", "start", "end", "thread", "parent", "events")

    def __init__(self, e):
        self.name = e.name
        self.start = e.time_range.start
        self.end = e.time_range.end
        self.thread = e.thread
        self.parent: Optional[_Span] = None
        self.events: List = []

    def lineage(self):
        s, seen = self, set()
        while s is not None and id(s) not in seen:
            seen.add(id(s))
            yield s
            s = s.parent


class _Threads:
    """The spans and the autograd engine's ranges of each host thread."""

    def __init__(self, spans: List[_Span], host: List):
        self.spans: Dict[int, List[_Span]] = {}
        for s in sorted(spans, key=lambda s: (s.start, -s.end)):
            self.spans.setdefault(s.thread, []).append(s)
        self.engine: Dict[int, tuple] = {}
        ranges: Dict[int, List] = {}
        for e in host:
            if e.name.startswith(ENGINE):
                ranges.setdefault(e.thread, []).append(
                    (e.time_range.start, e.time_range.end))
        for t, rs in ranges.items():
            stretches, end = [], None
            for a, b in sorted(rs):
                if end is None or a > end:
                    stretches.append([a, b])
                    end = b
                elif b > end:
                    stretches[-1][1] = end = b
            self.engine[t] = ([a for a, _ in stretches],
                              [b for _, b in stretches])

    def _in_engine(self, thread: int, t: float) -> bool:
        starts, ends = self.engine.get(thread, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ends[i]

    @staticmethod
    def _innermost(spans, t: float, end: Optional[float] = None,
                   stop: Optional[_Span] = None) -> Optional[_Span]:
        """The latest-opened of ``spans`` (in order of opening) open at
        ``t``, and until ``end`` if given; none from ``stop`` on."""
        inner = None
        for s in spans:
            if s is stop or s.start > t:
                break
            if s.end >= (t if end is None else end):
                inner = s
        return inner

    def open_at(self, thread: int, t: float, end: Optional[float] = None,
                stop: Optional[_Span] = None) -> Optional[_Span]:
        """The innermost span open at ``t`` (until ``end``) for work on
        ``thread``; ``stop``, one of the thread's spans, and those opened
        after it are left out."""
        own = self._innermost(self.spans.get(thread, ()), t, end, stop)
        if own is not None or not self._in_engine(thread, t):
            return own
        others = [self._innermost(ss, t, end)
                  for th, ss in self.spans.items() if th != thread]
        return max((s for s in others if s is not None),
                   key=lambda s: s.start, default=None)


def _ms(intervals: List, steps: int) -> float:
    return _union(intervals)[0] / 1e3 / steps


def reduce_spans(events, traced_steps: int) -> Dict:
    """``{"device_ms": {span: ms}, "self_ms": {span: ms}, "idle_ms":
    {span or "none": ms}, "unattributed_ms": ms}`` of a profile's events,
    each a traced step's."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]
    names = {e.name for e in host}
    work = [e for e in events if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and e.name not in names]
    spans = [_Span(e) for e in host if e.name.startswith(PREFIX)]
    threads = _Threads(spans, host)
    for s in spans:
        s.parent = threads.open_at(s.thread, s.start, s.end, stop=s)

    # a runtime call and the device work it launched share an id
    calls = {e.id: e for e in host if e.name.startswith("cu")}
    steps = max(1, traced_steps)
    loose = []
    for e in work:
        launch = calls.get(e.id)
        span = None if launch is None else threads.open_at(
            launch.thread, launch.time_range.start)
        interval = (e.time_range.start, e.time_range.end)
        if span is None:
            loose.append(interval)
        else:
            span.events.append(interval)

    whole: Dict[str, List] = {}
    own: Dict[str, List] = {}
    for s in spans:
        own.setdefault(s.name, []).extend(s.events)
        for a in s.lineage():
            whole.setdefault(a.name, []).extend(s.events)
    out = {"device_ms": {k: _ms(v, steps) for k, v in whole.items()},
           "self_ms": {k: _ms(v, steps) for k, v in own.items()},
           "idle_ms": {}, "unattributed_ms": _ms(loose, steps)}

    # the main thread: the one whose outermost spans last longest
    top: Dict[int, float] = {}
    for s in spans:
        if s.parent is None:
            top[s.thread] = top.get(s.thread, 0.0) + s.end - s.start
    main = max(top, key=top.get, default=None)
    under_main = sorted((s for s in spans
                         if list(s.lineage())[-1].thread == main),
                        key=lambda s: (s.start, -s.end))
    if work:
        _, gaps = _union([(e.time_range.start, e.time_range.end)
                          for e in work])
        for a, b in gaps:
            s = _Threads._innermost(under_main, (a + b) / 2)
            key = NONE if s is None else s.name
            out["idle_ms"][key] = (out["idle_ms"].get(key, 0.0)
                                   + (b - a) / 1e3 / steps)
    return out
