"""Profiler integration (the port of ``ddstore_tpu/utils/profile.py``).

``trace(logdir)`` captures a ``torch.profiler`` trace of everything
inside the block (host ops and, with a card, its kernels and copies)
and writes it to ``logdir`` as Chrome trace-event JSON
(chrome://tracing, https://ui.perfetto.dev). It profiles every thread
of the process, so the spans the loader's worker threads open
(``ddstore:fetch``, ``ddstore:stage``) land on the same timeline as the
train step's kernels: the profiler's state is per thread, and without
``profile_all_threads`` a range opened on a worker reaches no trace.

``annotate(name)`` marks a host-side span: a ``record_function`` range
while a trace is active, and an NVTX range when the process uses a card
and an external CUDA profiler (Nsight Systems, Nsight Compute) has
attached its NVTX tool, which it does through ``NVTX_INJECTION64_PATH``
in the environment it starts the process with. With no trace active
and no such tool it opens nothing (two flag tests and the profiler's
own per-thread test), so the data layer and the train step annotate
unconditionally. ``step_annotate(step)`` is a step-scoped range.

A range records under any active ``torch.profiler``, this module's
``trace()`` or another's (a benchmark's), on the thread that started
the profiler and on the autograd engine's threads, which inherit its
state for the backward. The loader's worker threads record only under
``trace()``, which profiles every thread. The spans of
``models/transformer.py``'s ``make_train_step`` (the non-pipelined
step), a step's in this order:

* ``ddstore:zero_grad``: ``opt.zero_grad``;
* ``ddstore:forward``: the loss, once a chunk under accumulation,
  holding each layer's ``ddstore:attention`` (the ``flash_attention``
  call) and ``ddstore:head_fwd``, ``ops/xent.py``'s fused head forward;
  in a held-expert layer (``models/moe.py`` ``RoutedExperts``) also
  ``ddstore:router`` (logits, scores, top-k, the balance loss),
  ``ddstore:dispatch`` (the held assignments sorted by expert and
  gathered), ``ddstore:experts`` (their grouped products),
  ``ddstore:combine`` (the gated sum) and ``ddstore:shared_experts``;
* ``ddstore:backward``: ``loss.backward()``, once a chunk, holding
  ``ddstore:head_bwd``, the fused head's backward, and
  ``ddstore:experts_bwd``, the held experts' backward, which run on the
  autograd engine's thread;
* ``ddstore:allreduce``: the gradients' and the loss's all-reduces
  (with a mesh only);
* ``ddstore:optimizer``: ``opt.step()``, and the held-expert layers'
  selection-bias update.

The loader's (``data/loader.py``) are ``ddstore:fetch`` and
``ddstore:stage``, and on its collective path ``ddstore:device_fetch``
and ``ddstore:device_exchange``.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from typing import Iterator

import torch

__all__ = ["trace", "annotate", "step_annotate"]

# Traces active in this process. The profiler's own "enabled" flag is
# per thread, and annotate() runs on worker threads too.
_active = 0
_active_mu = threading.Lock()
# An external profiler reads NVTX ranges through the tool library it
# names here; without one, a range has no reader.
_NVTX_TOOL = bool(os.environ.get("NVTX_INJECTION64_PATH"))


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a profiler trace of the enclosed block into
    ``logdir/<host>.<pid>.<ns>.pt.trace.json``: CPU activity, and CUDA
    activity when a card is present, on every thread of the process."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    global _active
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True))) as prof:
        with _active_mu:
            _active += 1
        try:
            yield
        finally:
            with _active_mu:
                _active -= 1
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}.{os.getpid()}."
                f"{time.time_ns()}.pt.trace.json"))


class _Annotation(contextlib.ContextDecorator):
    """A named span; usable as a context manager or a decorator. What
    it records is decided on entry, per use. A decorated function gets
    a fresh span per call, so calls on several threads do not share
    one."""

    def __init__(self, name: str):
        self.name = name
        self._ctxs = ()

    def _recreate_cm(self):
        return _Annotation(self.name)

    def __enter__(self):
        ctxs = []
        if _active or torch.autograd._profiler_enabled():
            ctxs.append(torch.profiler.record_function(self.name))
        if _NVTX_TOOL and torch.cuda.is_initialized():
            ctxs.append(torch.cuda.nvtx.range(self.name))
        for c in ctxs:
            c.__enter__()
        self._ctxs = ctxs
        return self

    def __exit__(self, *exc):
        ctxs, self._ctxs = self._ctxs, ()
        for c in reversed(ctxs):
            c.__exit__(*exc)
        return False


def annotate(name: str) -> _Annotation:
    """Named host-side span on the profiler timeline (free when no trace
    is active and no NVTX tool is attached). Usable as context manager
    or decorator."""
    return _Annotation(name)


def step_annotate(step: int, name: str = "train_step") -> _Annotation:
    """Step-scoped span: ``<name>#<step>``, grouping one training step's
    ops and kernels on the trace timeline."""
    return _Annotation(f"{name}#{int(step)}")
