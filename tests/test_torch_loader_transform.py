"""The loader's concurrent transform, the same checks in both packages:
``DeviceLoader(transform_thread_safe=True)``, or a transform marked
``thread_safe = True``, lets several workers into the transform at once
(``ddstore_tpu/data/loader.py:124``, ``:146-150``, ``:535-536``); an
unmarked transform runs under the loader's lock, one worker at a time.

"At once" is a ``threading.Barrier(2)``: the first two calls of a marked
transform wait on it, and pass only if two workers are inside together
(a 10 s timeout fails the case instead of hanging). An unmarked one
counts the workers inside it, each call holding for a moment, and never
sees two."""

import threading
import time

import numpy as np
import pytest

from ddstore_tpu.data.loader import DeviceLoader as JaxLoader
from ddstore_tpu_torch.data.loader import DeviceLoader as TorchLoader

pytestmark = pytest.mark.tier1_required

N, BATCH, WORKERS = 32, 2, 2


def _dataset(idx):
    return np.asarray(idx, np.float32)[:, None] * np.ones((1, 4), np.float32)


_dataset.thread_safe = True


def _make(package, transform, **kw):
    if package == "jax":
        return JaxLoader(_dataset, range(N), BATCH, workers=WORKERS,
                         transform=transform, **kw)
    return TorchLoader(_dataset, range(N), BATCH, device="cpu",
                       workers=WORKERS, transform=transform, **kw)


class _Meeting:
    """A transform whose first two calls meet at a barrier of 2."""

    def __init__(self):
        self.barrier = threading.Barrier(2, timeout=10)
        self.lock = threading.Lock()
        self.calls = 0
        self.met = 0

    def __call__(self, batch):
        with self.lock:
            self.calls += 1
            first = self.calls <= 2
        if first:
            try:
                self.barrier.wait()
                with self.lock:
                    self.met += 1
            except threading.BrokenBarrierError:
                pass
        return batch


class _Counting:
    """A transform that records the most workers inside it at once."""

    def __init__(self):
        self.lock = threading.Lock()
        self.inside = 0
        self.most = 0

    def __call__(self, batch):
        with self.lock:
            self.inside += 1
            self.most = max(self.most, self.inside)
        time.sleep(0.005)
        with self.lock:
            self.inside -= 1
        return batch


def _drain(loader):
    rows = np.concatenate([np.asarray(b)[:, 0] for b in loader])
    assert sorted(rows.tolist()) == list(range(N))


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_the_parameter_is_accepted(package):
    loader = _make(package, _Counting(), transform_thread_safe=True)
    assert loader._transform_lock is None
    loader = _make(package, _Counting())
    assert loader._transform_lock is not None


@pytest.mark.parametrize("how", ["parameter", "attribute"])
@pytest.mark.parametrize("package", ["jax", "torch"])
def test_a_safe_transform_holds_two_workers_at_once(package, how):
    t = _Meeting()
    kw = {}
    if how == "parameter":
        kw["transform_thread_safe"] = True
    else:
        t.thread_safe = True
    _drain(_make(package, t, **kw))
    assert t.met == 2, "the two workers never met inside the transform"


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_an_unmarked_transform_never_holds_two(package):
    t = _Counting()
    _drain(_make(package, t))
    assert t.most == 1
