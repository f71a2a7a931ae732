"""``NativeStore.close()`` under calls in flight on other threads.

ctypes releases the GIL inside every foreign call, so a thread may be
inside ``dds_get_batch`` on a handle while another thread closes it. The
binding counts the calls in flight: ``close()`` marks the store closing,
waits until no call is in flight, and only then calls ``dds_destroy``,
once; a call that starts after that raises ``DDStoreError(ERR_CLOSED)``
without passing the handle on. The reference frees the store at once
(``ddstore_tpu/binding.py`` ``NativeStore.close``), the heap-use-after-free
that ``tests/test_sanitizers.py``'s metrics scenario shows under TSan.

The stub cases drive ``close()`` against a stand-in for the library, so
the order of events is exact; the stress case runs the real store in a
subprocess, where a use after free would crash the process instead of
the test run."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from ddstore_tpu_torch import binding

pytestmark = pytest.mark.tier1_required

HANDLE = 0x5EED


class _StubLib:
    """``dds_get_batch`` blocks until ``release`` is set; ``dds_destroy``
    and every call record themselves."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.calls = []

    def dds_get_batch(self, h, *args):
        self.calls.append(("dds_get_batch", h))
        self.entered.set()
        assert self.release.wait(30)
        return 0

    def dds_barrier(self, h, tag):
        self.calls.append(("dds_barrier", h))
        return 0

    def dds_async_release(self, h, ticket):
        self.calls.append(("dds_async_release", h))
        return 0

    def dds_destroy(self, h):
        self.calls.append(("dds_destroy", h))

    def dds_release_local_group(self, gid):
        self.calls.append(("dds_release_local_group", gid))


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(binding, "_load", lambda: lib)
    return lib


def _read(store):
    out = np.zeros((2, 4), np.float32)
    store.get_batch("v", out, np.array([0, 1]))


def test_close_waits_for_a_call_in_flight(stub):
    store = binding.NativeStore(HANDLE, local_gid="g")
    reader = threading.Thread(target=_read, args=(store,))
    reader.start()
    assert stub.entered.wait(10)
    closer = threading.Thread(target=store.close)
    closer.start()
    closer.join(0.3)
    # the read is still inside the library: nothing is freed yet
    assert closer.is_alive()
    assert ("dds_destroy", HANDLE) not in stub.calls
    # a call made after close() began raises and never reaches the library
    with pytest.raises(binding.DDStoreError) as e:
        store.barrier(1)
    assert e.value.code == binding.ERR_CLOSED
    assert "store is closed" in str(e.value)
    assert ("dds_barrier", HANDLE) not in stub.calls
    stub.release.set()
    reader.join(10)
    closer.join(10)
    assert not closer.is_alive()
    assert stub.calls == [("dds_get_batch", HANDLE), ("dds_destroy", HANDLE),
                          ("dds_release_local_group", b"g")]


def test_close_is_idempotent_and_safe_from_del(stub):
    store = binding.NativeStore(HANDLE)
    store.close()
    store.close()
    store.__del__()
    assert stub.calls == [("dds_destroy", HANDLE)]
    with pytest.raises(binding.DDStoreError, match="store is closed"):
        _read(store)
    assert stub.calls == [("dds_destroy", HANDLE)]


def test_async_release_after_close_returns_the_closed_code(stub):
    # release is the teardown barrier and never raises, also once the
    # store (and every ticket with it) is gone
    store = binding.NativeStore(HANDLE)
    store.close()
    assert store.async_release(7) == binding.ERR_CLOSED
    assert stub.calls == [("dds_destroy", HANDLE)]


def test_close_with_no_call_in_flight_destroys_at_once(stub):
    store = binding.NativeStore(HANDLE)
    stub.release.set()
    _read(store)
    closer = threading.Thread(target=store.close)
    closer.start()
    closer.join(10)
    assert not closer.is_alive()
    assert stub.calls == [("dds_get_batch", HANDLE), ("dds_destroy", HANDLE)]


def test_a_second_close_does_not_wait_for_the_first(stub):
    # close() from __del__ or another thread while the first close waits
    # out a read must not block behind it, nor destroy twice
    store = binding.NativeStore(HANDLE)
    reader = threading.Thread(target=_read, args=(store,))
    reader.start()
    assert stub.entered.wait(10)
    first = threading.Thread(target=store.close)
    first.start()
    first.join(0.2)
    assert first.is_alive()
    store.close()  # returns at once
    assert ("dds_destroy", HANDLE) not in stub.calls
    stub.release.set()
    for t in (reader, first):
        t.join(10)
    assert stub.calls.count(("dds_destroy", HANDLE)) == 1


_STRESS = r"""
import threading
import time
import numpy as np
from ddstore_tpu_torch import DDStore, DDStoreError
from ddstore_tpu_torch.binding import ERR_CLOSED

ROWS, DIM, READERS, ROUNDS = 256, 64, 4, 20
data = np.arange(ROWS * DIM, dtype=np.float32).reshape(ROWS, DIM)
for rnd in range(ROUNDS):
    s = DDStore(backend="local")
    s.add("v", data)
    started = threading.Barrier(READERS + 1)
    errs, reads, closed = [], [0] * READERS, [0] * READERS

    def reader(i):
        rng = np.random.default_rng(rnd * READERS + i)
        started.wait()
        try:
            while True:
                idx = rng.integers(0, ROWS, size=64)
                try:
                    got = s.get_batch("v", idx)
                except DDStoreError as e:
                    assert e.code == ERR_CLOSED, e
                    closed[i] += 1
                    return
                assert (got == data[idx]).all()
                reads[i] += 1
        except Exception as e:  # noqa: BLE001
            errs.append(repr(e))

    def closer():
        # close while every reader is mid-stream
        started.wait()
        while min(reads) < 3 and not errs:
            time.sleep(0)
        s._native.close()

    ts = [threading.Thread(target=reader, args=(i,)) for i in range(READERS)]
    ts.append(threading.Thread(target=closer))
    [t.start() for t in ts]
    [t.join(60) for t in ts]
    assert not any(t.is_alive() for t in ts), "a thread hung"
    assert not errs, errs
    assert closed == [1] * READERS, closed
    s.close()
print("close stress ok")
"""


def test_close_under_concurrent_reads_stress():
    # four threads read one local-backend store while a fifth closes it,
    # 20 rounds: each read gives the right rows or the closed error
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _STRESS], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    assert "close stress ok" in proc.stdout
