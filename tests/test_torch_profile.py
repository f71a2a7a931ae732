"""The port's profiler integration (``ddstore_tpu_torch.utils.profile``)
against the JAX package's, case by case with ``tests/test_profile.py``:
a ``trace`` block leaves an artifact holding the annotated spans (the
JAX package's XProf ``.xplane.pb``, the port's Chrome trace JSON), and
the loader's spans change nothing without a trace. The loader fetches
and stages on worker threads; their ``ddstore:fetch`` and
``ddstore:stage`` ranges must reach the trace too."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddstore_tpu import DDStore as RefStore
from ddstore_tpu import SingleGroup as RefSingle
from ddstore_tpu.data import DeviceLoader as RefLoader
from ddstore_tpu.data import DistributedSampler as RefSampler
from ddstore_tpu.data import ShardedDataset as RefDataset
from ddstore_tpu.utils import profile as rprof
from ddstore_tpu_torch.data.dataset import DistributedSampler, ShardedDataset
from ddstore_tpu_torch.data.loader import DeviceLoader
from ddstore_tpu_torch.store import DDStore
from ddstore_tpu_torch.utils import profile as tprof

pytestmark = pytest.mark.tier1_required


def _trace_names(logdir):
    found = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(found) == 1, found
    with open(found[0]) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name") for e in events
            if e.get("cat") == "user_annotation"]


def test_trace_produces_artifact(tmp_path):
    spans = ("train_step", "host-phase")
    rdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    with rprof.trace(rdir):
        with rprof.step_annotate(0):
            x = jnp.arange(1024.0)
            jax.block_until_ready(jnp.dot(x, x))
        with rprof.annotate("host-phase"):
            np.arange(10).sum()
    with tprof.trace(tdir):
        with tprof.step_annotate(0):
            x = torch.arange(1024.0)
            torch.dot(x, x)
        with tprof.annotate("host-phase"):
            np.arange(10).sum()
    xplane = glob.glob(os.path.join(rdir, "**", "*.xplane.pb"),
                       recursive=True)
    assert xplane, f"no trace artifact under {rdir}"
    with open(xplane[0], "rb") as f:
        blob = f.read()
    names = _trace_names(tdir)
    for span in spans:
        assert span.encode() in blob, span
        assert any(n.startswith(span) for n in names), (span, names)
    assert "train_step#0" in names


def test_annotated_loader_runs_without_trace():
    data = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    with RefStore(RefSingle(), backend="local") as store:
        ref = list(RefLoader(RefDataset(store, data),
                             RefSampler(64, 1, 0), batch_size=16,
                             mesh=None))
    with DDStore(backend="local") as store:
        got = list(DeviceLoader(ShardedDataset(store, data),
                                DistributedSampler(64, 1, 0), 16,
                                device="cpu"))
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        np.sort(np.concatenate([g.numpy() for g in got]), axis=0), data)


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_worker_spans_reach_the_trace(tmp_path, workers):
    """The ranges the loader's worker threads open land in the trace:
    one ``ddstore:fetch`` and one ``ddstore:stage`` per batch."""
    data = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    with DDStore(backend="local") as store:
        loader = DeviceLoader(ShardedDataset(store, data),
                              DistributedSampler(64, 1, 0), 8,
                              device="cpu", workers=workers)
        with tprof.trace(str(tmp_path)):
            n = sum(1 for _ in loader)
    names = _trace_names(str(tmp_path))
    assert n == 8
    assert names.count("ddstore:fetch") == n
    assert names.count("ddstore:stage") == n


@pytest.mark.parametrize("tool", [False, True])
def test_annotate_opens_nvtx_only_for_an_attached_tool(monkeypatch, tool):
    """On a card, ``annotate`` opens an NVTX range only when an external
    profiler's NVTX tool is attached; otherwise it opens nothing while
    no trace is active."""
    import contextlib

    opened = []

    @contextlib.contextmanager
    def nvtx_range(name):
        opened.append(name)
        yield

    monkeypatch.setattr(tprof, "_NVTX_TOOL", tool)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range", nvtx_range)
    with tprof.annotate("ddstore:fetch"):
        pass
    with tprof.step_annotate(3):
        pass
    assert opened == (["ddstore:fetch", "train_step#3"] if tool else [])


def test_annotate_as_a_decorator_spans_every_call(tmp_path):
    """A decorated function opens its own span on each call, on any
    thread."""
    import threading

    @tprof.annotate("work")
    def work():
        return 1

    with tprof.trace(str(tmp_path)):
        threads = [threading.Thread(target=work) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert work() == 1
    assert _trace_names(str(tmp_path)).count("work") == 4
