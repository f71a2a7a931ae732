"""The port's store over its copy of the native core against the JAX
package's store: the same shards give byte-identical ``get``/
``get_batch``/``get_batch_async`` and the same error codes, over the
in-process transport (ThreadGroup ranks) and over TCP between spawned
processes that hold one store of each package (so the two native
libraries also live side by side in one process). Rank stamps pin which
owner served each row, with and without replica groups (``width``).
Exact equality throughout."""

import os
import shutil
import subprocess

import numpy as np
import pytest

import ddstore_tpu as ref
from ddstore_tpu_torch import _build
from ddstore_tpu_torch import rendezvous as rdv
from ddstore_tpu_torch import store as tstore
from torch_workers import (read_all, run_threads, shard, spawn,
                           store_and_collectives_interleave, tcp_parity)

pytestmark = pytest.mark.tier1_required

NUM = 32


def _both(world, backend, width, tag, body):
    """Each thread rank builds a reference store and a port store over
    ThreadGroups of ``world`` and runs ``body(store, rank)`` on each;
    returns {"ref": [...], "port": [...]} by rank."""
    res = {}
    for key, mod, make in (("ref", ref, ref.DDStore),
                           ("port", rdv, tstore.DDStore)):
        def fn(r, mod=mod, make=make, key=key):
            g = mod.ThreadGroup(f"{tag}-{key}", r, world)
            with make(g, backend=backend, width=width) as s:
                return body(s, r)
        res[key] = run_threads(world, fn)
    return res


@pytest.mark.parametrize("backend", ["local", "tcp"])
@pytest.mark.parametrize("world", [1, 3])
def test_thread_ranks_read_the_same_bytes(backend, world):
    def body(s, r):
        s.add("v", shard(r, NUM))
        s.add("u8", np.full((NUM + r, 7, 3), r, np.uint8))
        got = read_all(s, "v", world, NUM, seed=r)
        got.append(s.get_batch("u8", np.arange(s.total_rows("u8"))
                               [::-1]).tobytes())
        return got, [s.total_rows("u8"), s.local_rows("u8"),
                     s.my_row_range("u8"), s.row_nbytes("u8"),
                     s.row_starts("u8").tolist(), s.variables()]

    res = _both(world, backend, None, f"bytes{backend}{world}", body)
    assert res["port"] == res["ref"]


BAD_READS = {
    "get past the shard": lambda s: s.get("x", 9, 2),
    "negative row": lambda s: s.get("x", -1),
    "row past the end": lambda s: s.get("x", 10, 0),
    "count past the end": lambda s: s.get("x", 0, 11),
    "batch past the end": lambda s: s.get_batch("x", [3, 10]),
    "negative batch row": lambda s: s.get_batch("x", [-1]),
    "async past the end": lambda s: s.get_batch_async("x", [0, 12]).wait(),
    "add twice": lambda s: s.add("x", np.zeros((10, 2), np.int64)),
    "update past the end": lambda s: s.update("x", np.zeros((3, 2)), 9),
    "ranks disagree on the shape": None,
}


@pytest.mark.parametrize("case", sorted(BAD_READS))
def test_bad_input_raises_the_same_code(case):
    if BAD_READS[case] is None:  # a collective refusal: two thread ranks
        def body(s, r):
            try:
                s.add("y", np.zeros((4, 2 + r), np.float32))
            except Exception as e:  # noqa: BLE001 — compared below
                return type(e).__name__, getattr(e, "code", None)
        res = _both(2, "local", None, "shape", body)
        assert res["port"] == res["ref"] == [("DDStoreError", -9)] * 2
        return
    codes = []
    for s, err in ((ref.DDStore(ref.SingleGroup(), backend="local"),
                    ref.DDStoreError),
                   (tstore.DDStore(), tstore.DDStoreError)):
        s.add("x", np.arange(20, dtype=np.int64).reshape(10, 2))
        with pytest.raises(err) as e:
            BAD_READS[case](s)
        codes.append(e.value.code)
        s.close()
    assert codes[0] == codes[1] < 0


@pytest.mark.parametrize("backend", ["local", "tcp"])
def test_rank_stamps_with_replica_groups(backend):
    world, width = 4, 2

    def body(s, r):
        assert (s.world, s.num_replicas) == (width, world // width)
        s.add("v", np.full((NUM, 5), s.rank + 1, np.float64))
        idx = np.arange(width * NUM)
        stamps = s.get_batch("v", idx)[:, 0]
        assert (stamps == idx // NUM + 1).all()
        return (s.rank, s.replica_id, s.world_group.rank,
                s.owner_of_rows("v", idx[::7]).tolist())

    res = _both(world, backend, width, f"width{backend}", body)
    assert res["port"] == res["ref"]
    assert [r[:3] for r in res["port"]] == [(0, 0, 0), (1, 0, 1),
                                            (0, 1, 2), (1, 1, 3)]


@pytest.mark.parametrize("wire", ["tcp", "uring"])
def test_two_processes_over_tcp_match_reference(tmp_path, wire):
    ranks = spawn(2, tcp_parity, str(tmp_path), wire)
    for out in ranks:
        assert out["port"] == out["ref"]
    # each rank read the other's rows
    assert ranks[0]["port"][0] != ranks[1]["port"][0]


def test_store_reads_and_gloo_collectives_interleave(tmp_path):
    assert spawn(2, store_and_collectives_interleave, str(tmp_path)) == \
        [0, 0]


def test_library_exports_only_the_c_api():
    lib = _build.build()
    syms = subprocess.run(["nm", "-D", "--defined-only", lib],
                          capture_output=True, text=True, check=True)
    names = [ln.split()[-1] for ln in syms.stdout.splitlines() if ln]
    assert names and all(n.startswith("dds_") for n in names), \
        [n for n in names if not n.startswith("dds_")][:10]
    dyn = subprocess.run(["readelf", "--dyn-syms", "-W", lib],
                         capture_output=True, text=True, check=True)
    assert "UNIQUE" not in dyn.stdout


def _code(text):
    """C++ source without its comments or blank lines, each line
    right-stripped: what the compiler sees, up to layout."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        if text.startswith("//", i):
            i = text.find("\n", i)
            i = n if i < 0 else i
        elif text.startswith("/*", i):
            i = text.index("*/", i) + 2
        elif c in "\"'":  # a string or char literal, escapes included
            j = i + 1
            while text[j] != c:
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        else:
            out.append(c)
            i += 1
    lines = (ln.rstrip() for ln in "".join(out).splitlines())
    return [ln for ln in lines if ln]


def test_native_sources_are_the_reference_copy():
    # the same code as the reference core; only comments may differ
    here = os.path.dirname(os.path.abspath(__file__))
    ref_dir = os.path.join(os.path.dirname(here), "ddstore_tpu", "native")
    for f in _build.SOURCES + _build.HEADERS:
        with open(os.path.join(ref_dir, f)) as a, \
                open(os.path.join(_build.NATIVE_DIR, f)) as b:
            assert _code(a.read()) == _code(b.read()), f
    assert sorted(os.listdir(_build.NATIVE_DIR)) == \
        sorted(_build.SOURCES + _build.HEADERS)


def test_build_is_stale_aware(tmp_path, monkeypatch):
    src = tmp_path / "native"
    shutil.copytree(_build.NATIVE_DIR, src)
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(_build, "NATIVE_DIR", str(src))
    monkeypatch.setattr(_build, "LIB_PATH", str(lib))
    assert _build._stale()  # no library yet
    lib.write_bytes(b"")
    t = os.path.getmtime(src / "store.h")
    os.utime(lib, (t + 10, t + 10))
    assert not _build._stale()
    os.utime(src / "wire.h", (t + 20, t + 20))  # a header counts too
    assert _build._stale()


REFUSED = {
    "spill_to_disk": lambda s: s.spill_to_disk("x", "."),
    "trace_summary": lambda s: s.trace_summary(),
    "metrics_summary": lambda s: s.metrics_summary(),
    "cluster_metrics": lambda s: s.cluster_metrics(),
    "attach": lambda s: s.attach("t"),
    "set_tenant_quota": lambda s: s.set_tenant_quota("t", 1 << 20),
    "gateway_session": lambda s: s.gateway_session("t"),
}


@pytest.mark.parametrize("method", sorted(REFUSED))
def test_later_slices_are_refused_by_name(method):
    # methods whose modules come with later slices raise, naming the
    # ROADMAP item, and leave the store working
    with tstore.DDStore() as s:
        s.add("x", np.arange(6.0).reshape(3, 2))
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
            REFUSED[method](s)
        assert s.get("x", 2)[0].tolist() == [4.0, 5.0]
