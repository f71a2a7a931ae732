"""The port's trace consumers (``ddstore_tpu_torch.obs``, its CLI and the
store's ``trace_summary``/``cluster_metrics``/``metrics_summary``)
against the JAX package's, case by case with ``tests/test_trace.py``.

Every case runs once on each package, over its own native core (the
trace rings and the fault injector are per library), and the two
results must be equal: the same bytes and injector counters under a
seeded fault schedule, the same span and flight-recorder stories, the
same Chrome JSON, span trees, latency tables, Prometheus text and
summaries from the same dumps and cell arrays (exact)."""

import json

import numpy as np
import pytest

from torch_services import PKGS, both, run_pair

pytestmark = pytest.mark.tier1_required

ROWS, DIM = 128, 8


@pytest.fixture(autouse=True)
def _trace_hygiene():
    """Every test leaves tracing OFF, the rings trimmed, the ring size
    at its default, and the fault injector disarmed, in both
    libraries."""
    yield
    for P in PKGS.values():
        P.binding.trace_configure(0, 4096)
        P.binding.trace_reset()
        P.fault_configure("", 0)


@pytest.fixture(autouse=True)
def _wire_only(monkeypatch):
    """Every remote read on the TCP wire path, tight retry budgets."""
    monkeypatch.setenv("DDSTORE_CMA", "0")
    monkeypatch.setenv("DDSTORE_TCP_LANES", "1")
    monkeypatch.setenv("DDSTORE_RETRY_MAX", "4")
    monkeypatch.setenv("DDSTORE_RETRY_BASE_MS", "2")
    monkeypatch.setenv("DDSTORE_OP_DEADLINE_S", "30")


def _pair(P, body0):
    return run_pair(P, body0, ROWS, DIM)


def _names(P, events):
    return [P.binding.TRACE_TYPES.get(int(e["type"]), "?") for e in events]


def _seeded_workload(P, s):
    P.fault_configure("reset:0.3,delay:0.1:2", 77)
    try:
        outs = []
        rng = np.random.default_rng(3)
        for _ in range(12):
            idx = rng.integers(0, 2 * ROWS, 96)
            outs.append(s.get_batch("v", idx).copy())
        fs = s.fault_stats()
    finally:
        P.fault_configure("", 0)
    counters = {k: fs[k] for k in
                ("fault_checks", "injected_reset", "injected_trunc",
                 "injected_delay", "injected_stall")}
    return np.concatenate(outs), counters


def test_off_state_identical_under_seeded_faults():
    def case(P):
        P.binding.trace_configure(0)
        out_off, fs_off = _pair(P, lambda s: _seeded_workload(P, s))
        P.binding.trace_configure(1)
        P.binding.trace_reset()
        out_on, fs_on = _pair(P, lambda s: _seeded_workload(P, s))
        np.testing.assert_array_equal(out_off, out_on)
        assert fs_off == fs_on, (fs_off, fs_on)
        assert fs_on["injected_reset"] > 0
        names = set(_names(P, P.binding.trace_dump()))
        assert {"op_begin", "retry"} <= names
        return out_on.tobytes(), fs_on

    ref, port = both(case)
    assert port == ref


def test_disabled_records_nothing():
    def case(P):
        P.binding.trace_configure(0)
        P.binding.trace_reset()
        st0 = P.binding.trace_stats()
        _pair(P, lambda s: s.get_batch("v", np.arange(ROWS, ROWS + 32)))
        P.binding.trace_emit("window_issue", 0, 0, 1, 2, 3)
        st1 = P.binding.trace_stats()
        assert st1["captured"] == st0["captured"]
        assert len(P.binding.trace_dump()) == 0
        return P.binding.trace_enabled(), sorted(st1)

    ref, port = both(case)
    assert port == ref and port[0] is False


def test_span_propagates_across_tcp_read():
    def case(P):
        P.binding.trace_configure(1)
        P.binding.trace_reset()

        def body(s):
            out = s.get_batch("v", np.arange(ROWS, ROWS + 48))
            assert (out == 2).all()
            return True

        assert _pair(P, body)
        codes = P.binding.TRACE_TYPE_CODES
        ev = P.binding.trace_dump()
        begins = ev[(ev["type"] == codes["op_begin"]) & (ev["rank"] == 0)]
        spans = {int(x) for x in begins["span"]}
        serves = ev[(ev["type"] == codes["serve_begin"])
                    & (ev["rank"] == 1)]
        ends = ev[(ev["type"] == codes["serve_end"]) & (ev["rank"] == 1)]
        joined = bool({int(x) for x in serves["span"]} & spans)
        return (len(begins) >= 1, len(serves) >= 1, joined,
                len(ends) >= 1 and all(int(e["b"]) == 0 for e in ends))

    ref, port = both(case)
    assert port == ref == (True, True, True, True)


def test_flight_recorder_on_peer_lost(monkeypatch):
    monkeypatch.setenv("DDSTORE_OP_DEADLINE_S", "10")

    def case(P):
        P.binding.trace_configure(1)
        P.binding.trace_reset()
        st0 = P.binding.trace_stats()

        def body(s):
            P.fault_configure("reset:1.0", 5, ranks=[1])
            try:
                with pytest.raises(P.DDStoreError) as ei:
                    s.get_batch("v", np.arange(ROWS, ROWS + 16))
            finally:
                P.fault_configure("", 0)
            return ei.value.code

        code = _pair(P, body)
        st1 = P.binding.trace_stats()
        fl = P.binding.trace_flight_dump()
        markers = fl[fl["type"] == P.binding.TRACE_TYPE_CODES["flight"]]
        reasons = {P.binding.TRACE_FLIGHT_REASONS.get(int(m["a"]))
                   for m in markers}
        tree = P.obs.span_tree(fl)
        return (code, st1["flight_dumps"] > st0["flight_dumps"],
                {"flight", "retry"} <= set(_names(P, fl)),
                "peer_lost" in reasons, "retry" in tree and "peer=1" in tree)

    ref, port = both(case)
    assert port == ref == (PKGS["torch"].binding.ERR_PEER_LOST, True, True,
                           True, True)


def test_suspect_verdict_snapshots_flight():
    def case(P):
        P.binding.trace_configure(1)
        P.binding.trace_reset()

        def body(s):
            s.mark_suspect(1, True)
            s.mark_suspect(1, False)
            return True

        assert _pair(P, body)
        codes = P.binding.TRACE_TYPE_CODES
        ev = P.binding.trace_dump()
        sus = ev[ev["type"] == codes["suspect"]]
        clr = ev[ev["type"] == codes["suspect_clear"]]
        fl = P.binding.trace_flight_dump()
        markers = fl[fl["type"] == codes["flight"]]
        return ([(int(e["a"]), int(e["b"])) for e in sus],
                [int(e["a"]) for e in clr],
                any(P.binding.TRACE_FLIGHT_REASONS.get(int(m["a"]))
                    == "suspect" for m in markers))

    ref, port = both(case)
    assert port == ref == ([(1, 1)], [1], True)


def test_ring_overflow_drops_counted_never_blocks():
    import threading

    def case(P):
        P.binding.trace_configure(1, ring_events=64)
        P.binding.trace_reset()
        st0 = P.binding.trace_stats()

        def emitter():
            for i in range(1000):
                P.binding.trace_emit("window_issue", 0, 0, i, 0, 0)

        t = threading.Thread(target=emitter)
        t.start()
        t.join(60)
        assert not t.is_alive(), "emitter blocked on a full ring"
        st1 = P.binding.trace_stats()
        ev = P.binding.trace_dump()
        mine = ev[ev["type"] == P.binding.TRACE_TYPE_CODES["window_issue"]]
        return (st1["captured"] - st0["captured"],
                st1["dropped"] - st0["dropped"],
                sorted(int(e["a"]) for e in mine))

    ref, port = both(case)
    assert port == ref == (1000, 1000 - 64, list(range(937, 1000)))


def _synth_events(P):
    codes = P.binding.TRACE_TYPE_CODES
    ev = np.zeros(4, dtype=P.binding.TRACE_EVENT_DTYPE)
    span = 0xABC
    ev[0] = (1000, span, codes["op_begin"], 0, 0, 1, 1, 4096)
    ev[1] = (2000, span, codes["serve_begin"], 0, 1, 0, 1, 4096)
    ev[2] = (3000, span, codes["serve_end"], 0, 1, 0, 0, 4096)
    ev[3] = (9000, span, codes["op_end"], 0, 0, 1, 0, 4096)
    return ev


def test_merge_tool_emits_valid_chrome_json(tmp_path):
    from ddstore_tpu.obs.__main__ import main as rmain
    from ddstore_tpu_torch.obs.__main__ import main as tmain

    def case(P, main):
        ev = _synth_events(P)
        d = tmp_path / P.name
        d.mkdir()
        p0 = P.obs.save_dump(str(d / "r0.npy"), ev[ev["rank"] == 0])
        p1 = P.obs.save_dump(str(d / "r1.npy"), ev[ev["rank"] == 1])
        out = str(d / "trace.json")
        assert main(["merge", "-o", out, p0, p1]) == 0
        with open(out) as f:
            return json.load(f)

    ref = case(PKGS["jax"], rmain)
    port = case(PKGS["torch"], tmain)
    assert port == ref
    assert sorted(r["ph"] for r in port) == ["b", "b", "e", "e"]
    assert {r["id"] for r in port} == {f"{0xABC:x}"}
    assert [min(r["ts"] for r in port), max(r["ts"] for r in port)] == \
        [0.0, 8.0]
    # the dump files themselves are the same bytes
    for f in ("r0.npy", "r1.npy"):
        assert (tmp_path / "torch" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()


def test_span_tree_renders_the_story(tmp_path, capsys):
    from ddstore_tpu.obs.__main__ import main as rmain
    from ddstore_tpu_torch.obs.__main__ import main as tmain

    texts = []
    for P, main in ((PKGS["jax"], rmain), (PKGS["torch"], tmain)):
        p = P.obs.save_dump(str(tmp_path / f"{P.name}.npy"),
                            _synth_events(P))
        assert main(["tree", p]) == 0
        texts.append(capsys.readouterr().out)
    assert texts[1] == texts[0]
    assert "span abc:" in texts[1] and "r1/t0" in texts[1]
    assert "op:get_batch" in texts[1] and "serve" in texts[1]


def test_span_latency_percentiles():
    def case(P):
        lat = P.obs.span_latency(_synth_events(P))
        ev = np.zeros(2, dtype=P.binding.TRACE_EVENT_DTYPE)
        codes = P.binding.TRACE_TYPE_CODES
        ev[0] = (0, 7, codes["op_begin"], 0, 0, 0, 2, 64)
        ev[1] = (2_000_000, 7, codes["op_end"], 0, 0, 0, 0, 64)
        return lat, P.obs.span_latency(ev)

    ref, port = both(case)
    assert port == ref
    assert port[0]["get_batch|tcp|1"]["count"] == 1
    assert port[1] == {"get|local|2": {"count": 1, "p50_ms": 2.0,
                                       "p99_ms": 2.0}}


def test_readahead_window_events():
    def case(P):
        P.binding.trace_configure(1)
        P.binding.trace_reset()
        with P.DDStore(backend="local") as s:
            s.add("v", np.arange(64 * 4, dtype=np.float32).reshape(64, 4))
            batches = [np.arange(i * 8, (i + 1) * 8) for i in range(8)]
            with P.EpochReadahead(s, "v", batches, window_batches=4,
                                  depth=2) as ra:
                got = [ra.get_batch(b).tobytes() for b in range(8)]
        ev = P.binding.trace_dump()
        codes = P.binding.TRACE_TYPE_CODES
        issues = ev[ev["type"] == codes["window_issue"]]
        readys = ev[ev["type"] == codes["window_ready"]]
        return (got, len(issues), len(readys),
                {int(e["span"]) for e in issues}
                == {int(e["span"]) for e in readys},
                all(int(e["span"]) != 0 for e in issues),
                sorted((int(e["a"]), int(e["b"]), int(e["c"]))
                       for e in issues))

    ref, port = both(case)
    assert port == ref
    assert port[1:5] == (2, 2, True, True)


_TRACE_SNAPS = [
    {"enabled": 1, "ring_events": 4096, "threads": 2, "capacity": 8192,
     "live": 10, "ring_occupancy": 0.0012, "captured": 100, "dropped": 5,
     "flight_events": 0, "flight_dumps": 1, "spans": 7},
    {"enabled": 1, "ring_events": 4096, "threads": 3, "capacity": 12288,
     "live": 60, "ring_occupancy": 0.0049, "captured": 160, "dropped": 8,
     "flight_events": 12, "flight_dumps": 2, "spans": 9,
     "span_latency": {"get|tcp|1": {"count": 3, "p50_ms": 0.4,
                                    "p99_ms": 1.2}}},
]


def test_metrics_trace_delta_unit():
    def case(P):
        it = iter([dict(s) for s in _TRACE_SNAPS])
        m = P.PipelineMetrics()
        m.set_trace_source(lambda: next(it))
        m.epoch_start()
        m.epoch_end()
        return m.summary()["trace"]

    ref, port = both(case)
    assert port == ref
    assert (port["captured"], port["dropped"], port["flight_dumps"],
            port["spans"]) == (60, 3, 1, 2)
    assert port["threads"] == 3 and port["ring_occupancy"] == 0.0049
    assert port["span_latency"]["get|tcp|1"]["p99_ms"] == 1.2


def test_metrics_without_trace_source_stays_silent():
    def case(P):
        m = P.PipelineMetrics()
        m.epoch_start()
        m.epoch_end()
        return "trace" in m.summary()

    assert both(case) == (False, False)


def test_trace_summary_occupancy():
    st = {"capacity": 1000, "live": 250, "captured": 300, "dropped": 50,
          "enabled": 1}
    ref, port = both(lambda P: P.obs.trace_summary(dict(st)))
    assert port == ref
    assert port["ring_occupancy"] == 0.25 and "span_latency" not in port
    ev = _synth_events(PKGS["torch"])
    ref, port = both(lambda P: P.obs.trace_summary(dict(st), ev))
    assert port == ref and "get_batch|tcp|1" in port["span_latency"]


# -- beyond tests/test_trace.py: the ddmetrics half and the store ---------

def _cells(P, seed=0, n=6):
    """Seeded histogram cells: classes, routes, peers and tenants (one
    label needing Prometheus escaping), log2 latency/bytes buckets."""
    rng = np.random.default_rng(seed)
    cells = np.zeros(n, dtype=P.binding.METRICS_CELL_DTYPE)
    for i, c in enumerate(cells):
        c["cls"], c["route"] = i % 3, i % 4
        c["peer"] = int(rng.integers(-1, 3))
        c["tenant"] = ["", "eval", 'q"x\\y'][i % 3].encode()
        lat = rng.integers(0, 50, P.binding.METRICS_BUCKETS)
        lat[: i + 5] = 0
        c["lat"] = lat
        c["count"] = int(lat.sum())
        c["lat_sum_ns"] = int((lat * (1 << np.arange(len(lat)))).sum())
        byt = rng.integers(0, 9, P.binding.METRICS_BUCKETS)
        byt[20:] = 0
        c["bytes"] = byt
        c["bytes_sum"] = int((byt * (1 << np.arange(len(byt)))).sum())
    return cells


@pytest.mark.parametrize("fn", ["latency_table", "latency_text",
                                "prometheus_text", "metrics_json"])
def test_cell_renderers_match_reference(fn):
    ref, port = both(lambda P: getattr(P.obs, fn)(_cells(P)))
    assert port == ref


def test_merge_metrics_and_snapshot_files_match_reference(tmp_path):
    def case(P):
        a, b = _cells(P, 1), _cells(P, 2)
        b[:3] = a[:3]  # equal keys sum bucket-wise
        merged = P.obs.merge_metrics([a, b])
        p = P.obs.save_metrics(str(tmp_path / f"{P.name}.npy"), merged)
        back = P.obs.load_metrics(p)
        np.testing.assert_array_equal(back, merged)
        return back.tobytes(), P.obs.latency_table(back)

    ref, port = both(case)
    assert port == ref
    with pytest.raises(ValueError, match="not a ddstore"):
        np.save(tmp_path / "x.npy", np.zeros(3))
        PKGS["torch"].obs.load_metrics(str(tmp_path / "x.npy"))


@pytest.mark.parametrize("cmd", ["latency", "top", "metrics-prom",
                                 "metrics-json"])
def test_cli_subcommands_match_reference(tmp_path, capsys, cmd):
    from ddstore_tpu.obs.__main__ import main as rmain
    from ddstore_tpu_torch.obs.__main__ import main as tmain

    outs = []
    for P, main in ((PKGS["jax"], rmain), (PKGS["torch"], tmain)):
        if cmd == "latency":
            args = ["latency", P.obs.save_dump(
                str(tmp_path / f"d{P.name}.npy"), _synth_events(P))]
        else:
            snap = P.obs.save_metrics(str(tmp_path / f"m{P.name}.npy"),
                                      _cells(P))
            args = (["top", snap] if cmd == "top" else
                    ["metrics", "--format", cmd.split("-")[1], snap])
        assert main(args) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and outs[1].strip()


def test_store_trace_and_metrics_summaries_match_reference():
    """The store's three summaries over a traced two-rank TCP store: the
    same keys, counters and cells as the JAX package's (timings
    aside); ``cluster_metrics`` pulls both ranks."""
    def case(P):
        P.binding.trace_configure(1)
        P.binding.trace_reset()

        def body(s):
            s.get_batch("v", np.arange(ROWS - 8, ROWS + 40))
            s.get("v", ROWS + 1, 3)
            tr = s.trace_summary()
            cells, dead = s.cluster_metrics()
            ms = s.metrics_summary()
            return (sorted(tr), tr["enabled"], sorted(tr["span_latency"]),
                    {k: v["count"] for k, v in tr["span_latency"].items()},
                    dead, sorted(P.obs.latency_table(cells)),
                    {k: (v["count"], v["bytes"]) for k, v in ms.items()})

        return _pair(P, body)

    ref, port = both(case)
    assert port == ref
    assert port[4] == [] and port[6]
