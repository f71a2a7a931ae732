"""The port's serving-gateway client (``ddstore_tpu_torch.gateway``: the
``GatewaySession`` behind ``DDStore.gateway_session``, with its lease
renewer and admission retry) against the JAX package's, case by case
with ``tests/test_gateway.py``.

Every case runs once on each package over its own native core; the
results must agree: the same bytes and injector counters, the same
admission codes, the same ``gateway_stats``/``snapshot_stats`` counters
and ``session.stats()`` keys and counters (timings aside), the same
epoch deltas."""

import time

import numpy as np
import pytest

from torch_services import PKGS, both, run_pair

pytestmark = pytest.mark.tier1_required

ROWS, DIM = 96, 8

# session.stats() fields that are timings or tokens, not counters
_TIMING = ("backoff_s", "token")


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    for P in PKGS.values():
        P.fault_configure("", 0)


@pytest.fixture(autouse=True)
def _wire_only(monkeypatch):
    monkeypatch.setenv("DDSTORE_CMA", "0")
    monkeypatch.setenv("DDSTORE_TCP_LANES", "1")
    monkeypatch.setenv("DDSTORE_RETRY_MAX", "4")
    monkeypatch.setenv("DDSTORE_RETRY_BASE_MS", "2")
    monkeypatch.setenv("DDSTORE_OP_DEADLINE_S", "30")


def _arm(s, **kw):
    cfg = dict(enabled=1, lease_ms=150, defer_ms=20, queue_cap=8,
               admit_margin_pct=80)
    cfg.update(kw)
    s.gateway_configure(**cfg)


def _pressurize(s):
    s.set_tenant_slos("p99:1ns")
    s.get_batch("v", np.arange(4))


def _ones(P):
    s = P.DDStore(backend="local")
    s.add("v", np.ones((ROWS, DIM), np.float32))
    return s


def _counters(stats):
    return {k: v for k, v in stats.items() if k not in _TIMING}


def test_gateway_off_inert():
    def case(P):
        with P.DDStore(backend="local") as s:
            s.add("v", np.arange(ROWS * DIM, dtype=np.float32)
                  .reshape(ROWS, DIM))
            pm = P.PipelineMetrics()
            pm.set_gateway_source(s.gateway_stats)
            pm.epoch_start()
            s.get_batch("v", np.arange(32))
            gs = s.gateway_stats()
            assert set(gs) == set(P.binding.GATEWAY_STAT_KEYS)
            pm.epoch_end()
            return (gs, s.snapshot_stats()["reclaimed_pins"],
                    "gateway" in pm.summary(),
                    s.gateway_drain(deadline_ms=10))

    ref, port = both(case)
    assert port == ref
    assert port[0]["enabled"] == 0 and port[1:] == (0, False, True)


def _seeded_workload(P, s, gw_on):
    if gw_on:
        _arm(s)
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
    if gw_on:
        assert s.gateway_stats()["admitted"] >= 12
    return np.concatenate(outs), counters


def test_gateway_off_state_seeded_fault_identity():
    def case(P):
        out_off, fs_off = run_pair(
            P, lambda s: _seeded_workload(P, s, False), ROWS, DIM)
        out_on, fs_on = run_pair(
            P, lambda s: _seeded_workload(P, s, True), ROWS, DIM)
        np.testing.assert_array_equal(out_off, out_on)
        assert fs_off == fs_on
        return out_on.tobytes(), fs_on

    ref, port = both(case)
    assert port == ref and port[1]["injected_reset"] > 0


def test_attach_detach_releases_pins_and_quota():
    def case(P):
        with _ones(P) as s:
            s.set_tenant_quota("eval", 1 << 20)
            _arm(s)
            t0 = s._native.tenant_stats("eval")["bytes"]
            token = s._native.gateway_attach(tenant="eval",
                                             with_snapshot=True,
                                             quota_bytes=4096)
            out = [token > 0, _counters(s.gateway_stats()),
                   s.snapshot_stats()["active_snapshots"],
                   s._native.tenant_stats("eval")["bytes"] - t0]
            s._native.gateway_renew(token)
            out.append(s.gateway_stats()["renewals"])
            s._native.gateway_detach(token)
            out += [_counters(s.gateway_stats()),
                    s.snapshot_stats()["active_snapshots"],
                    s._native.tenant_stats("eval")["bytes"] - t0]
            return out

    ref, port = both(case)
    assert port == ref
    assert port[0] and port[2:5] == [1, 4096, 1] and port[6:] == [0, 0]
    assert (port[1]["sessions"], port[5]["sessions"],
            port[5]["detaches"]) == (1, 0, 1)


def test_lease_expiry_reaps_pins_quota_and_session():
    def case(P):
        with _ones(P) as s:
            s.set_tenant_quota("eval", 1 << 20)
            _arm(s, lease_ms=60)
            token = s._native.gateway_attach(tenant="eval",
                                             with_snapshot=True,
                                             quota_bytes=4096)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                s.gateway_reap()
                if s.gateway_stats()["sessions"] == 0:
                    break
                time.sleep(0.02)
            gs = s.gateway_stats()
            code = None
            with pytest.raises(P.DDStoreError) as ei:
                s._native.gateway_renew(token)
            code = ei.value.code
            return (gs["sessions"], gs["expired"] >= 1,
                    s.snapshot_stats()["active_snapshots"],
                    s._native.tenant_stats("eval")["bytes"], code)

    ref, port = both(case)
    assert port == ref and port[:4] == (0, True, 0, 0)


def test_gateway_session_renews_and_closes():
    def case(P):
        data = np.arange(ROWS * DIM, dtype=np.float32).reshape(ROWS, DIM)
        with P.DDStore(backend="local") as s:
            s.add("v", data)
            _arm(s, lease_ms=90)
            with s.gateway_session(tenant="eval") as sess:
                assert isinstance(sess, P.GatewaySession)
                got = sess.get_batch("v", [1, 5, 9])
                np.testing.assert_array_equal(got, data[[1, 5, 9]])
                shape = sess.get("v", 3, 2).shape
                sess.renew()
                alive = sess.alive()
            gs = s.gateway_stats()
            closed = sess.alive()
            sess.close()
            return (shape, alive, closed, gs["attaches"], gs["detaches"],
                    gs["sessions"], sorted(sess.stats()),
                    sess.stats()["admission_retries"])

    ref, port = both(case)
    assert port == ref == ((2, DIM), True, False, 1, 1, 0, port[6], 0)


def test_remote_attach_over_control_connection(monkeypatch):
    monkeypatch.setenv("DDSTORE_GATEWAY", "1")

    def case(P):
        def body(s):
            _arm(s)
            token = s._native.gateway_attach(target=1, tenant="eval",
                                             quota_bytes=256)
            s._native.gateway_renew(token, target=1)
            s._native.gateway_detach(token, target=1)
            return token > 0, token >> 32

        return run_pair(P, body, ROWS, DIM)

    ref, port = both(case)
    assert port == ref == (True, 1)


def test_admission_defer_then_reject_ordering():
    def case(P):
        with _ones(P) as s:
            _arm(s, defer_ms=20)
            _pressurize(s)
            base = s.gateway_stats()
            eval_view = s.attach("eval")
            t0 = time.monotonic()
            with pytest.raises(P.DDStoreError) as ei:
                eval_view.get_batch("v", np.arange(8))
            waited = time.monotonic() - t0
            gs = s.gateway_stats()
            s.get_batch("v", np.arange(8))
            return (base["deferred"], base["rejected"], ei.value.code,
                    getattr(ei.value, "retry_after_ms", 0) > 0,
                    "defer" in str(ei.value), gs["deferred"] >= 1,
                    gs["rejected"] >= 1, gs["last_retry_after_ms"] > 0,
                    waited >= 0.015,
                    s.gateway_stats()["admitted"] > base["admitted"])

    ref, port = both(case)
    assert port == ref
    assert port == (0, 0, PKGS["torch"].binding.ERR_ADMISSION) + (True,) * 7


def test_protected_tenant_flows_under_adversarial_overshare():
    def case(P):
        with _ones(P) as s:
            _arm(s, defer_ms=5)
            _pressurize(s)
            eval_view = s.attach("eval")
            codes = []
            for _ in range(6):
                with pytest.raises(P.DDStoreError) as ei:
                    eval_view.get_batch("v", np.arange(16))
                codes.append(ei.value.code)
                s.get_batch("v", np.arange(16))
            gs = s.gateway_stats()
            return codes, gs["rejected"] >= 6, gs["admitted"] >= 7

    ref, port = both(case)
    assert port == ref
    assert port == ([PKGS["torch"].binding.ERR_ADMISSION] * 6, True, True)


def test_admission_clears_when_pressure_clears():
    def case(P):
        with _ones(P) as s:
            _arm(s, defer_ms=5)
            _pressurize(s)
            eval_view = s.attach("eval")
            code = None
            with pytest.raises(P.DDStoreError) as ei:
                eval_view.get_batch("v", np.arange(8))
            code = ei.value.code
            s.set_tenant_slos("")
            return code, eval_view.get_batch("v", np.arange(8)).shape

    ref, port = both(case)
    assert port == ref
    assert port == (PKGS["torch"].binding.ERR_ADMISSION, (8, DIM))


def test_drain_semantics():
    def case(P):
        with _ones(P) as s:
            _arm(s)
            s.set_tenant_slos("p99:1s")
            out = [s.gateway_drain(deadline_ms=200),
                   s.gateway_stats()["draining"]]
            with pytest.raises(P.DDStoreError) as ei:
                s.get_batch("v", np.arange(4))
            out.append(ei.value.code)
            with pytest.raises(P.DDStoreError) as ei:
                s.gateway_session(tenant="eval")
            out.append(ei.value.code)
            out.append(s.gateway_stats()["drain_sheds"] >= 1)
            s.gateway_configure(enabled=1)
            out.append(s.gateway_stats()["draining"])
            out.append(s.get_batch("v", np.arange(4)).shape)
            return out

    ref, port = both(case)
    adm = PKGS["torch"].binding.ERR_ADMISSION
    assert port == ref == [True, 1, adm, adm, True, 0, (4, DIM)]


def test_elastic_recover_drains_gateway():
    def case(P):
        with _ones(P) as s:
            _arm(s)
            if s.gateway_stats()["enabled"]:
                assert s.gateway_drain(deadline_ms=500) is True
            draining = s.gateway_stats()["draining"]
            s.gateway_configure(enabled=1)
            reopened = s.gateway_stats()["draining"]
            with s.gateway_session(tenant="eval") as sess:
                got = sess.get_batch("v", [0, 1]).tolist()
            return draining, reopened, got

    ref, port = both(case)
    assert port == ref == (1, 0, [[1.0] * DIM] * 2)


def test_session_retry_after_backoff_then_giveup():
    def case(P):
        with _ones(P) as s:
            _arm(s, defer_ms=5)
            sess = s.gateway_session(tenant="eval", max_retries=2, seed=11)
            _pressurize(s)
            t0 = time.monotonic()
            with pytest.raises(P.DDStoreError) as ei:
                sess.get_batch("v", np.arange(8))
            elapsed = time.monotonic() - t0
            st = sess.stats()
            assert st["backoff_s"] > 0 and elapsed >= st["backoff_s"]
            sess2 = s.gateway_session(tenant="eval", max_retries=2,
                                      seed=11)
            with pytest.raises(P.DDStoreError):
                sess2.get_batch("v", np.arange(8))
            st2 = sess2.stats()
            assert st2["backoff_s"] == pytest.approx(st["backoff_s"],
                                                     rel=0.5)
            sess.close()
            sess2.close()
            return ei.value.code, _counters(st), _counters(st2)

    ref, port = both(case)
    assert port == ref
    assert port[1]["admission_retries"] == 2
    assert port[1]["admission_giveups"] == 1


def test_retry_max_env_default(monkeypatch):
    monkeypatch.setenv("DDSTORE_GW_RETRY_MAX", "1")

    def case(P):
        with _ones(P) as s:
            _arm(s, defer_ms=5)
            sess = s.gateway_session(tenant="eval")
            _pressurize(s)
            with pytest.raises(P.DDStoreError):
                sess.get_batch("v", np.arange(8))
            out = sess.max_retries, sess.stats()["admission_retries"]
            sess.close()
            return out

    ref, port = both(case)
    assert port == ref == (1, 1)


def test_pin_ttl_reclaims_stranded_pin_with_gateway_off():
    def case(P):
        with _ones(P) as s:
            s.gateway_configure(pin_ttl_ms=50)
            out = [s.gateway_stats()["enabled"]]
            h = s.attach("eval", snapshot=True)
            out.append(s.snapshot_stats()["active_snapshots"])
            time.sleep(0.08)
            s.gateway_reap()
            st = s.snapshot_stats()
            out.append((st["active_snapshots"], st["reclaimed_pins"]))
            h2 = s.attach("eval", snapshot=True)
            out.append(s.gateway_reap())
            st = s.snapshot_stats()
            out.append((st["active_snapshots"], st["reclaimed_pins"]))
            h2.detach()
            h.detach()
            return out

    ref, port = both(case)
    assert port == ref == [0, 1, (0, 1), 0, (1, 1)]


def test_conndrop_is_ctrl_only():
    def case(P):
        with pytest.raises(P.DDStoreError) as ei:
            P.fault_configure("conndrop:0.5", seed=1)
        P.fault_configure("ctrl-conndrop:0.5", seed=1)
        P.fault_configure("", 0)
        return ei.value.code

    ref, port = both(case)
    assert port == ref


def _conndrop_workload(P, s):
    P.fault_configure("ctrl-conndrop:0.4", seed=5)
    try:
        outs = []
        for _ in range(6):
            token = 0
            try:
                token = s._native.gateway_attach(target=1, tenant="eval")
            except P.DDStoreError:
                pass
            outs.append(s.get_batch("v", np.arange(ROWS,
                                                   ROWS + 32)).copy())
            if token > 0:
                try:
                    s._native.gateway_detach(token, target=1)
                except P.DDStoreError:
                    pass
        fs = s.fault_stats()
        assert fs["ctrl_checks"] > 0
        assert fs["injected_reset"] == 0 and fs["injected_trunc"] == 0
        counters = (fs["ctrl_checks"], fs["ctrl_injected"],
                    fs["retry_giveups"])
    finally:
        P.fault_configure("", 0)
    return np.concatenate(outs), counters


def test_ctrl_conndrop_deterministic_and_byte_exact(monkeypatch):
    monkeypatch.setenv("DDSTORE_GATEWAY", "1")

    def case(P):
        out1, c1 = run_pair(P, lambda s: _conndrop_workload(P, s),
                            ROWS, DIM)
        out2, c2 = run_pair(P, lambda s: _conndrop_workload(P, s),
                            ROWS, DIM)
        np.testing.assert_array_equal(out1, np.full_like(out1, 2.0))
        np.testing.assert_array_equal(out1, out2)
        assert c1 == c2
        return out1.tobytes(), c1

    ref, port = both(case)
    assert port == ref
    assert port[1][1] > 0 and port[1][2] == 0


def test_summary_gateway_deltas():
    def case(P):
        with _ones(P) as s:
            _arm(s)
            pm = P.PipelineMetrics()
            pm.set_gateway_source(s.gateway_stats)
            pm.epoch_start()
            with s.gateway_session(tenant="eval") as sess:
                sess.get_batch("v", np.arange(8))
            pm.epoch_end()
            first = pm.summary()["gateway"]
            assert all(k in first for k in P.binding.GATEWAY_GAUGE_KEYS)
            pm.epoch_start()
            pm.epoch_end()
            second = pm.summary()["gateway"]
            return first, second

    ref, port = both(case)
    assert port == ref
    first, second = port
    assert (first["enabled"], first["attaches"], first["detaches"]) == \
        (1, 1, 1) and first["admitted"] >= 1
    assert second["attaches"] == 0 and second["admitted"] == 0


def test_planner_sees_admission_pressure():
    def case(P):
        with _ones(P) as s:
            sched = P.Scheduler(s, enabled=True)
            r0 = sched.replans
            sched.on_admission_pressure(deferred=3, rejected=0)
            sched.on_admission_pressure(deferred=0, rejected=2)
            return (sched.replans - r0,
                    [r for r in sched.reasons if r.startswith("admission")])

    ref, port = both(case)
    assert port == ref
    assert port[0] == 2 and len(port[1]) == 2


def test_gateway_knobs_registered():
    """The session's knobs are the registry's, under the same names, in
    the port's copy of the registry as in the JAX package's."""
    from ddstore_tpu.sched.knobs import REGISTRY as REF
    from ddstore_tpu_torch.sched.knobs import REGISTRY

    for env in ("DDSTORE_GATEWAY", "DDSTORE_GW_LEASE_MS",
                "DDSTORE_GW_DEFER_MS", "DDSTORE_GW_QUEUE",
                "DDSTORE_GW_ADMIT_MARGIN", "DDSTORE_GW_LANE_SHARE",
                "DDSTORE_GW_RETRY_MAX", "DDSTORE_SNAP_PIN_TTL_MS",
                "DDSTORE_GATEWAY_PHASE_TIMEOUT_S"):
        assert env in REGISTRY and REGISTRY[env].kind == "config", env
        fields = ("env", "kind", "pins", "description")
        assert [getattr(REGISTRY[env], f) for f in fields] == \
            [getattr(REF[env], f) for f in fields], env
