"""The port's tenant layer (``ddstore_tpu_torch.tenant``: the
``TenantHandle`` behind ``DDStore.attach``, the quota, share and
lane-budget setters, the spec parsers; ``summary()["tenants"]``)
against the JAX package's, case by case with ``tests/test_tenants.py``.

Every case runs once on each package over its own native core, and the
two must agree: scoped and snapshot names are the same strings, quota
and admission refusals carry the same codes, ``tenant_stats`` and the
epoch summaries have the same keys and counters, the seeded fault
schedule of the default tenant draws the same counters."""

import threading

import numpy as np
import pytest

from torch_services import PKGS, both, run_group

pytestmark = pytest.mark.tier1_required

NUM, DIM = 16, 8


def stamp(rank, salt=0, num=NUM, dim=DIM):
    """A shard whose every row tells its owner and version."""
    return np.full((num, dim), (salt * 100) + rank + 1, dtype=np.float64)


def _code(P, fn):
    """The code of the ``DDStoreError`` that ``fn()`` raises."""
    with pytest.raises(P.DDStoreError) as ei:
        fn()
    return ei.value.code


def test_default_tenant_is_inert_and_byte_identical(monkeypatch):
    monkeypatch.delenv("DDSTORE_TENANT_QUOTAS", raising=False)
    monkeypatch.delenv("DDSTORE_TENANT_SHARES", raising=False)
    monkeypatch.setenv("DDSTORE_CMA", "0")
    monkeypatch.setenv("DDSTORE_RETRY_MAX", "4")
    monkeypatch.setenv("DDSTORE_RETRY_BASE_MS", "5")

    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="tcp") as s:
                s.add("v", stamp(rank))
                s.barrier()
                out = None
                if rank == 0:
                    assert s._native.query("v")["total_rows"] == 2 * NUM
                    names = s._native.tenant_names()
                    idx = np.arange(NUM, 2 * NUM)
                    P.fault_configure("reset:0.25", seed=123)
                    try:
                        for _ in range(6):
                            got = s.get_batch("v", idx)
                    finally:
                        checks = s.fault_stats()
                        P.fault_configure("", 0)
                    np.testing.assert_array_equal(got, stamp(1))
                    out = (names, {k: checks[k] for k in (
                        "fault_checks", "injected_reset",
                        "retry_transient", "retry_reconnects")})
                s.barrier()
                return out

        return run_group(P, 2, body)[0]

    ref, port = both(case)
    assert port == ref == ([], {"fault_checks": 7, "injected_reset": 1,
                                "retry_transient": 1,
                                "retry_reconnects": 1})


def test_metrics_summary_has_no_tenant_section_by_default():
    def case(P):
        m = P.PipelineMetrics()
        m.set_tenant_source(lambda: {})
        m.epoch_start()
        m.epoch_end()
        return "tenants" in m.summary()

    assert both(case) == (False, False)


def test_namespace_isolation_and_shared_default_reads():
    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                s.add("shared", stamp(rank))
                a = s.attach("job-a")
                b = s.attach("job-b")
                assert isinstance(a, P.tenant.TenantHandle)
                a.add("ds", stamp(rank, salt=1))
                b.add("ds", stamp(rank, salt=2))
                got = [a.get("ds", 0)[0], b.get("ds", 0)[0],
                       a.get("shared", 0)[0]]
                codes = [_code(P, lambda: a.update("shared",
                                                   stamp(rank, salt=9)))]
                a.free("ds")
                s.barrier()
                got.append(b.get("ds", 0)[0])
                with pytest.raises(KeyError, match="refused"):
                    a.get("other-only", 0)
                codes.append(_code(P, lambda: b.free("not-mine-either")))
                names = sorted(s._native.tenant_names())
                s.barrier()
                return [g.tolist() for g in got], codes, names

        return run_group(P, 2, body)

    ref, port = both(case)
    assert port == ref
    got = port[0][0]
    assert got == [stamp(0, 1)[0].tolist(), stamp(0, 2)[0].tolist(),
                   stamp(0)[0].tolist(), stamp(0, 2)[0].tolist()]


def test_tenant_namespace_is_shared_across_handles_and_snapshots():
    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                a = s.attach("job-a")
                a.add("ds", stamp(rank, salt=1))
                a2 = s.attach("job-a")
                got = [a2.get("ds", 0)[0].tolist()]
                snap = s.attach("job-a", snapshot=True) if rank == 0 \
                    else None
                s.barrier()
                a.update("ds", stamp(rank, salt=2))
                s.barrier()
                got.append(a2.get("ds", 0)[0].tolist())
                if rank == 0:
                    got.append(snap.get("ds", 0)[0].tolist())
                    snap.detach()
                s.barrier()
                return got

        return run_group(P, 2, body)

    ref, port = both(case)
    assert port == ref
    assert port[0] == [stamp(0, 1)[0].tolist(), stamp(0, 2)[0].tolist(),
                       stamp(0, 1)[0].tolist()]


def test_default_quota_configured_after_add_releases_only_reserved():
    shard = NUM * DIM * 8

    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                s.add("v1", stamp(rank))
                s.set_tenant_quota("", max_bytes=2 * shard)
                s.add("v2", stamp(rank, salt=1))
                s.free("v1")
                st = s._native.tenant_stats("")
                s.add("v3", stamp(rank, salt=2))
                code = _code(P, lambda: s.add("v4", stamp(rank, salt=3)))
                s.barrier()
                return (st["bytes"], st["vars"]), code

        return run_group(P, 1, body)

    ref, port = both(case)
    assert port == ref == [((shard, 1),
                            PKGS["torch"].binding.ERR_QUOTA)]


def test_uneven_shard_quota_verdict_agrees_across_ranks():
    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                s.set_tenant_quota("t", max_bytes=(3 * NUM * DIM * 8) // 2)
                h = s.attach("t")
                rows = 2 * NUM if rank == 0 else NUM // 2
                code = _code(P, lambda: h.add(
                    "uneven", np.full((rows, DIM), rank + 1.0)))
                h.add("uneven", stamp(rank))
                s.barrier()
                return code

        return run_group(P, 2, body)

    ref, port = both(case)
    assert port == ref == [PKGS["torch"].binding.ERR_QUOTA] * 2


def test_tenant_label_validation_covers_runtime_setters():
    def case(P):
        def body(rank, group):
            refused = []
            with P.DDStore(group, backend="local") as s:
                for bad in ("a,b", "a=b", "x:y", "c\x02d", "\x03s"):
                    for setter, arg in ((s.set_tenant_quota, 1),
                                        (s.set_tenant_share, 2),
                                        (s.set_tenant_lane_budget, 1),
                                        (s.set_tier_placement, True)):
                        with pytest.raises(ValueError):
                            setter(bad, arg)
                        refused.append(bad)
                s.barrier()
            return len(refused)

        return (run_group(P, 1, body),
                P.tenant.parse_share_spec("ok=2,b\x02ad=3"),
                P.tenant.parse_quota_spec("ok=64,b\x02ad=128"))

    ref, port = both(case)
    assert port == ref == ([20], {"ok": 2}, {"ok": (64, -1)})


def test_quota_spec_suffix_never_bricks_a_tenant(monkeypatch):
    monkeypatch.setenv("DDSTORE_TENANT_QUOTAS",
                       f"a={4 * NUM * DIM * 8}:,b=10:x,c=10x")

    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                h = s.attach("a")
                h.add("v1", stamp(rank))
                h.add("v2", stamp(rank))
                out = (s._native.tenant_stats("a")["quota_vars"],
                       [s._native.tenant_stats(t)["quota_bytes"]
                        for t in ("b", "c")])
                s.barrier()
                return out

        return (run_group(P, 1, body),
                P.tenant.parse_quota_spec("a=64:,b=10:x,c=10x"))

    ref, port = both(case)
    assert port == ref == ([(-1, [-1, -1])], {"a": (64, -1)})


def test_snapshot_pins_scope_to_reader_namespace():
    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                a = s.attach("A")
                a.add("big", stamp(rank, salt=1))
                snap_b = s.attach("B", snapshot=True)
                s.barrier()
                a.update("big", stamp(rank, salt=2))
                s.barrier()
                kept = s.snapshot_stats()["kept_versions"]
                got = a.get("big", 0)[0].tolist()
                snap_b.detach()
                s.barrier()
                return kept, got

        return run_group(P, 2, body)

    ref, port = both(case)
    assert port == ref == [(0, stamp(0, 2)[0].tolist())] * 2


def test_free_readd_under_live_snapshot_never_aliases_stale_pin():
    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                s.add("data", stamp(rank, salt=1))
                ev = s.attach("eval", snapshot=True)
                s.free("data")
                s.add("data", stamp(rank, salt=9))
                got = [ev.get("data", 0)[0].tolist()]
                s.barrier()
                s.update("data", stamp(rank, salt=10))
                s.barrier()
                kept = s.snapshot_stats()["kept_versions"]
                got.append(ev.get("data", 0)[0].tolist())
                ev.detach()
                s.barrier()
                return kept, got

        return run_group(P, 2, body)

    ref, port = both(case)
    assert port == ref
    assert port[0] == (0, [stamp(0, 9)[0].tolist(),
                           stamp(0, 10)[0].tolist()])


def test_duplicate_add_at_quota_is_exists_not_quota():
    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                s.set_tenant_quota("capped", max_bytes=NUM * DIM * 8)
                c = s.attach("capped")
                c.add("ok", stamp(rank))
                with pytest.raises(P.DDStoreError) as ei:
                    c.add("ok", stamp(rank))
                out = (ei.value.code, "exists" in str(ei.value).lower(),
                       s._native.tenant_stats("capped")["quota_rejections"])
                s.barrier()
                return out

        return run_group(P, 1, body)

    ref, port = both(case)
    assert port == ref
    assert port[0][0] != PKGS["torch"].binding.ERR_QUOTA
    assert port[0][1:] == (True, 0)


def test_default_tenant_row_visible_and_reads_ledger_under_reader():
    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                s.add("shared", stamp(rank))
                s.set_tenant_quota("", max_bytes=-1, max_vars=-1)
                visible = ("" in s._native.tenant_names(),
                           "" in s.tenant_stats())
                ev = s.attach("eval")
                before = s._native.tenant_stats("eval")["read_bytes"]
                ev.get_batch("shared", np.arange(2 * NUM))
                after = s._native.tenant_stats("eval")["read_bytes"]
                ev.get("shared", 0)
                single = s._native.tenant_stats("eval")["read_bytes"] - after
                s.barrier()
                return visible, after - before, single

        return run_group(P, 2, body)

    ref, port = both(case)
    assert port == ref == [((True, True), 2 * NUM * DIM * 8, DIM * 8)] * 2


def test_scoped_names_cannot_be_forged_from_user_strings():
    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                with pytest.raises(ValueError, match="control"):
                    s.add("\x02evil\x02x", stamp(rank))
                with pytest.raises(ValueError, match="control"):
                    s.attach("bad\x02tenant")
                with pytest.raises(ValueError, match="reserved"):
                    s.attach("a=b")
            return True

        run_group(P, 1, body)
        t = P.tenant
        return (t.scoped_name("", "x"), t.scoped_name("t", "x"),
                t.snapshot_name(7, t.scoped_name("t", "x")),
                t.TENANT_SEP, t.SNAP_PREFIX)

    ref, port = both(case)
    assert port == ref
    assert port[:2] == ("x", "\x02t\x02x")


def test_quota_rejection_is_its_own_nonfatal_class(monkeypatch):
    monkeypatch.setenv("DDSTORE_TENANT_QUOTAS",
                       f"capped={3 * NUM * DIM * 8}:2")

    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                s.add("base", stamp(rank))
                c = s.attach("capped")
                c.add("ok", stamp(rank))
                with pytest.raises(P.DDStoreError) as ei:
                    c.add("too-big", np.zeros((4 * NUM, DIM)))
                first = (ei.value.code, "quota" in str(ei.value).lower())
                np.testing.assert_array_equal(c.get("ok", 0)[0],
                                              stamp(0)[0])
                st = s.tenant_stats()["capped"]
                c.add("two", stamp(rank))
                second = _code(P, lambda: c.add("three", stamp(rank)))
                c.free("two")
                s.barrier()
                c.add("three", stamp(rank))
                s.barrier()
                return first, st, second

        return run_group(P, 2, body)

    ref, port = both(case)
    assert port == ref
    quota = PKGS["torch"].binding.ERR_QUOTA
    (first, st, second) = port[0]
    assert first == (quota, True) and second == quota
    assert st["quota_rejections"] >= 1 and st["vars"] == 1
    assert st["bytes"] == NUM * DIM * 8


def test_quota_and_share_spec_parsers():
    def case(P):
        t = P.tenant
        return (t.parse_quota_spec("a=100:2,b=5"),
                t.parse_quota_spec("bad,=x,c=1:1"),
                t.parse_share_spec("a=3,b=1,junk,c=0"),
                t.share_split(8, {"busy": 7, "capped": 1}),
                t.share_split(2, {"a": 1, "b": 1, "c": 6}))

    ref, port = both(case)
    assert port == ref == ({"a": (100, 2), "b": (5, -1)}, {"c": (1, 1)},
                           {"a": 3, "b": 1}, {"busy": 7, "capped": 1},
                           {"a": 1, "b": 1, "c": 1})


def test_async_admission_share_defers_not_rejects():
    rows = 4096

    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                s.set_async_width(2)
                s.set_tenant_share("fg", 3)
                s.set_tenant_share("bg", 1)
                fg, bg = s.attach("fg"), s.attach("bg")
                fg.add("ds", stamp(rank, salt=1, num=rows))
                bg.add("ds", stamp(rank, salt=2, num=rows))
                idx = np.arange(2 * rows)
                want_bg = np.concatenate([stamp(r, salt=2, num=rows)
                                          for r in range(2)])
                want_fg = np.concatenate([stamp(r, salt=1, num=rows)
                                          for r in range(2)])
                submitted = 0
                for _ in range(50):
                    h = [bg.get_batch_async("ds", idx) for _ in range(8)]
                    g = [fg.get_batch_async("ds", idx) for _ in range(2)]
                    submitted += 10
                    for hh in h:
                        np.testing.assert_array_equal(hh.wait(), want_bg)
                    for gg in g:
                        np.testing.assert_array_equal(gg.wait(), want_fg)
                    if s.tenant_stats()["bg"]["async_deferred"] >= 1:
                        break
                st = s.tenant_stats()
                out = (s.async_pending(), st["bg"]["async_deferred"] >= 1,
                       st["bg"]["async_admitted"]
                       + st["fg"]["async_admitted"] == submitted,
                       st["fg"]["share"], st["bg"]["share"])
                s.barrier()
                return out

        return run_group(P, 2, body)

    ref, port = both(case)
    assert port == ref == [(0, True, True, 3, 1)] * 2


@pytest.mark.parametrize("backend", ["local", "tcp"])
def test_snapshot_reader_stable_across_update_fence(backend, monkeypatch):
    monkeypatch.setenv("DDSTORE_CMA", "0")

    def case(P):
        gates = {g: threading.Barrier(2) for g in ("pinned", "updated")}

        def body(rank, group):
            with P.DDStore(group, backend=backend) as s:
                s.add("data", stamp(rank, salt=1))
                ev = s.attach(tenant="eval", snapshot=True) if rank == 0 \
                    else None
                gates["pinned"].wait()
                s.epoch_begin()
                s.update("data", stamp(rank, salt=2))
                s.epoch_end()
                gates["updated"].wait()
                idx = np.arange(2 * NUM)
                out = []
                if rank == 0:
                    out.append(ev.get_batch("data", idx)[:, 0].tolist())
                    st = s.snapshot_stats()
                    out.append((st["kept_versions"],
                                st["active_snapshots"]))
                    ev.detach()
                    out.append(ev.get_batch("data", idx)[:, 0].tolist())
                out.append(s.get_batch("data", idx)[:, 0].tolist())
                s.barrier()
                st = s.snapshot_stats()
                out.append((st["kept_versions"], st["kept_bytes"],
                            st["active_snapshots"]))
                s.barrier()
                return out

        return run_group(P, 2, body)

    ref, port = both(case)
    assert port == ref
    v1 = [101.0] * NUM + [102.0] * NUM
    v2 = [201.0] * NUM + [202.0] * NUM
    assert port[0] == [v1, (1, 1), v2, v2, (0, 0, 0)]


def test_last_detach_reclaims_kept_version():
    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                s.add("data", stamp(rank, salt=1))
                s1 = s2 = None
                if rank == 0:
                    s1 = s.attach("r1", snapshot=True)
                    s2 = s.attach("r2", snapshot=True)
                s.barrier()
                s.update("data", stamp(rank, salt=2))
                st = s.snapshot_stats()
                out = [(st["kept_versions"], st["kept_bytes"])]
                s.barrier()
                if rank == 0:
                    out.append(s1.get_batch("data", np.arange(2 * NUM))
                               [:, 0].tolist())
                    s1.detach()
                    out.append(s.snapshot_stats()["kept_versions"])
                    out.append(s2.get("data", NUM)[0].tolist())
                    s2.detach()
                s.barrier()
                st = s.snapshot_stats()
                out.append((st["kept_versions"], st["kept_bytes"]))
                s.barrier()
                return out

        return run_group(P, 2, body)

    ref, port = both(case)
    assert port == ref
    assert port[0][0] == (1, NUM * DIM * 8) and port[0][-1] == (0, 0)


def test_snapshot_handle_is_read_only():
    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                s.add("data", stamp(rank))
                snap = s.attach(snapshot=True)
                codes = []
                for call in (lambda: snap.add("x", stamp(rank)),
                             lambda: snap.update("data", stamp(rank)),
                             lambda: snap.free("data")):
                    with pytest.raises(P.DDStoreError,
                                       match="read-only") as ei:
                        call()
                    codes.append(ei.value.code)
                s.add("later", stamp(rank, salt=3))
                got = snap.get("data", 0)[0].tolist()
                snap.detach()
                s.barrier()
                return codes, got

        return run_group(P, 2, body)

    ref, port = both(case)
    assert port == ref
    assert port[0][1] == stamp(0)[0].tolist()


def test_snapshot_pins_are_per_tenant_ledger_visible():
    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                s.add("data", stamp(rank))
                ev = s.attach("eval", snapshot=True) if rank == 0 else None
                s.barrier()
                pins = [s.tenant_stats()["eval"]["snapshot_pins"]]
                s.barrier()
                if rank == 0:
                    ev.detach()
                s.barrier()
                pins.append(s.tenant_stats()["eval"]["snapshot_pins"])
                s.barrier()
                return pins

        return run_group(P, 2, body)

    ref, port = both(case)
    assert port == ref == [[1, 0], [1, 0]]


def test_tenant_metrics_delta_and_gauges():
    def case(P):
        keys = P.binding.TENANT_STAT_KEYS
        assert set(P.binding.TENANT_GAUGE_KEYS) == \
            set(P.PipelineMetrics.TENANT_GAUGES)
        feed = {"busy": dict(zip(keys, [0] * len(keys)))}
        feed["busy"].update(share=7, reads=10, read_bytes=1000, bytes=512)
        m = P.PipelineMetrics()
        m.set_tenant_source(lambda: {t: dict(v) for t, v in feed.items()})
        m.epoch_start()
        feed["busy"].update(reads=25, read_bytes=4000, async_admitted=3)
        feed["capped"] = dict(zip(keys, [0] * len(keys)))
        feed["capped"].update(quota_rejections=2, quota_bytes=4096,
                              share=1)
        m.epoch_end()
        return m.summary()["tenants"]

    ref, port = both(case)
    assert port == ref
    assert (port["busy"]["reads"], port["busy"]["read_bytes"],
            port["busy"]["share"], port["busy"]["bytes"],
            port["capped"]["quota_rejections"]) == (15, 3000, 7, 512, 2)


def test_live_store_tenant_ledger_deltas():
    def case(P):
        def body(rank, group):
            with P.DDStore(group, backend="local") as s:
                s.set_tenant_quota("job", max_bytes=1 << 20)
                j = s.attach("job")
                j.add("ds", stamp(rank))
                m = P.PipelineMetrics()
                m.set_tenant_source(s.tenant_stats)
                idx = np.arange(2 * NUM)
                j.get_batch("ds", idx)
                m.epoch_start()
                for _ in range(3):
                    j.get_batch("ds", idx)
                m.epoch_end()
                row = m.summary()["tenants"]["job"]
                s.barrier()
                return row

        return run_group(P, 2, body)

    ref, port = both(case)
    assert port == ref
    row = port[0]
    assert (row["reads"], row["read_bytes"], row["quota_bytes"],
            row["vars"]) == (3, 3 * 2 * NUM * DIM * 8, 1 << 20, 1)


def test_planner_emits_tenant_budget_cells():
    def case(P):
        class FakeStore:
            backend = "tcp"
            async_width = 8
            world = 2

            def __init__(self):
                self.lane_budgets = {}

            def sched_cells(self):
                return []

            def sched_pin_route(self, cls, mode):
                pass

            def sched_pin_lanes(self, cls, lanes):
                pass

            def set_async_width(self, width):
                pass

            def tenant_stats(self):
                return {"busy": {"share": 7}, "capped": {"share": 1}}

            def lane_state(self):
                return {"max_lanes": 4}

            def set_tenant_lane_budget(self, tenant, lanes):
                self.lane_budgets[tenant] = lanes

        st = FakeStore()
        sched = P.Scheduler(store=st, enabled=True)
        plan = sched.replan("unit")
        exp_w = P.tenant.share_split(
            max(1, int(plan.width or st.async_width)),
            {"busy": 7, "capped": 1})
        assert {t: b["width"] for t, b in plan.tenants.items()} == exp_w
        assert st.lane_budgets == {t: b["lanes"]
                                   for t, b in plan.tenants.items()}
        assert sched.snapshot()["plan"]["tenants"] == plan.tenants

        class NoShares(FakeStore):
            def tenant_stats(self):
                return {"": {"share": 0}}

        class BrokenBudget(FakeStore):
            def set_tenant_lane_budget(self, tenant, lanes):
                raise RuntimeError("closed native handle")

        with pytest.warns(RuntimeWarning, match="not applied"):
            P.Scheduler(store=BrokenBudget(), enabled=True).replan("unit")
        return (plan.tenants, st.lane_budgets,
                P.Scheduler(store=NoShares(), enabled=True).compute([])
                .tenants)

    ref, port = both(case)
    assert port == ref
    assert port[0]["busy"]["lanes"] >= port[0]["capped"]["lanes"] == 1
    assert port[2] == {}
