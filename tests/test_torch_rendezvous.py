"""The port's control-plane groups (``ddstore_tpu_torch.rendezvous``)
against the JAX package's: the FileGroup protocol cases of
``tests/test_rendezvous.py`` on the port's FileGroup, the scheduler
detection of ``tests/test_pod_bootstrap.py`` compared case by case with
the reference's, and the port's own TorchGroup and pod_bootstrap over
gloo in spawned processes. Exact equality throughout."""

import os
import pickle
import socket
import threading
import time

import pytest

import ddstore_tpu as ref
from ddstore_tpu_torch import rendezvous as rdv
from torch_workers import pod_bootstrap_rank, spawn, torch_group_ops

pytestmark = pytest.mark.tier1_required


def _run_member(results, key, *args, **kwargs):
    try:
        g = rdv.FileGroup(*args, **kwargs)
        results[key] = ("ok", g.allgather(key))
    except Exception as e:  # noqa: BLE001
        results[key] = ("err", str(e))


def test_world_forms_and_allgathers(tmp_path):
    results = {}
    ts = [threading.Thread(target=_run_member,
                           args=(results, f"r{r}", str(tmp_path), r, 3))
          for r in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert all(v[0] == "ok" for v in results.values()), results
    assert results["r0"][1] == ["r0", "r1", "r2"]


def test_launch_id_excludes_cross_launch_straggler(tmp_path):
    results = {}
    zombie = threading.Thread(
        target=_run_member,
        args=(results, "zombie", str(tmp_path), 1, 2),
        kwargs={"timeout": 10.0, "launch_id": "A"})
    zombie.start()
    time.sleep(0.3)  # the straggler waits for a marker
    ts = [threading.Thread(
        target=_run_member,
        args=(results, f"b{r}", str(tmp_path), r, 2),
        kwargs={"timeout": 30.0, "launch_id": "B"}) for r in (0, 1)]
    ts[0].start()
    time.sleep(0.3)  # the straggler adopts the marker first
    ts[1].start()
    for t in ts:
        t.join(timeout=60)
    zombie.join(timeout=30)
    assert results["b0"][0] == "ok", results
    assert results["b1"][0] == "ok", results
    assert results["b0"][1] == ["b0", "b1"]
    assert results["zombie"][0] == "err", results
    assert "another process" in results["zombie"][1], results


def test_allgather_fails_fast_when_new_world_takes_directory(tmp_path):
    results = {}

    def member(rank):
        t0 = time.time()
        try:
            g = rdv.FileGroup(str(tmp_path), rank, 2, timeout=60.0)
            g.allgather(rank)
            if rank == 0:
                time.sleep(0.5)  # then a new launch takes the directory
                for f in os.listdir(tmp_path):
                    if f.endswith(".pkl"):
                        os.unlink(os.path.join(tmp_path, f))
                with open(os.path.join(tmp_path, "MARKER"), "w") as fh:
                    fh.write("feedfacefeed")
                results[rank] = ("ok", None)
            else:
                t0 = time.time()
                g.allgather("never-completes")
                results[rank] = ("ok", None)
        except TimeoutError as e:
            results[rank] = ("err", str(e), time.time() - t0)

    ts = [threading.Thread(target=member, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=90)
    assert results[0][0] == "ok", results
    assert results[1][0] == "err", results
    assert "generation changed" in results[1][1], results
    assert results[1][2] < 30.0, results


def test_tmp_litter_is_wiped_on_fresh_launch(tmp_path):
    (tmp_path / "deadbeef.hello.3.pkl.tmp").write_text("x")
    (tmp_path / "MARKER.tmp").write_text("x")
    rdv.FileGroup(str(tmp_path), 0, 1)
    left = [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert left == [], left


def test_stale_roster_never_admits_fresh_process(tmp_path):
    stale = "deadc0dedead"
    (tmp_path / "MARKER").write_text(stale)
    for r in range(2):
        (tmp_path / f"{stale}.hello.{r}.pkl").write_bytes(
            pickle.dumps((None, f"deadbeef{r:04d}")))
    (tmp_path / f"{stale}.roster.pkl").write_bytes(
        pickle.dumps({0: "deadbeef0000", 1: "deadbeef0001"}))
    with pytest.raises(TimeoutError):
        rdv.FileGroup(str(tmp_path), 1, 2, timeout=3.0)


def test_thread_group_split_matches_reference():
    def run(mod, name, out):
        def member(r):
            g = mod.ThreadGroup(name, r, 4)
            sub = g.split(r // 2)
            out[r] = (g.allgather(r), sub.rank, sub.size,
                      sub.allgather(r), g.broadcast(r * 3, root=2))
        ts = [threading.Thread(target=member, args=(r,)) for r in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)

    want, got = {}, {}
    run(ref, "tg-ref", want)
    run(rdv, "tg-port", got)
    assert got == want and len(got) == 4


NODELISTS = ["a,b,c", "login1", "tpu[001-003]", "n[1-2,07],login1", "",
             "cn[1-2]-ib", "r[0-1]n[01-02]", "a[1-2]x,b"]


@pytest.mark.parametrize("nodelist", NODELISTS)
def test_parse_nodelist_matches_reference(nodelist):
    assert rdv.parse_nodelist(nodelist) == ref.parse_nodelist(nodelist)


POD_ENVS = [
    ({}, 8476),
    ({"DDSTORE_COORDINATOR": "10.0.0.5:9999", "DDSTORE_NUM_PROCESSES": "4",
      "DDSTORE_PROCESS_ID": "2"}, 8476),
    ({"DDSTORE_COORDINATOR": "10.0.0.5", "DDSTORE_NUM_PROCESSES": "2",
      "DDSTORE_PROCESS_ID": "0"}, 1234),
    ({"TPU_WORKER_HOSTNAMES": "t0,t1,t2,t3", "TPU_WORKER_ID": "3"}, 8476),
    ({"SLURM_PROCID": "5", "SLURM_NPROCS": "8",
      "SLURM_NODELIST": "tpu[001-004]"}, 8476),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "2", "SLURM_NODELIST": "n1,n2"},
     8476),
    ({"SLURM_PROCID": "0"}, 8476),
    ({"LSB_MCPU_HOSTS": "batch1 1 compute1 42 compute2 42",
      "OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "2"}, 8476),
    ({"LSB_MCPU_HOSTS": "", "OMPI_COMM_WORLD_RANK": "0",
      "OMPI_COMM_WORLD_SIZE": "2"}, 8476),
    ({"LSB_MCPU_HOSTS": "h 4", "OMPI_COMM_WORLD_RANK": "0"}, 8476),
    ({"DDSTORE_COORDINATOR": "c:1", "DDSTORE_NUM_PROCESSES": "2",
      "DDSTORE_PROCESS_ID": "0", "SLURM_PROCID": "9",
      "SLURM_NODELIST": "x"}, 8476),
]


@pytest.mark.parametrize("env,port", POD_ENVS)
def test_detect_pod_env_matches_reference(env, port):
    got, want = rdv.detect_pod_env(env, port), ref.detect_pod_env(env, port)
    assert (got is None) == (want is None)
    if want is not None:
        assert [getattr(got, k) for k in want.__slots__] == \
            [getattr(want, k) for k in want.__slots__]


def test_single_process_groups(tmp_path, monkeypatch):
    g = rdv.pod_bootstrap(env={})
    assert isinstance(g, rdv.SingleGroup) and (g.rank, g.size) == (0, 1)
    assert isinstance(rdv.auto_group(), rdv.SingleGroup)
    monkeypatch.setenv("DDSTORE_RANK", "0")
    monkeypatch.setenv("DDSTORE_WORLD", "1")
    monkeypatch.setenv("DDSTORE_RDV_DIR", str(tmp_path))
    g = rdv.auto_group()
    assert isinstance(g, rdv.FileGroup) and g.allgather(5) == [5]
    with pytest.raises(RuntimeError, match="init_process_group"):
        rdv.TorchGroup()


def test_torch_group_over_gloo(tmp_path):
    ranks = spawn(3, torch_group_ops, str(tmp_path))
    subs = {0: [0, 20], 1: [10], 2: [0, 20]}
    for r, out in enumerate(ranks):
        assert (out["rank"], out["size"]) == (r, 3)
        assert out["gathered"] == [("r", i, {"x": [i]}) for i in range(3)]
        assert out["sub"] == ({0: 0, 1: 0, 2: 1}[r], len(subs[r]), subs[r])
        assert out["bcast"] == "from2"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_pod_bootstrap_brings_up_torch_distributed(tmp_path):
    ranks = spawn(2, pod_bootstrap_rank, str(tmp_path), _free_port())
    for r, out in enumerate(ranks):
        assert out == ("TorchGroup", r, 2, [0, 1], "TorchGroup", 2)
