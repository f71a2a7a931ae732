"""The port's elastic recovery (``ddstore_tpu_torch.elastic``) and its
tiered restores against the JAX package's, case by case with
``tests/test_elastic.py`` and ``tests/test_elastic_tiering.py``.

The spawned-world cases run worker scripts twice at once: as written for
the JAX package, and with every ``ddstore_tpu`` import pointed at
``ddstore_tpu_torch``. Each world of real TCP processes loses its victim
to SIGKILL; the survivors detect the death, recover, and the relaunched
rank rejoins from its checkpoint. Both worlds must pass the worker's own
checks, commit the same generation files, and serve the same rows
afterwards (a digest of every row of every variable, rank by rank).

The worlds of every case start together in one module-scoped fixture:
each waits out the reference's read and barrier timeouts, so they
overlap instead of adding up. Each case keeps its own world. One world
cannot lose two victims in turn: after a recovery the store's group is
the new generation's, and the reference's ``elastic.recover`` refuses a
store whose group is not its world group
(``ddstore_tpu/elastic.py:217-223``), as the port's copy does."""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import test_elastic
import test_elastic_tiering
from torch_services import PKGS, run_group

pytestmark = pytest.mark.tier1_required

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every rank's rows of every variable, digested before the closing
# barrier (after it, a finished rank may exit and stop serving).
_DIGEST = '''
import hashlib
_h = hashlib.sha256()
for _n in ("v", "w"):
    _h.update(store.get_batch(_n, np.arange(store.total_rows(_n))).tobytes())
print("ROWS", _h.hexdigest(), flush=True)
store.barrier()
print("DONE", rank, flush=True)
'''


def _script(template, pkg):
    src = template.format(repo=REPO)
    tail = 'store.barrier()\nprint("DONE", rank, flush=True)\n'
    assert src.endswith(tail)
    src = src[:-len(tail)] + _DIGEST
    if pkg == "torch":
        src = src.replace("from ddstore_tpu import", "from ddstore_tpu_torch "
                          "import").replace("from ddstore_tpu.utils import",
                                            "from ddstore_tpu_torch.utils "
                                            "import")
        assert "ddstore_tpu " not in src and "ddstore_tpu." not in src
    return src


def _world(pkg, tmp, template, world, victim, env, out):
    """One world of the reference harness: launch, wait until the victim
    trains, SIGKILL it, relaunch it as a rejoiner, wait for everyone;
    the ranks' logs go to ``out[pkg]``."""
    root = tmp / pkg
    root.mkdir()
    env = dict(env, DDSTORE_WORLD=str(world), DDSTORE_VICTIM=str(victim),
               DDSTORE_RDV_DIR=str(root / "rdv"),
               DDSTORE_ELASTIC_DIR=str(root / "elastic"),
               DDSTORE_CKPT_DIR=str(root / "ckpt"),
               DDSTORE_SPILL_DIR=str(root / "spill"))
    script = _script(template, pkg)
    logs = [root / f"r{r}.log" for r in range(world)]

    def launch(rank, mode):
        e = dict(env, DDSTORE_RANK=str(rank), DDSTORE_MODE=mode)
        with open(logs[rank], "ab") as log:
            return subprocess.Popen([sys.executable, "-c", script], env=e,
                                    stdout=log, stderr=subprocess.STDOUT)

    procs = {r: launch(r, "initial") for r in range(world)}
    try:
        deadline = time.time() + 90
        while b"VICTIM_READY" not in logs[victim].read_bytes():
            assert time.time() < deadline, logs[victim].read_bytes()
            time.sleep(0.1)
        time.sleep(0.5)
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait()
        time.sleep(1.0)
        procs[victim] = launch(victim, "rejoin")
        rcs = {r: p.wait(timeout=180) for r, p in procs.items()}
        out[pkg] = {"rcs": rcs, "logs": [log.read_bytes() for log in logs],
                    "generation": (root / "elastic" / "GENERATION")
                    .read_text(),
                    "gens": sorted(os.listdir(root / "elastic"))}
    except BaseException as e:  # noqa: BLE001 — reported by the test
        out[pkg] = e
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _both_worlds(tmp, template, world, victim, env):
    """Both packages' worlds of one case, at once; each finished world's
    result, or the exception that ended it, by package."""
    tmp.mkdir()
    out = {}
    ts = [threading.Thread(target=_world, args=(pkg, tmp, template, world,
                                                victim, env, out))
          for pkg in ("jax", "torch")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(400)
    if any(t.is_alive() for t in ts):
        return AssertionError("a world hung")
    return out


def _passed(out):
    """The case's worlds, each of whose ranks exited 0."""
    if isinstance(out, BaseException):
        raise out
    for pkg in ("jax", "torch"):
        if isinstance(out[pkg], BaseException):
            raise out[pkg]
        for r, rc in out[pkg]["rcs"].items():
            assert rc == 0, (pkg, r, out[pkg]["logs"][r].decode(
                errors="replace"))
    return out


def _rows(log):
    return [ln for ln in log.splitlines() if ln.startswith(b"ROWS ")]


def _env(**kw):
    return dict(os.environ, DDSTORE_CONNECT_TIMEOUT_S="3",
                DDSTORE_READ_TIMEOUT_S="5", JAX_PLATFORMS="cpu", **kw)


# case: (worker, world, victim, extra environment)
_CASES = {
    **{f"inrun[{v}-{r}]": (test_elastic._WORKER, 4, v,
                           dict(DDSTORE_REPLICATION=str(r),
                                DDSTORE_BARRIER_TIMEOUT_S="60"))
       for v, r in ((2, 1), (0, 1), (2, 2))},
    "spilled[1]": (test_elastic_tiering._WORKER, 3, 1,
                   dict(DDSTORE_BARRIER_TIMEOUT_S="15")),
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case's worlds, all started at once: {case: result}."""
    tmp = tmp_path_factory.mktemp("elastic")
    out = {}

    def run(name, worker, world, victims, env):
        out[name] = _both_worlds(tmp / name, worker, world, victims,
                                 _env(**env))

    ts = [threading.Thread(target=run, args=(name,) + case)
          for name, case in _CASES.items()]
    for t in ts:
        t.start()
    for t in ts:
        t.join(420)
    for name in _CASES:
        out.setdefault(name, AssertionError(f"{name}: a world hung"))
    return out


@pytest.mark.parametrize("victim,replication", [(2, 1), (0, 1), (2, 2)])
def test_elastic_inrun_recovery(worlds, victim, replication):
    world = 4
    out = _passed(worlds[f"inrun[{victim}-{replication}]"])
    for pkg in ("jax", "torch"):
        for r in range(world):
            log = out[pkg]["logs"][r]
            assert b"DONE %d" % r in log, (pkg, log)
            if r == victim:
                assert b"REJOINED" in log
            elif replication > 1:
                assert b"SURVIVED_THROUGH_DEATH" in log and \
                    b"RECOVERED" in log, (pkg, log)
            else:
                assert b"DETECTED" in log and b"RECOVERED" in log
    ref, port = out["jax"], out["torch"]
    assert port["generation"] == ref["generation"] == "1"
    assert port["gens"] == ref["gens"]
    digests = [_rows(log) for log in port["logs"]]
    assert digests == [_rows(log) for log in ref["logs"]]
    assert all(len(d) == 1 for d in digests)
    assert len(set(d[0] for d in digests)) == 1  # every rank, same rows


def test_file_backed_var_refuses_update_naming_tier(tmp_path):
    def case(P):
        data = np.arange(160, dtype=np.float64).reshape(20, 8)
        path = tmp_path / f"{P.name}.bin"
        data.tofile(path)
        with P.DDStore(backend="local") as s:
            s.add_file("v", str(path), np.float64, (8,), tier="cold")
            tiers = [s.var_tier("v")]
            with pytest.raises(P.DDStoreError, match="cold-tier") as e1:
                s.update("v", np.zeros((1, 8)))
            s.add("w", np.ones((4, 2), np.float32))
            spilled = s.spill_to_disk("w", str(tmp_path / P.name))
            tiers.append(s.var_tier("w"))
            with pytest.raises(P.DDStoreError, match="cold-tier") as e2:
                s.update("w", np.zeros((1, 2), np.float32))
            return (tiers, e1.value.code, e2.value.code,
                    os.path.basename(spilled), open(spilled, "rb").read(),
                    s.get_batch("w", np.arange(4)).tobytes())

    ref, port = case(PKGS["jax"]), case(PKGS["torch"])
    assert port == ref and port[0] == ["cold", "cold"]


def test_mmap_shards_serve_identical_over_tcp_and_cma(tmp_path,
                                                      monkeypatch):
    world, rows, dim = 2, 64, 16
    oracle = np.concatenate([
        np.random.default_rng(50 + r).standard_normal(
            (rows, dim)).astype(np.float64) for r in range(world)])

    def run(P, cma_on):
        monkeypatch.setenv("DDSTORE_CMA", "1" if cma_on else "0")

        def body(rank, group):
            p = tmp_path / f"{P.name}{cma_on}{rank}.bin"
            oracle[rank * rows:(rank + 1) * rows].tofile(p)
            with P.DDStore(group, backend="tcp") as s:
                s.add_file("v", str(p), np.float64, (dim,), tier="cold")
                s.barrier()
                out = None
                if rank == 0:
                    got = s.get_batch("v", np.arange(world * rows))
                    with pytest.raises(P.DDStoreError, match="cold-tier"):
                        s.update("v", np.zeros((1, dim)))
                    out = (got.copy(), s.cma_ops)
                s.barrier()
                return out

        return run_group(P, world, body)[0]

    for P in PKGS.values():
        tcp, cma = run(P, False), run(P, True)
        np.testing.assert_array_equal(tcp[0], oracle)
        np.testing.assert_array_equal(cma[0], oracle)
        assert tcp[1] == 0, P.name
        assert cma[1] > 0, f"{P.name}: CMA leg never engaged"


@pytest.mark.parametrize("victim", [1])
def test_elastic_recovery_of_spilled_variable(worlds, victim):
    world = 3
    out = _passed(worlds[f"spilled[{victim}]"])
    for pkg in ("jax", "torch"):
        for r in range(world):
            log = out[pkg]["logs"][r]
            assert b"DONE %d" % r in log, (pkg, log)
            if r == victim:
                assert b"REJOINED_MMAP" in log
            else:
                assert b"DETECTED" in log and b"RECOVERED" in log
                assert b"SPILL_BARRIER" in log
    ref, port = out["jax"], out["torch"]
    assert port["generation"] == ref["generation"] == "1"
    assert port["gens"] == ref["gens"]
    digests = [_rows(log) for log in port["logs"]]
    assert digests == [_rows(log) for log in ref["logs"]]
    assert len(set(d[0] for d in digests)) == 1


def test_example_batches_roll_over_epochs():
    """``examples/elastic_train.py`` draws 64 indices at a time from one
    epoch's iterator, so its default 40 steps over 2,048 rows a rank (32
    batches an epoch) raise at step 33; the port's example starts the
    sampler's next epoch instead, with the same first 32 batches."""
    from ddstore_tpu.data import DistributedSampler as RefSampler
    from ddstore_tpu_torch.data.dataset import DistributedSampler
    from ddstore_tpu_torch.examples.elastic_train import ROWS, WORLD, _batches

    ref = iter(RefSampler(ROWS * WORLD, WORLD, 1, seed=0))
    want = [np.fromiter(ref, np.int64, count=64) for _ in range(32)]
    with pytest.raises(ValueError, match="iterator too short"):
        np.fromiter(ref, np.int64, count=64)
    sampler = DistributedSampler(ROWS * WORLD, WORLD, 1, seed=0)
    got = _batches(sampler, 64)
    for w in want:
        np.testing.assert_array_equal(next(got), w)
    nxt = next(got)  # step 33: epoch 1's first batch
    other = RefSampler(ROWS * WORLD, WORLD, 1, seed=0)
    other.set_epoch(1)
    np.testing.assert_array_equal(nxt, np.fromiter(iter(other), np.int64,
                                                   count=64))
