"""Shared tiering/index-plane soak harness (BASELINE config-5 scale), the
port's copy of ``ddstore_tpu/utils/soak.py`` over the port's ``DDStore``.

A sparse mmap-backed shard at 10^8-row scale, sentinel rows pinning read
correctness at far offsets, a Feistel-sampled partial epoch of batched
gets, and RSS accounting that must track pages touched — never the row
count (the reference copies every shard into RAM at registration,
ddstore.hpp:43-49). The port's tests run it as the JAX package's tests
run theirs (``tests/test_torch_soak.py``)."""

from __future__ import annotations

import itertools
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np

__all__ = ["mmap_soak"]


def _vm_rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError("no VmRSS in /proc/self/status")


def _sentinel(r: int) -> np.ndarray:
    return np.asarray([r & 0x7FFFFFFF, (r * 31) & 0x7FFFFFFF], np.int32)


def mmap_soak(rows: int = 100_000_000, batch: int = 65536,
              nbatches: int = 64, directory: Optional[str] = None,
              budget_s: Optional[float] = None,
              fault_spec: Optional[str] = None,
              fault_seed: int = 7) -> dict:
    """Run the soak; returns a dict of measurements:

    * ``rows`` / ``rows_sampled`` — shard size and rows actually fetched
    * ``rows_per_s`` — batched-get throughput of the sampled epoch
    * ``batches_run`` — batches completed (< ``nbatches`` when
      ``budget_s`` cut the epoch short; throughput stays valid — it is
      rows-fetched over time-spent either way)
    * ``rss_add_delta_mb`` — RSS growth across ``add_mmap`` (must be
      ~0: registration must not copy the shard)
    * ``rss_delta_mb`` — RSS growth across the whole soak (bounded by
      pages touched, at most the file size — not by row count)
    * ``sentinels_ok`` — far-offset reads returned the stamped bytes

    ``budget_s`` bounds the SAMPLED-EPOCH wall time: on a slow box
    (cold page cache, throttled I/O) the fixed iteration count can
    outlive a caller's harness timeout, and a killed soak reports
    nothing; a budget-truncated one reports everything it measured.

    ``fault_spec`` switches the soak to its CHAOS mode: the shard is
    split across a 2-rank in-process group (a single-rank store never
    touches the transport, so there would be nothing to inject into),
    the deterministic injector is armed with the spec, and EVERY
    sampled batch is verified byte-identical against a direct mapping
    of the backing files. Adds ``faults_ok`` (all batches byte-exact),
    ``fault_injected`` / ``fault_retries`` / ``fault_giveups`` to the
    result — the "epoch completes byte-identical under transient
    faults" proof at tiering scale.

    A spec containing a ``corrupt:`` arm additionally runs the soak in
    its INTEGRITY mode: checksum verification is enabled on both ranks
    (runtime configure — no env plumbing) and the group runs at
    ``DDSTORE_REPLICATION=2`` so the verify ladder's replica rung can
    absorb ANY corruption rate (at R=1 a primary whose one retry is
    also corrupted correctly surfaces ``ERR_CORRUPT`` — honest, but
    the soak's job is to prove end-to-end REPAIR). Mirrors fill before
    the injector arms, so they hold clean bytes; note the R×RAM cost
    at large ``rows``. The byte-identity check then proves: 0
    give-ups, 0 silent mismatches. Adds ``corrupt_injected`` /
    ``corrupt_detected`` / ``corrupt_errors`` to the result.
    """
    if fault_spec is not None:
        return _mmap_soak_chaos(rows, batch, nbatches, directory,
                                budget_s, fault_spec, fault_seed)
    from .. import DDStore
    from ..data.dataset import DistributedSampler

    d = directory or tempfile.mkdtemp()
    path = os.path.join(d, "edges.bin")
    try:
        with open(path, "wb") as f:
            f.truncate(rows * 8)  # sparse: 2 x int32 rows, read as zeros
            stamps = list(range(0, rows, max(1, rows // 63)))[:63] \
                + [rows - 1]
            for r in stamps:
                f.seek(r * 8)
                f.write(_sentinel(r).tobytes())
        with DDStore(backend="local") as s:
            rss0 = _vm_rss_mb()
            s.add_mmap("edges", path, np.int32, (2,))
            rss_add = _vm_rss_mb() - rss0
            assert s.total_rows("edges") == rows
            got = s.get_batch("edges", stamps)
            ok = bool((got == np.stack([_sentinel(r)
                                        for r in stamps])).all())
            sampler = DistributedSampler(rows, world=1, rank=0, seed=7,
                                         mode="streamed")
            t0 = time.perf_counter()
            n = nb = 0
            for b in itertools.islice(sampler.batches(batch), nbatches):
                out = s.get_batch("edges", b)
                assert out.shape == (len(b), 2)
                n += len(b)
                nb += 1
                if budget_s is not None \
                        and time.perf_counter() - t0 > budget_s:
                    break
            dt = time.perf_counter() - t0
            return {"rows": rows, "rows_sampled": n,
                    "rows_per_s": n / dt,
                    "batches_run": nb,
                    "rss_add_delta_mb": rss_add,
                    "rss_delta_mb": _vm_rss_mb() - rss0,
                    "sentinels_ok": ok}
    finally:
        if directory is None:
            shutil.rmtree(d, ignore_errors=True)
        else:
            try:
                os.unlink(path)
            except OSError:
                pass


def _mmap_soak_chaos(rows: int, batch: int, nbatches: int,
                     directory: Optional[str], budget_s: Optional[float],
                     fault_spec: str, fault_seed: int) -> dict:
    """Chaos variant of the soak (see ``mmap_soak(fault_spec=...)``):
    2-rank ThreadGroup over two sparse mmap shards, deterministic fault
    injection on the transport path (absorbed by the store's transient-
    retry layer), every batch verified byte-identical against the
    backing files themselves."""
    import threading
    import uuid

    from .. import DDStore, ThreadGroup
    from ..binding import fault_configure
    from ..data.dataset import DistributedSampler

    half = rows // 2
    counts = (half, rows - half)
    d = directory or tempfile.mkdtemp()
    paths = [os.path.join(d, f"edges{r}.bin") for r in range(2)]
    name = uuid.uuid4().hex
    stamps = list(range(0, rows, max(1, rows // 63)))[:63] + [rows - 1]
    # A corrupt: arm needs the verify machinery on BOTH ranks (the
    # owner serves its sum table, the reader verifies) — otherwise the
    # flipped bytes would flow silently into the delivered batches and
    # the byte-identity check would fail by design.
    corrupt_mode = "corrupt" in fault_spec
    repl_backup = os.environ.get("DDSTORE_REPLICATION")
    if corrupt_mode:
        os.environ["DDSTORE_REPLICATION"] = "2"
    result: dict = {}
    errors: list = []
    done = threading.Event()

    def serve_rank1():
        try:
            g = ThreadGroup(name, 1, 2)
            with DDStore(g, backend="local") as s1:
                if corrupt_mode:
                    s1.integrity_configure(verify=1)
                s1.add_mmap("edges", paths[1], np.int32, (2,))
                # Serve until rank 0 finishes; the with-exit close()
                # pairs with rank 0's (barriers are matched by tag, so
                # no extra collectives may run on one side only).
                done.wait(600)
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))
            done.set()

    try:
        for r, (p, n) in enumerate(zip(paths, counts)):
            lo = 0 if r == 0 else half
            with open(p, "wb") as f:
                f.truncate(n * 8)
                for g in stamps:
                    if lo <= g < lo + n:
                        f.seek((g - lo) * 8)
                        f.write(_sentinel(g).tobytes())
        t1 = threading.Thread(target=serve_rank1, daemon=True)
        t1.start()
        g0 = ThreadGroup(name, 0, 2)
        with DDStore(g0, backend="local") as s:
            if corrupt_mode:
                s.integrity_configure(verify=1)
            rss0 = _vm_rss_mb()
            s.add_mmap("edges", paths[0], np.int32, (2,))
            assert s.total_rows("edges") == rows
            # Direct read-only views of BOTH backing files: the ground
            # truth every fetched batch is compared against.
            vm = [np.memmap(p, dtype=np.int32, mode="r",
                            shape=(n, 2)) for p, n in zip(paths, counts)]

            def expected(idx):
                out = np.empty((len(idx), 2), np.int32)
                m0 = idx < half
                out[m0] = vm[0][idx[m0]]
                out[~m0] = vm[1][idx[~m0] - half]
                return out

            fault_configure(fault_spec, fault_seed)
            try:
                fs0 = s.fault_stats()
                is0 = s.integrity_stats() if corrupt_mode else {}
                got = s.get_batch("edges", stamps)
                ok = bool((got == np.stack([_sentinel(r)
                                            for r in stamps])).all())
                sampler = DistributedSampler(rows, world=1, rank=0,
                                             seed=7, mode="streamed")
                faults_ok = True
                t0 = time.perf_counter()
                n = nb = 0
                for b in itertools.islice(sampler.batches(batch),
                                          nbatches):
                    out = s.get_batch("edges", b)
                    faults_ok = faults_ok and bool(
                        (out == expected(np.asarray(b))).all())
                    n += len(b)
                    nb += 1
                    if budget_s is not None \
                            and time.perf_counter() - t0 > budget_s:
                        break
                dt = time.perf_counter() - t0
                fs = s.fault_stats()
                is1 = s.integrity_stats() if corrupt_mode else {}
            finally:
                fault_configure("", 0)
            done.set()
            result = {
                "rows": rows, "rows_sampled": n,
                "rows_per_s": n / dt,
                "batches_run": nb,
                "rss_delta_mb": _vm_rss_mb() - rss0,
                "sentinels_ok": ok,
                "faults_ok": faults_ok,
                "fault_injected": (fs["injected_reset"]
                                   + fs["injected_trunc"]
                                   + fs["injected_delay"]
                                   + fs["injected_stall"]
                                   - (fs0["injected_reset"]
                                      + fs0["injected_trunc"]
                                      + fs0["injected_delay"]
                                      + fs0["injected_stall"])),
                "fault_retries": (fs["retry_attempts"]
                                  - fs0["retry_attempts"]),
                "fault_giveups": fs["retry_giveups"] - fs0["retry_giveups"],
            }
            if corrupt_mode:
                result["corrupt_injected"] = (
                    fs.get("injected_corrupt", 0)
                    - fs0.get("injected_corrupt", 0))
                result["corrupt_detected"] = (
                    is1.get("verify_mismatches", 0)
                    - is0.get("verify_mismatches", 0))
                result["corrupt_errors"] = (
                    is1.get("corrupt_errors", 0)
                    - is0.get("corrupt_errors", 0))
        t1.join(60)
        if errors:
            raise RuntimeError(f"chaos soak rank 1 failed: {errors}")
        return result
    finally:
        done.set()
        if corrupt_mode:
            if repl_backup is None:
                os.environ.pop("DDSTORE_REPLICATION", None)
            else:
                os.environ["DDSTORE_REPLICATION"] = repl_backup
        if directory is None:
            shutil.rmtree(d, ignore_errors=True)
        else:
            for p in paths:
                try:
                    os.unlink(p)
                except OSError:
                    pass
