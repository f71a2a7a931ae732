"""Run one cell of the benchmark once and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the port (``ddstore_tpu_torch``).
The cell's files (``workloads/``, ``configs/``, ``traffic/``) say what to
run; its traffic names the job (``jobs/``) that sets the program
up, measures the window and judges what it produced. The metric readers
(``metrics/``) turn the run's record into the result's metrics: with
``--trace 0`` the end-to-end ones, with ``--trace 1`` the per-layer ones
from a profiler trace of a few of the window's steps.

A cell on more than one chip runs one process a card: this one is rank
0, and starts the others with the store's file rendezvous under
``TMPDIR``. The last line of standard output is the result, a JSON
object whose last key, ``checks``, holds each number compared beside its
limit; the same numbers end standard error. No result is printed, and
the exit code is not 0, when the cell asks for more cards than there
are, when anything fails, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ddstore_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the tests' tiny cells, with the port's "
                         "plain paths; never a measurement")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def forbidden_modules() -> List[str]:
    """JAX or the JAX package among the loaded modules, by whole
    top-level name (``ddstore_tpu_torch`` is not ``ddstore_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return "; ".join(out)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


class Ranks:
    """Ranks 1.. of a cell on several cards, started by rank 0 with the
    store's file rendezvous in a fresh directory under ``TMPDIR``; a rank
    that fails ends the run."""

    def __init__(self, argv: List[str], world: int):
        rdv = self.rdv = tempfile.mkdtemp(prefix="bench-rdv-", dir=(
            os.environ.get("TMPDIR") or tempfile.gettempdir()))
        self.procs = []
        base = dict(os.environ, DDSTORE_WORLD=str(world),
                    DDSTORE_RDV_DIR=rdv)
        os.environ.update(base, DDSTORE_RANK="0")
        for r in range(1, world):
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.run", *argv,
                 "--rank", str(r)],
                env=dict(base, DDSTORE_RANK=str(r)), stdout=sys.stderr,
                stderr=sys.stderr))
        self._done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while not self._done.wait(0.5):
            for p in self.procs:
                if p.poll() not in (None, 0):
                    log(f"rank process {p.args[-1]} exited with "
                        f"{p.returncode}; ending the run")
                    self.stop()
                    os._exit(1)

    def join(self, timeout: float = 120.0) -> None:
        self._done.set()
        for p in self.procs:
            if p.wait(timeout) != 0:
                raise RuntimeError(f"rank {p.args[-1]} exited with "
                                   f"{p.returncode}")
        shutil.rmtree(self.rdv, ignore_errors=True)

    def stop(self) -> None:
        self._done.set()
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(self.rdv, ignore_errors=True)


def _watch_parent() -> None:
    """A rank process ends itself when rank 0 is gone."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def gather(ctx, rec: Dict) -> List[Dict]:
    """Every rank's record, on rank 0 (``[rec]`` on one rank)."""
    if ctx.world == 1:
        return [rec]
    import torch.distributed as dist
    out = [None] * ctx.world if ctx.rank == 0 else None
    dist.gather_object(rec, out, dst=0, group=ctx.gloo)
    return out


def checks(cell: Dict, records: List[Dict]) -> Dict[str, Dict]:
    """Each number compared, beside its limit (the workload's)."""
    limits = cell["workload"]["limits"]
    judged = dict(records[0]["judge"])
    judged["batch_mismatch"] = sum(r["batch_mismatch"] for r in records)
    return {k: {"value": judged[k], "limit": lim}
            for k, lim in limits.items()}


def result(reg, cell: Dict, args, records: List[Dict]) -> Dict:
    from benchmark.readers import Run
    from benchmark.trace import top_ops

    run = Run(cell, records, args.device)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for name, reader in reg.metrics(kind).items():
        v = reader.read(run)
        if v is not None:
            metrics[name] = {"value": v, "unit": reader.UNIT}
    cks = checks(cell, records)
    failed = sum(r["failed"] for r in records)
    ok = failed == 0 and all(c["value"] <= c["limit"] for c in cks.values())
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": run.device_kind, "count": cell["workload"]["chips"],
              "memory_peak_bytes": max(r["peak_bytes"] for r in records)}
    out = {"correct": bool(ok),
           "attempted": sum(r["attempted"] for r in records),
           "failed": failed, "metrics": metrics, "device": device}
    if args.trace:
        traces = [r["trace"] for r in records]
        device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        out["breakdown"] = {"device_ops": top_ops(traces[0]["by_name"]),
                            "idle_gaps": traces[0]["idle_gaps"]}
    out["checks"] = cks
    return out


def describe(records: List[Dict]) -> None:
    r = records[0]
    per = {k: v / max(1, r["steps"]) for k, v in r["launches"].items()}
    log(f"window: {r['steps']} steps in {r['window_s']:.3f} s on each of "
        f"{len(records)} rank(s); set-up {r['setup_s']:.3f} s; flash "
        f"launches a step {per}; reference {r['reference_s']:.3f} s")
    log(f"judge: {json.dumps(r['judge'])}")


def main(argv: Optional[List[str]] = None, root: Optional[str] = None
         ) -> int:
    """Run the cell; ``root`` is the folder the cell's files are found in
    (the benchmark's own by default)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    from benchmark.registry import ROOT, Registry

    reg = Registry(root or ROOT)
    cell = reg.cell(args.workload)
    chips = int(cell["workload"]["chips"])
    world = int(cell["traffic"].get("ranks", 1))
    os.environ.update(cell["workload"].get("env", {}))
    ranks = None
    rank = args.rank
    if rank is not None:
        _watch_parent()
    elif world > 1:
        # the other ranks import torch while this one does
        ranks = Ranks(argv, world)
        rank = 0
    else:
        rank = 0
    import torch

    log(f"imports done at {time.perf_counter() - _T_START:.3f} s")
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < chips):
        log(f"cell {args.workload} needs {chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        if ranks is not None:
            ranks.stop()
        return 2
    from benchmark.harness import Context

    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=args.device, rank=rank,
                  world=world, t_start=_T_START, log=log)
    try:
        rec = reg.job(cell["traffic"]["job"]).run(ctx)
        # each rank looks at its own modules once its window has closed
        rec["forbidden"] = forbidden_modules()
        records = gather(ctx, rec)
        if world > 1:
            import torch.distributed as dist
            dist.destroy_process_group()
        if rank != 0:
            return 0
        if ranks is not None:
            ranks.join()
    except BaseException:
        if ranks is not None:
            ranks.stop()
        raise
    if args.device == "cuda":
        log(f"card: {card_line()}")
    describe(records)
    out = result(reg, cell, args, records)
    bad = {r: rec["forbidden"] for r, rec in enumerate(records)
           if rec["forbidden"]}
    if forbidden_modules():
        bad[0] = sorted(set(bad.get(0, [])) | set(forbidden_modules()))
    if bad:
        log(f"the run loaded {bad} (by rank): the benchmark runs without "
            f"JAX and without the JAX package")
        return 3
    for k, c in out["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
