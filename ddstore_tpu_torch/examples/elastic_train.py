"""Elastic training demo: a run that SURVIVES a killed rank (the port of
``examples/elastic_train.py``).

* 4 worker processes build a TCP store, checkpoint their shards
  (``save_shard``), and each trains its own VAE on its device from the
  store (no DDP: the point is the store fabric, and a
  ``torch.distributed`` group does not survive the death of a member).
* The supervisor (this module) SIGKILLs one worker mid-training.
* Survivors hit a bounded-timeout ``DDStoreError``, call
  ``elastic_recover`` and block at the recovery rendezvous.
* The supervisor relaunches the dead rank with ``--rejoin``; it calls
  ``elastic_rejoin``, restores its shard from the checkpoint, and the
  whole world resumes training — same data, no global restart.

Run (one machine, all local processes; every worker on the card unless
``--device cpu``)::

    python -m ddstore_tpu_torch.examples.elastic_train --steps 40 \\
        --kill-after 8

A worker's sampler starts its next epoch when one ends, so ``--steps``
may exceed an epoch (32 steps of 64 at the defaults). Worker internals:
``ddstore_tpu_torch/elastic.py``.
"""

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time

WORLD = 4
ROWS = 2048
# Seconds the workers may take after the relaunch before the supervisor
# kills them all.
_WAIT_S = 600


def _batches(sampler, size):
    """Index arrays of ``size`` from ``sampler``, epoch after epoch."""
    import numpy as np

    epoch = 0
    while True:
        sampler.set_epoch(epoch)
        idx = np.fromiter(iter(sampler), np.int64)
        for s in range(0, len(idx) - size + 1, size):
            yield idx[s:s + size]
        epoch += 1


def worker(args):
    import numpy as np
    import torch

    from ddstore_tpu_torch import (DDStore, DDStoreError, FileGroup,
                                   elastic_recover, elastic_rejoin)
    from ddstore_tpu_torch.data.dataset import DistributedSampler
    from ddstore_tpu_torch.models import vae
    from ddstore_tpu_torch.utils import save_shard

    rank = args.rank
    if args.device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(args.device)
    if args.rejoin:
        store = elastic_rejoin(args.elastic_dir, rank, WORLD,
                               args.ckpt_dir, timeout=120)
        print(f"[r{rank}] rejoined from checkpoint", flush=True)
    else:
        g = FileGroup(args.rdv_dir, rank, WORLD)
        store = DDStore(g, backend="tcp")
        gen = np.random.default_rng(rank)
        shard = gen.random((ROWS, vae.IMAGE_DIM), np.float32)
        store.add("x", shard)
        save_shard(store, "x", args.ckpt_dir)
        store.barrier()

    model = vae.VAE(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(rank))
    _, opt = vae.create_train_state(model)
    step = vae.make_train_step(model, opt)
    sampler = DistributedSampler(store.total_rows("x"), WORLD, rank,
                                 seed=0)
    key = torch.Generator(device=dev).manual_seed(100 + rank)
    batches = _batches(sampler, 64)
    t = 0
    print(f"[r{rank}] TRAINING", flush=True)
    while t < args.steps:
        idx = next(batches)
        try:
            batch = store.get_batch("x", idx)
        except DDStoreError as e:
            print(f"[r{rank}] peer death detected at step {t}: {e}; "
                  f"recovering...", flush=True)
            elastic_recover(store, args.elastic_dir, timeout=120)
            print(f"[r{rank}] recovered; resuming", flush=True)
            batch = store.get_batch("x", idx)
        loss = step(torch.from_numpy(batch).to(dev), generator=key)
        t += 1
        if t % 10 == 0:
            print(f"[r{rank}] step {t}: loss/sample="
                  f"{float(loss) / len(idx):.2f}", flush=True)
    store.barrier()
    store.close()
    print(f"[r{rank}] done", flush=True)


def supervise(args):
    base = args.workdir or tempfile.mkdtemp(prefix="elastic_demo_")
    os.makedirs(base, exist_ok=True)
    dirs = {"--rdv-dir": f"{base}/rdv", "--elastic-dir": f"{base}/elastic",
            "--ckpt-dir": f"{base}/ckpt"}
    common = [sys.executable, "-m", "ddstore_tpu_torch.examples."
              "elastic_train", "--steps", str(args.steps), "--device",
              args.device]
    for k, v in dirs.items():
        common += [k, v]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, DDSTORE_READ_TIMEOUT_S="5",
               DDSTORE_CONNECT_TIMEOUT_S="3",
               DDSTORE_BARRIER_TIMEOUT_S="60", DDSTORE_HOST="127.0.0.1",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))

    logs = {r: f"{base}/r{r}.log" for r in range(WORLD)}

    def launch(rank, rejoin=False):
        cmd = common + ["--rank", str(rank)] + (["--rejoin"] if rejoin
                                                else [])
        with open(logs[rank], "ab") as log:
            return subprocess.Popen(cmd, env=env, stdout=log,
                                    stderr=subprocess.STDOUT)

    procs = {r: launch(r) for r in range(WORLD)}

    def fail(msg):
        for p in procs.values():
            p.kill()
            p.wait()
        print(f"[supervisor] {msg}; logs in {base}", flush=True)
        return 1

    victim = args.victim
    # Kill only once the victim is demonstrably TRAINING (setup and the
    # collective adds behind it — a death mid-setup is a launch failure,
    # not the elastic scenario).
    deadline = time.time() + 300
    while True:
        with open(logs[victim], "rb") as f:
            if b"TRAINING" in f.read():
                break
        if time.time() > deadline or procs[victim].poll() is not None:
            return fail("victim never reached training")
        time.sleep(0.2)
    time.sleep(args.kill_after)
    print(f"[supervisor] SIGKILL rank {victim}", flush=True)
    procs[victim].send_signal(signal.SIGKILL)
    procs[victim].wait()
    time.sleep(1.0)
    print(f"[supervisor] relaunching rank {victim} (--rejoin)",
          flush=True)
    procs[victim] = launch(victim, rejoin=True)
    rc = 0
    deadline = time.time() + _WAIT_S
    for r, p in procs.items():
        try:
            rc |= p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            return fail(f"rank {r} still running after {_WAIT_S} s")
    for r in range(WORLD):
        with open(logs[r]) as f:
            for line in f.read().splitlines()[-4:]:
                print(f"  {line}")
    print(f"[supervisor] all workers exited; "
          f"status={'OK' if rc == 0 else 'FAIL'} (logs in {base})",
          flush=True)
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m ddstore_tpu_torch.examples.elastic_train",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--kill-after", type=float, default=8.0,
                    help="seconds before the supervisor kills the victim")
    ap.add_argument("--kill-at", type=float, dest="kill_after",
                    help=argparse.SUPPRESS)
    ap.add_argument("--victim", type=int, default=2)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    # worker-mode flags (internal)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--rejoin", action="store_true")
    ap.add_argument("--rdv-dir", dest="rdv_dir")
    ap.add_argument("--elastic-dir", dest="elastic_dir")
    ap.add_argument("--ckpt-dir", dest="ckpt_dir")
    args = ap.parse_args(argv)
    if args.rank is None:
        sys.exit(supervise(args))
    worker(args)


if __name__ == "__main__":
    main()
