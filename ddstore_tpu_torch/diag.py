"""Host capability report: ``python -m ddstore_tpu_torch.diag``.

One screenful that answers "which data planes can THIS host actually
run?" before any store exists — the io_uring probe (the uring wire
backend and O_DIRECT cold serving hang off it), the CMA fast path's
kernel preconditions, the core budget every tuner scales by, and a
page-cache-vs-O_DIRECT verdict for the cold-tier directory, over the
port's binding. ``chip_smoke.py`` prints the same dict for the card's
host, so a TCP-fallback or mmap-only run is diagnosable from its output.

Report keys (``capability_report()``):
  uring          — :func:`ddstore_tpu_torch.binding.uring_probe` verbatim
                   (supported, IORING_FEAT_* mask, per-opcode flags,
                   reason)
  cma            — {available, reason}: Yama ptrace_scope verdict plus
                   a live process_vm_readv self-read (the actual
                   syscall, not just the sysctl)
  cores          — os.cpu_count() (lane pools, async width and the
                   uring burst budget all scale by it)
  cold_direct    — {dir, o_direct, gate, verdict}: can the cold-tier
                   directory serve O_DIRECT, and does the
                   DDSTORE_URING_COLD gate currently want it?
"""

from __future__ import annotations

import ctypes
import errno
import json
import os
import tempfile


def _probe_cma() -> dict:
    """CMA feasibility: Yama scope plus a real process_vm_readv
    self-read (gVisor-class kernels return ENOSYS regardless of the
    sysctl; a container may also drop the capability)."""
    reason = []
    scope = None
    try:
        with open("/proc/sys/kernel/yama/ptrace_scope") as f:
            scope = int(f.read().strip())
        if scope >= 2:
            reason.append(f"yama ptrace_scope={scope} blocks "
                          "cross-process reads")
        elif scope == 1:
            reason.append("yama ptrace_scope=1 (peers must "
                          "PR_SET_PTRACER or share a parent)")
    except OSError:
        pass  # no Yama — nothing to report
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        src = (ctypes.c_char * 16)(*b"ddstore-cma-prob")
        dst = (ctypes.c_char * 16)()

        class _IoVec(ctypes.Structure):
            _fields_ = [("iov_base", ctypes.c_void_p),
                        ("iov_len", ctypes.c_size_t)]

        liov = _IoVec(ctypes.cast(dst, ctypes.c_void_p), 16)
        riov = _IoVec(ctypes.cast(src, ctypes.c_void_p), 16)
        n = libc.process_vm_readv(os.getpid(), ctypes.byref(liov), 1,
                                  ctypes.byref(riov), 1, 0)
        if n != 16 or dst.raw != src.raw:
            err = ctypes.get_errno()
            reason.append("process_vm_readv: "
                          f"{os.strerror(err) if err else 'short read'}")
            return {"available": False, "reason": "; ".join(reason)}
    except Exception as e:  # noqa: BLE001 — report, never crash diag
        reason.append(f"process_vm_readv probe failed: {e}")
        return {"available": False, "reason": "; ".join(reason)}
    if os.environ.get("DDSTORE_CMA", "").strip() == "0":
        reason.append("DDSTORE_CMA=0 disables it")
        return {"available": False, "reason": "; ".join(reason)}
    # scope 1 still works between a store's pooled peers (PR_SET_PTRACER
    # handshake) — available, with the caveat in reason.
    return {"available": scope is None or scope < 2,
            "reason": "; ".join(reason) or "ok"}


def _probe_cold_direct(uring_supported: bool) -> dict:
    """Can the cold-tier directory serve O_DIRECT, and does the
    DDSTORE_URING_COLD gate want it? The verdict names the regime the
    tiered store will actually run in."""
    d = os.environ.get("DDSTORE_TIER_COLD_DIR", "").strip() or \
        tempfile.gettempdir()
    gate = os.environ.get("DDSTORE_URING_COLD", "auto").strip().lower() \
        or "auto"
    o_direct = False
    detail = ""
    try:
        fd, path = tempfile.mkstemp(dir=d)
        try:
            os.write(fd, b"\0" * 4096)
            os.close(fd)
            dfd = os.open(path, os.O_RDONLY | os.O_DIRECT)
            os.close(dfd)
            o_direct = True
        finally:
            os.unlink(path)
    except OSError as e:
        detail = f"O_DIRECT open in {d}: " \
                 f"{errno.errorcode.get(e.errno, e.errno)}"
    if not uring_supported:
        verdict = "page-cache mmap (no io_uring)"
    elif not o_direct:
        verdict = f"page-cache mmap ({detail})"
    elif gate in ("0", "off", "false"):
        verdict = "page-cache mmap (DDSTORE_URING_COLD=0)"
    elif gate in ("1", "on", "true"):
        verdict = "O_DIRECT via submission ring (forced on)"
    else:
        verdict = "O_DIRECT via submission ring when " \
                  "DDSTORE_TRANSPORT=uring engages (gate=auto)"
    return {"dir": d, "o_direct": o_direct, "gate": gate,
            "verdict": verdict}


def capability_report() -> dict:
    """The full report as one JSON-ready dict (see module docstring)."""
    from .binding import uring_probe

    uring = uring_probe()
    return {
        "uring": uring,
        "cma": _probe_cma(),
        "cores": os.cpu_count() or 1,
        "cold_direct": _probe_cold_direct(bool(uring["supported"])),
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m ddstore_tpu_torch.diag",
        description="Report this host's data-plane capabilities "
                    "(io_uring, CMA, cores, cold-tier O_DIRECT).")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (the dict of "
                         "capability_report())")
    args = ap.parse_args(argv)
    rep = capability_report()
    if args.json:
        print(json.dumps(rep, indent=2, sort_keys=True))
        return 0
    u = rep["uring"]
    ops = [k[3:] for k in ("op_send", "op_recv", "op_sendmsg",
                           "op_recvmsg", "op_read", "op_read_fixed")
           if u.get(k)]
    print(f"io_uring:    {'yes' if u['supported'] else 'NO'} "
          f"({u['reason']})")
    if u["supported"]:
        print(f"  features:  0x{u['features']:x}"
              f"{' +ext_arg' if u['ext_arg'] else ''}")
        print(f"  opcodes:   {' '.join(ops)}")
    c = rep["cma"]
    print(f"cma:         {'yes' if c['available'] else 'NO'} "
          f"({c['reason']})")
    print(f"cores:       {rep['cores']}")
    cd = rep["cold_direct"]
    print(f"cold tier:   {cd['verdict']}")
    print(f"  dir:       {cd['dir']} "
          f"(O_DIRECT {'ok' if cd['o_direct'] else 'refused'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
