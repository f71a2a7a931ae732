"""Build the port's copy of the native store core (``native/``) into a
shared library at first use.

The counterpart of ``ddstore_tpu/_build.py``: ``g++ -O2 -std=c++17 -fPIC
-shared -pthread`` over the same 14 translation units, into
``_kbuild/native/libddstore_torch.so``, rebuilt whenever a source or
header is newer than the library. Each translation unit compiles in its
own ``g++ -c`` process, all started together, then one link.

Only the C API (``dds_*``) leaves the library: every other symbol is
hidden (``-fvisibility=hidden``, a linker version script) and no symbol
is ``STB_GNU_UNIQUE`` (``-fno-gnu-unique``), so this library and the JAX
package's ``libddstore_tpu.so`` can be loaded into one process without
the dynamic linker merging their state. ``capi.cc`` alone compiles with
default visibility: it defines the C API and nothing else.

The build is race-safe: one process builds at a time (a lock file), into
a staging directory, and the finished library is moved into place with
``os.replace``. A failed build raises; there is no fallback.

    python -m ddstore_tpu_torch._build [--force]
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(_PKG_DIR, "native")
BUILD_DIR = os.path.join(_PKG_DIR, "_kbuild", "native")
LIB_PATH = os.path.join(BUILD_DIR, "libddstore_torch.so")
SOURCES = ["store.cc", "local_transport.cc", "tcp_transport.cc",
           "uring_transport.cc", "worker_pool.cc", "cma.cc", "fault.cc",
           "gateway.cc", "health.cc", "integrity.cc", "metrics_hist.cc",
           "tier.cc", "trace.cc", "capi.cc"]
HEADERS = ["store.h", "local_transport.h", "tcp_transport.h",
           "uring_transport.h", "wire.h", "worker_pool.h", "cma.h",
           "fault.h", "gateway.h", "health.h", "integrity.h",
           "measure.h", "metrics_hist.h", "tier.h", "trace.h",
           "thread_annotations.h"]
_CXX = ["g++", "-O2", "-std=c++17", "-fPIC", "-pthread", "-Wall",
        "-fvisibility-inlines-hidden", "-fno-gnu-unique"]
_VERSION_SCRIPT = "{ global: dds_*; local: *; };\n"
_lock = threading.Lock()


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(os.path.join(NATIVE_DIR, f)) > lib_mtime
               for f in SOURCES + HEADERS)


def _compile(src: str, obj: str) -> None:
    vis = "-fvisibility=default" if src == "capi.cc" \
        else "-fvisibility=hidden"
    res = subprocess.run(
        _CXX + [vis, "-c", os.path.join(NATIVE_DIR, src), "-o", obj],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"native build failed ({src}):\n{res.stderr}")


def _build_into(stage: str) -> str:
    objs = [os.path.join(stage, s[:-3] + ".o") for s in SOURCES]
    with ThreadPoolExecutor(max_workers=max(1, os.cpu_count() or 1)) as ex:
        for fut in [ex.submit(_compile, s, o)
                    for s, o in zip(SOURCES, objs)]:
            fut.result()
    script = os.path.join(stage, "exports.map")
    with open(script, "w") as f:
        f.write(_VERSION_SCRIPT)
    lib = os.path.join(stage, "lib.so")
    res = subprocess.run(
        ["g++", "-shared", "-pthread", "-Wl,-Bsymbolic",
         f"-Wl,--version-script={script}", *objs, "-o", lib],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"native link failed:\n{res.stderr}")
    return lib


def build(force: bool = False) -> str:
    """Return the path of the built library, compiling it first when it
    is missing, older than a source, or ``force`` is set."""
    with _lock:
        if not force and not _stale():
            return LIB_PATH
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # another process may build
            if not force and not _stale():
                return LIB_PATH
            stage = tempfile.mkdtemp(prefix="stage", dir=BUILD_DIR)
            try:
                os.replace(_build_into(stage), LIB_PATH)
            finally:
                shutil.rmtree(stage, ignore_errors=True)
        return LIB_PATH


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m ddstore_tpu_torch._build",
        description="Build the port's native store core (stale-aware).")
    ap.add_argument("--force", action="store_true",
                    help="rebuild even when the library is fresh")
    args = ap.parse_args(argv)
    print(build(force=args.force))


if __name__ == "__main__":
    main()
