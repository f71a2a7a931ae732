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
``os.replace``. A failed build raises; there is no fallback. Staging
directories that a killed build left behind are swept at every build.

Sanitizer builds: ``DDSTORE_SANITIZE=thread|address|undefined`` (the
registered knob, read as the reference reads it) builds a separately
cached library beside the plain one, ``libddstore_torch_<mode>.so``, every
unit compiled and the library linked with ``-fsanitize=<mode> -O1
-fno-omit-frame-pointer -g``. A sanitized library cannot be loaded into a
stock python; run it in a process with the sanitizer's runtime in
``LD_PRELOAD`` (``tests/test_torch_sanitizers.py``).

The native demo: :func:`build_demo` links ``native/demo.cc`` (the store
core driven from C++ alone: thread ranks on the local transport, then
TCP on localhost) with the same units but ``capi.cc`` into the
executable ``_kbuild/native/dds_demo``, stale-aware and under the same
lock. ``dds_demo [world]`` exits 0 when every rank read its peers' rows.

    python -m ddstore_tpu_torch._build [--force] [--demo]
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
DEMO_PATH = os.path.join(BUILD_DIR, "dds_demo")
DEMO_SOURCE = "demo.cc"
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

_SANITIZERS = {"thread": "-fsanitize=thread",
               "address": "-fsanitize=address",
               "undefined": "-fsanitize=undefined"}


def _sanitize_mode() -> str:
    mode = os.environ.get("DDSTORE_SANITIZE", "").strip().lower()
    if mode and mode not in _SANITIZERS:
        raise ValueError(
            f"DDSTORE_SANITIZE={mode!r}: expected one of {set(_SANITIZERS)}")
    return mode


def _lib_path(mode: str) -> str:
    """The library of sanitizer ``mode`` ("" for the plain one), named
    after ``LIB_PATH``."""
    if not mode:
        return LIB_PATH
    root, ext = os.path.splitext(LIB_PATH)
    return f"{root}_{mode}{ext}"


def _mode_flags(mode: str) -> list:
    # -O1 and frame pointers give usable sanitizer reports
    return [_SANITIZERS[mode], "-O1", "-fno-omit-frame-pointer", "-g"] \
        if mode else []


def _stale(lib: str = None, extra=()) -> bool:
    lib = LIB_PATH if lib is None else lib
    if not os.path.exists(lib):
        return True
    lib_mtime = os.path.getmtime(lib)
    return any(os.path.getmtime(os.path.join(NATIVE_DIR, f)) > lib_mtime
               for f in SOURCES + HEADERS + list(extra))


def _sweep_strays(max_age_s: float = 600.0) -> None:
    """Remove the staging directories (``stage*``) of builds killed before
    their cleanup. A live build's directory is at most minutes old, so one
    older than ``max_age_s`` is dead."""
    import glob
    import time

    for stray in glob.glob(os.path.join(BUILD_DIR, "stage*")):
        try:
            if time.time() - os.path.getmtime(stray) > max_age_s:
                shutil.rmtree(stray)
        except OSError:
            pass


def _compile(src: str, obj: str, mode: str = "") -> None:
    vis = "-fvisibility=default" if src == "capi.cc" \
        else "-fvisibility=hidden"
    res = subprocess.run(
        _CXX + _mode_flags(mode)
        + [vis, "-c", os.path.join(NATIVE_DIR, src), "-o", obj],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"native build failed ({src}):\n{res.stderr}")


def _compile_all(stage: str, sources, mode: str = "") -> list:
    """Compile ``sources`` into ``stage``, one ``g++ -c`` each, all at
    once; returns the objects."""
    objs = [os.path.join(stage, s[:-3] + ".o") for s in sources]
    with ThreadPoolExecutor(max_workers=max(1, os.cpu_count() or 1)) as ex:
        for fut in [ex.submit(_compile, s, o, mode)
                    for s, o in zip(sources, objs)]:
            fut.result()
    return objs


def _build_into(stage: str, mode: str = "") -> str:
    objs = _compile_all(stage, SOURCES, mode)
    script = os.path.join(stage, "exports.map")
    with open(script, "w") as f:
        f.write(_VERSION_SCRIPT)
    lib = os.path.join(stage, "lib.so")
    res = subprocess.run(
        ["g++", "-shared", "-pthread", *_mode_flags(mode)[:1],
         "-Wl,-Bsymbolic", f"-Wl,--version-script={script}", *objs,
         "-o", lib],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"native link failed:\n{res.stderr}")
    return lib


def _built(target: str, make, force: bool, extra=()) -> str:
    """``target``, made by ``make(stage) -> path`` in a staging directory
    and moved into place when it is missing, older than a source, or
    ``force`` is set; one build at a time across processes."""
    with _lock:
        if os.path.isdir(BUILD_DIR):
            _sweep_strays()
        if not force and not _stale(target, extra):
            return target
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # another process may build
            if not force and not _stale(target, extra):
                return target
            stage = tempfile.mkdtemp(prefix="stage", dir=BUILD_DIR)
            try:
                os.replace(make(stage), target)
            finally:
                shutil.rmtree(stage, ignore_errors=True)
        return target


def build(force: bool = False) -> str:
    """Return the path of the built library of the ``DDSTORE_SANITIZE``
    mode (the plain one without it), compiling it first when it is
    missing, older than a source, or ``force`` is set."""
    mode = _sanitize_mode()
    return _built(_lib_path(mode), lambda st: _build_into(st, mode), force)


def _demo_into(stage: str) -> str:
    units = [s for s in SOURCES if s != "capi.cc"] + [DEMO_SOURCE]
    objs = _compile_all(stage, units)
    exe = os.path.join(stage, "dds_demo")
    res = subprocess.run(["g++", "-pthread", *objs, "-o", exe],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"dds_demo link failed:\n{res.stderr}")
    return exe


def build_demo(force: bool = False) -> str:
    """Return the path of ``dds_demo``, the native demo linked with the
    port's core (the reference's CMake target of that name), building it
    first when it is missing, older than a source, or ``force`` is
    set."""
    return _built(DEMO_PATH, _demo_into, force, extra=[DEMO_SOURCE])


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m ddstore_tpu_torch._build",
        description="Build the port's native store core (stale-aware).")
    ap.add_argument("--force", action="store_true",
                    help="rebuild even when the library is fresh")
    ap.add_argument("--demo", action="store_true",
                    help="build the native demo dds_demo instead")
    args = ap.parse_args(argv)
    print((build_demo if args.demo else build)(force=args.force))


if __name__ == "__main__":
    main()
