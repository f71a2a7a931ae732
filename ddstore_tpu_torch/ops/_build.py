"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first
use with ``nvcc`` into ``ddstore_tpu_torch/_kbuild/lib<name>.so``, then
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
A library is rebuilt when its source, or any header (``*.cuh``) beside
it, is newer. A failed build raises: there is no fallback to a plain
version.

``nvcc`` is taken from ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``),
else from ``PATH``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "load"]

_HERE = Path(__file__).resolve().parent
#: kernel name -> CUDA source
SOURCES: Dict[str, Path] = {
    "flash_fwd": _HERE / "csrc" / "flash_fwd.cu",
    "flash_bwd": _HERE / "csrc" / "flash_bwd.cu",
    "held_rows": _HERE / "csrc" / "held_rows.cu",
}
BUILD_DIR = _HERE.parent / "_kbuild"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_mu = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: compiler output of the builds made by this process (ptxas register and
#: shared-memory report), by kernel name
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" \
        / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    header in the source's directory (every source may include them)."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    src = SOURCES[name]
    return any(p.stat().st_mtime > built
               for p in (src, *src.parent.glob("*.cuh")))


def build_all(names: Optional[List[str]] = None) -> float:
    """Compile every stale kernel, one ``nvcc`` process per source, all
    started together; returns the seconds taken. Raises on the first
    failed build, with the compiler's output."""
    names = list(SOURCES) if names is None else names
    t0 = time.perf_counter()
    with _mu:
        todo = [n for n in names if _stale(n)]
        if not todo:
            return 0.0
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, p) in procs.items():
            log, _ = p.communicate()
            build_logs[n] = log
            if p.returncode != 0:
                failed.append(f"{n} (exit {p.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _lib_path(n))
        if failed:
            raise RuntimeError("CUDA kernel build failed: "
                               + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if stale."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _mu:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]
