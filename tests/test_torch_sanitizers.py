"""Sanitizer builds of the port's copy of the native core: the stress
scenario of ``tests/test_sanitizers.py`` run against the port's
``DDStore``, with the same parameters, the same ``*SAN_OPTIONS``, the same
``LD_PRELOAD`` of the sanitizer's runtime and the same 600 s subprocess
timeout, in a subprocess whose ``DDSTORE_SANITIZE`` makes
``ddstore_tpu_torch._build`` build (and the binding load) the sanitized
library. Any sanitizer report fails the case.

The scenario is the reference's own text with the package's name
replaced: the port's top level exports the same names. ``thread`` is
marked ``slow``, as the reference marks it: TSan hangs under this
container's gVisor kernel. Like the reference's file, this one is not
``tier1_required``: a host without a sanitizer's runtime skips its case."""

import os
import subprocess
import sys

import pytest

from ddstore_tpu_torch import _build
from test_sanitizers import _STRESS, _sanitizer_lib

PORT_STRESS = _STRESS.replace("from ddstore_tpu import",
                              "from ddstore_tpu_torch import")


def test_stress_is_the_reference_scenario_on_the_port():
    assert "ddstore_tpu " not in PORT_STRESS.replace("\n", " ")
    assert PORT_STRESS.count("from ddstore_tpu_torch import") == \
        _STRESS.count("from ddstore_tpu import") >= 2
    assert PORT_STRESS.replace("ddstore_tpu_torch", "ddstore_tpu") == _STRESS


@pytest.mark.parametrize("mode", ["thread", "address", "undefined"])
def test_each_mode_has_its_own_library(mode, monkeypatch):
    monkeypatch.setenv("DDSTORE_SANITIZE", mode)
    lib = _build._lib_path(_build._sanitize_mode())
    assert lib != _build.LIB_PATH
    assert os.path.dirname(lib) == _build.BUILD_DIR
    assert os.path.basename(lib) == f"libddstore_torch_{mode}.so"
    assert _build._mode_flags(mode) == [f"-fsanitize={mode}", "-O1",
                                        "-fno-omit-frame-pointer", "-g"]


def test_unknown_mode_raises_the_reference_error(monkeypatch):
    monkeypatch.setenv("DDSTORE_SANITIZE", "memory")
    with pytest.raises(ValueError, match="DDSTORE_SANITIZE='memory': "
                                         "expected one of"):
        _build.build()
    monkeypatch.setenv("DDSTORE_SANITIZE", "")
    assert _build._lib_path(_build._sanitize_mode()) == _build.LIB_PATH


def test_killed_builds_staging_is_swept(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    old, new = tmp_path / "stageold", tmp_path / "stagenew"
    for d in (old, new):
        d.mkdir()
        (d / "unit.o").write_bytes(b"")
    os.utime(old, (1, 1))
    _build._sweep_strays()
    assert not old.exists() and new.exists()


@pytest.mark.parametrize("mode", [
    # TSan hangs under this container's gVisor kernel, as the reference's
    # case does (tests/test_sanitizers.py:528-534)
    pytest.param("thread", marks=pytest.mark.slow),
    "address",
    "undefined",
])
def test_native_stress_under_sanitizer(mode, tmp_path):
    lib = _sanitizer_lib(mode)
    if lib is None:
        pytest.skip(f"{mode} sanitizer runtime not installed")
    env = dict(os.environ)
    env["DDSTORE_SANITIZE"] = mode
    env["LD_PRELOAD"] = lib
    env["TSAN_OPTIONS"] = "exitcode=66 halt_on_error=1"
    env["ASAN_OPTIONS"] = ("detect_leaks=0 exitcode=66 "
                           "allocator_may_return_null=1")
    env["UBSAN_OPTIONS"] = ("exitcode=66 halt_on_error=1 "
                            "print_stacktrace=1")
    proc = subprocess.run([sys.executable, "-c", PORT_STRESS],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=os.path.dirname(
                              os.path.dirname(os.path.abspath(__file__))))
    report = proc.stdout + proc.stderr
    assert proc.returncode == 0, report[-4000:]
    assert "WARNING: ThreadSanitizer" not in report, report[-4000:]
    assert "ERROR: AddressSanitizer" not in report, report[-4000:]
    assert "runtime error:" not in report, report[-4000:]  # UBSan
    assert "stress ok" in report
    assert os.path.exists(_build._lib_path(mode))


def compare_thread(runs: int, out: str) -> None:
    """The stress scenario under TSan with ``halt_on_error=0`` (every
    report, not only the first) on the reference's store and then on the
    port's, ``runs`` times in turn: per run the exit code, the number of
    reports, whether the scenario's own checks passed, each distinct
    ``SUMMARY`` line and the frames at ``tcp_transport.cc:17xx`` (the
    ``Conn::fd`` peek of ``TcpTransport::ReadVOnRetry``); each run's whole
    output goes to ``out``."""
    lib = _sanitizer_lib("thread")
    if lib is None:
        raise SystemExit("no TSan runtime (libtsan.so) for this g++")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, DDSTORE_SANITIZE="thread", LD_PRELOAD=lib,
               TSAN_OPTIONS="exitcode=66 halt_on_error=0")
    for run in range(runs):
        for pkg, src in (("ddstore_tpu", _STRESS),
                         ("ddstore_tpu_torch", PORT_STRESS)):
            p = subprocess.run([sys.executable, "-c", src],
                               capture_output=True, text=True, env=env,
                               timeout=900)
            text = p.stdout + p.stderr
            with open(os.path.join(out, f"{pkg}_{run}.log"), "w") as f:
                f.write(text)
            lines = text.splitlines()
            print(f"{pkg} run {run}: exit {p.returncode}, reports "
                  f"{text.count('WARNING: ThreadSanitizer')}, stress ok "
                  f"{'stress ok' in text}", flush=True)
            for line in sorted({ln.split(" (")[0][:160] for ln in lines
                                if "SUMMARY: ThreadSanitizer" in ln}):
                print("   ", line)
            print("    frames at tcp_transport.cc:17xx:",
                  sorted({ln.strip()[:160] for ln in lines
                          if "tcp_transport.cc:17" in ln})[:6], flush=True)


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_sanitizers.py [RUNS] [OUT_DIR]
    # from the repo's root: both
    # packages' stores under TSan, side by side (the JAX package's store
    # imports without jax)
    import tempfile
    compare_thread(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                   sys.argv[2] if len(sys.argv) > 2
                   else tempfile.mkdtemp(prefix="tsan_compare"))
