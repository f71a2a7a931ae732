"""ddlint — the repo-native concurrency & contract analyzer, the port's
copy of ``ddstore_tpu/analysis/`` pointed at the port's tree.

A deterministic, dependency-free static pass over the native layer and
the Python contract surfaces, run as a tier-1 test
(``tests/test_torch_static_analysis.py``) and as
``python -m ddstore_tpu_torch.analysis``. Why static: TSan hangs under this
container's gVisor kernel and ASan only sees
interleavings that actually ran — while the invariants this tree's
safety rests on ("never hold a data-lane mutex during Ping", "no
getenv under async_mu_", "health thread declared last = joined first",
capi exports == binding decls, every DDSTORE_* knob in REGISTRY) are
all checkable from the source alone, on every run, in seconds.

Ground truth is the ``DDS_*`` annotations in
``native/thread_annotations.h``; findings diff against the checked-in
``analysis/baseline.json`` (pre-existing violations pinned with a
reason) and anything NEW fails the pass. See README "Static analysis"
for how to read and extend the baseline.

Every entry point takes ``package``: the package of the tree whose native
core, binding, knob registry, Python roots and baseline are analyzed
(``ddstore_tpu_torch/native/``, ``binding.py``, ``sched/knobs.py``,
``analysis/baseline.json``). It defaults to the port; ``"ddstore_tpu"``
runs the same pass over the JAX package's copy, which reads its files as
text and imports nothing of it.
"""

from __future__ import annotations

import os
from typing import List, Tuple

from . import contracts, lockcheck
from .cppmodel import Model, parse_file
from .findings import Finding, baseline_entry, diff_baseline, load_baseline

__all__ = ["Finding", "run_all", "run_lockcheck", "run_contracts",
           "analyze_cpp", "load_baseline", "diff_baseline",
           "baseline_entry", "repo_root", "baseline_path",
           "NATIVE_SOURCES", "PACKAGE"]

#: The package analyzed by default: the port.
PACKAGE = "ddstore_tpu_torch"

#: Native translation units/headers the lock checker scans (demo.cc is
#: a standalone binary, not linked into the library).
NATIVE_SOURCES = [
    "thread_annotations.h", "measure.h", "fault.h", "health.h",
    "worker_pool.h", "store.h", "cma.h", "local_transport.h",
    "tcp_transport.h", "fault.cc", "health.cc", "worker_pool.cc",
    "store.cc", "cma.cc", "local_transport.cc", "tcp_transport.cc",
    "capi.cc",
]


def repo_root() -> str:
    """The checkout root (two levels up from this package)."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def baseline_path(repo: str = "", package: str = PACKAGE) -> str:
    """The baseline belonging to the tree being analyzed: a target
    repo's own ``<package>/analysis/baseline.json`` when ``--repo``
    points elsewhere or ``package`` is another package (findings must
    diff — and --write-baseline must write — against THAT tree's pins),
    else this package's."""
    if repo or package != PACKAGE:
        target = os.path.join(repo or repo_root(), package, "analysis",
                              "baseline.json")
        if os.path.isdir(os.path.dirname(target)) and \
                os.path.abspath(os.path.dirname(target)) != \
                os.path.dirname(os.path.abspath(__file__)):
            return target
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def build_model(repo: str, package: str = PACKAGE) -> Model:
    """Parse the native sources into one cross-file model (headers
    first so annotations exist before bodies are checked)."""
    model = Model()
    native = os.path.join(repo, package, "native")
    for fname in NATIVE_SOURCES:
        path = os.path.join(native, fname)
        if os.path.exists(path):
            parse_file(model, path, f"{package}/native/{fname}")
    return model


def analyze_cpp(repo: str, package: str = PACKAGE) -> List[Finding]:
    """Part A+B: annotation-checked lock discipline over the native
    layer."""
    model = build_model(repo, package)
    findings, edges = lockcheck.check_functions(model)
    findings += lockcheck.check_lock_order(model, edges)
    findings += lockcheck.check_dtor_order(model)
    return findings


def run_contracts(repo: str, package: str = PACKAGE) -> List[Finding]:
    """Part C: capi<->binding parity, knob-registry drift, tier-1 skip
    paths."""
    out = contracts.check_capi_binding(repo, package)
    out += contracts.check_knob_registry(repo, package)
    out += contracts.check_tier1_skips(repo)
    return out


def run_lockcheck(repo: str, package: str = PACKAGE) -> List[Finding]:
    return analyze_cpp(repo, package)


def run_all(repo: str = "", package: str = PACKAGE) -> List[Finding]:
    repo = repo or repo_root()
    return analyze_cpp(repo, package) + run_contracts(repo, package)


def run_against_baseline(repo: str = "", package: str = PACKAGE
                         ) -> Tuple[List[Finding], List[dict],
                                    List[Finding]]:
    """(new findings, stale baseline entries, all findings)."""
    repo = repo or repo_root()
    findings = run_all(repo, package)
    baseline = load_baseline(baseline_path(repo, package))
    new, stale = diff_baseline(findings, baseline)
    return new, stale, findings
