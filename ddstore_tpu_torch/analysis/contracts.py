"""Python/contract lints: parallel declarations that must not drift.

The repo's most repeatable bug shape (the build's source lists, for one)
is two lists that describe the same thing and cannot import each
other. Three instances are checked here:

``capi-binding``
    every ``dds_*`` symbol defined in ``native/capi.cc`` must be
    declared/used in ``binding.py`` and vice versa — a C export nobody
    binds is dead weight; a binding decl with no export segfaults at
    ``dlsym`` time.
``knob-registry``
    every ``DDSTORE_*`` env var read anywhere (C++ ``getenv``-family /
    pin-env string literals in ``native/``; ``os.environ`` reads in the
    Python tree) AND every one documented in README/MIGRATION must be
    a ``sched/knobs.py`` REGISTRY entry. The analyzer checks its own
    knobs by the same rule (it scans its own package too).

Each check reads the files of ``package`` (``native/capi.cc``,
``binding.py``, ``sched/knobs.py`` and its Python roots,
``PY_ROOTS``) as text; the registry module is loaded from its file.
``tier1-skip``
    a test file marked ``tier1_required`` must contain no
    ``pytest.skip`` / ``skipif`` / ``importorskip`` path (the marker's
    whole point: a wedged accelerator can never skip these).
"""

from __future__ import annotations

import ast
import os
import re
from typing import List, Set

from .cppmodel import string_literals
from .findings import Finding

_DDS_EXPORT_RE = re.compile(r"^(?!\s)[A-Za-z_][\w\s\*]*?[\s\*]"
                            r"(dds_[a-z0-9_]+)\s*\(", re.M)
_DDS_NAME_RE = re.compile(r"\bdds_[a-z0-9_]+\b")
_KNOB_RE = re.compile(r"^DDSTORE_[A-Z0-9_]+$")

#: The Python files and trees whose environment reads each package's
#: registry must cover.
PY_ROOTS = {"ddstore_tpu": ["ddstore_tpu", "bench.py", "setup.py"],
            "ddstore_tpu_torch": ["ddstore_tpu_torch", "chip_smoke.py"]}


def capi_exports(capi_path: str) -> Set[str]:
    with open(capi_path) as f:
        text = f.read()
    # strip comments crudely by line (capi.cc uses // comments)
    text = re.sub(r"//[^\n]*", "", text)
    return set(_DDS_EXPORT_RE.findall(text))


def binding_decls(binding_path: str) -> Set[str]:
    """dds_* symbols binding.py actually declares or calls: attribute
    names (`lib.dds_x`) and string literals (the getattr loop's
    `"dds_epoch_begin"` style). COMMENTS are excluded — a comment
    naming a symbol must neither satisfy the parity check for a
    deleted signature nor fire a drift finding for deleted prose."""
    import io
    import tokenize as _tok
    out: Set[str] = set()
    with open(binding_path, "rb") as f:
        src = f.read()
    for tok in _tok.tokenize(io.BytesIO(src).readline):
        if tok.type == _tok.COMMENT:
            continue
        if tok.type in (_tok.NAME, _tok.STRING):
            out |= set(_DDS_NAME_RE.findall(tok.string))
    return out


def check_capi_binding(repo: str, package: str) -> List[Finding]:
    capi = os.path.join(repo, package, "native", "capi.cc")
    binding = os.path.join(repo, package, "binding.py")
    exports = capi_exports(capi)
    decls = binding_decls(binding)
    out: List[Finding] = []
    for sym in sorted(exports - decls):
        out.append(Finding(
            "capi-binding", f"{package}/native/capi.cc",
            _line_of(capi, sym), sym,
            f"capi.cc exports `{sym}` but binding.py never declares or "
            f"calls it (dead export, or a missing ctypes signature)"))
    for sym in sorted(decls - exports):
        out.append(Finding(
            "capi-binding", f"{package}/binding.py",
            _line_of(binding, sym), sym,
            f"binding.py references `{sym}` but capi.cc does not "
            f"export it (dlsym would fail at load time)"))
    return out


def _line_of(path: str, needle: str) -> int:
    """First line where `needle` appears as a whole word — substring
    matching would anchor `dds_get` at a `dds_get_batch` line."""
    pat = re.compile(rf"\b{re.escape(needle)}\b")
    with open(path) as f:
        for i, line in enumerate(f, 1):
            if pat.search(line):
                return i
    return 0


# -- knob registry ------------------------------------------------------------

def _python_env_reads(path: str) -> List[tuple]:
    """(line, name) for every DDSTORE_* env READ in a Python file:
    os.environ[...]/.get(...), os.getenv(...), and dict-style reads of
    an env mapping. Writes (env["X"] = ...) and kwargs are excluded."""
    with open(path) as f:
        try:
            tree = ast.parse(f.read(), path)
        except SyntaxError:
            return []
    reads = []

    def knob_const(node) -> str:
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _KNOB_RE.match(node.value):
            return node.value
        return ""

    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load):
            name = knob_const(node.slice)
            if name:
                reads.append((node.lineno, name))
        elif isinstance(node, ast.Call):
            fname = ""
            if isinstance(node.func, ast.Attribute):
                fname = node.func.attr
            elif isinstance(node.func, ast.Name):
                fname = node.func.id
            if fname in ("get", "getenv", "setdefault", "pop"):
                if node.args:
                    name = knob_const(node.args[0])
                    if name:
                        reads.append((node.lineno, name))
    return reads


def _cpp_knob_refs(path: str) -> List[tuple]:
    """(line, name) for every DDSTORE_* string literal in a C++ source
    — they are all env-var references in this tree (getenv/EnvLong
    arguments and RouteClass pin_env fields)."""
    with open(path) as f:
        raw = f.read()
    out = []
    for line, value in string_literals(raw):
        for m in re.finditer(r"DDSTORE_[A-Z0-9_]+", value):
            out.append((line, m.group(0)))
    return out


def _registry_for(repo: str, package: str):
    """The knob REGISTRY of the tree being analyzed, loaded from the
    target package's ``sched/knobs.py`` file: a ``--repo`` elsewhere is
    judged against its own registry, and the JAX package's registry is
    read without importing that package."""
    import importlib.util
    import sys

    path = os.path.join(repo, package, "sched", "knobs.py")
    spec = importlib.util.spec_from_file_location(
        "_ddlint_target_knobs", path)
    mod = importlib.util.module_from_spec(spec)
    # dataclass processing resolves cls.__module__ via sys.modules:
    # the module must be registered while it executes.
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(spec.name, None)
    return mod.REGISTRY


def check_knob_registry(repo: str, package: str) -> List[Finding]:
    REGISTRY = _registry_for(repo, package)
    out: List[Finding] = []
    native = os.path.join(repo, package, "native")
    for fname in sorted(os.listdir(native)):
        if not (fname.endswith(".cc") or fname.endswith(".h")):
            continue
        if fname == "demo.cc":
            continue  # standalone demo binary, not linked
        rel = f"{package}/native/{fname}"
        for line, name in _cpp_knob_refs(os.path.join(native, fname)):
            if name not in REGISTRY:
                out.append(Finding(
                    "knob-registry", rel, line, f"{name}@{fname}",
                    f"{name} referenced in native code but not in "
                    f"sched.knobs.REGISTRY — classify it as a pin of "
                    f"a planned knob or as config"))
    for root in PY_ROOTS[package]:
        path = os.path.join(repo, root)
        files = []
        if os.path.isdir(path):
            for dirpath, _dirs, names in os.walk(path):
                if "__pycache__" in dirpath or "_lib" in dirpath \
                        or "_kbuild" in dirpath:
                    continue
                files += [os.path.join(dirpath, n) for n in names
                          if n.endswith(".py")]
        elif path.endswith(".py") and os.path.exists(path):
            files = [path]
        for f in sorted(files):
            rel = os.path.relpath(f, repo)
            for line, name in _python_env_reads(f):
                if name not in REGISTRY:
                    out.append(Finding(
                        "knob-registry", rel, line,
                        f"{name}@{os.path.basename(f)}",
                        f"{name} read from the environment but not in "
                        f"sched.knobs.REGISTRY"))
    # documented knobs must be registered too (moved here from
    # tests/test_sched.py so there is ONE source of truth; the test now
    # delegates to this check)
    for doc in ("README.md", "MIGRATION.md"):
        p = os.path.join(repo, doc)
        if not os.path.exists(p):
            continue
        with open(p) as f:
            for i, line in enumerate(f, 1):
                for m in re.finditer(r"DDSTORE_[A-Z0-9_]+", line):
                    if m.group(0) not in REGISTRY:
                        out.append(Finding(
                            "knob-registry", doc, i,
                            f"{m.group(0)}@{doc}",
                            f"{m.group(0)} documented in {doc} but not "
                            f"in sched.knobs.REGISTRY"))
    # dedupe per (name, file): one finding per drift site class
    seen = set()
    uniq = []
    for f in out:
        if f.key() in seen:
            continue
        seen.add(f.key())
        uniq.append(f)
    return uniq


# -- tier1_required skip paths ------------------------------------------------

def check_tier1_skips(repo: str) -> List[Finding]:
    out: List[Finding] = []
    tests = os.path.join(repo, "tests")
    if not os.path.isdir(tests):
        return out
    for fname in sorted(os.listdir(tests)):
        if not fname.startswith("test_") or not fname.endswith(".py"):
            continue
        path = os.path.join(tests, fname)
        with open(path) as f:
            try:
                tree = ast.parse(f.read(), path)
            except SyntaxError:
                continue
        if not _is_tier1_marked(tree):
            continue
        for node in ast.walk(tree):
            bad = None
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute) and fn.attr in (
                        "skip", "importorskip", "skipif"):
                    # pytest.skip(...) / pytest.importorskip(...) /
                    # pytest.mark.skipif(...)
                    bad = fn.attr
            elif isinstance(node, ast.Attribute) and node.attr in (
                    "skipif", "skip") and isinstance(
                        node.value, ast.Attribute) and \
                    node.value.attr == "mark":
                bad = node.attr
            if bad:
                out.append(Finding(
                    "tier1-skip", f"tests/{fname}", node.lineno,
                    f"{fname}@{bad}@L{node.lineno}",
                    f"{fname} is tier1_required but contains a "
                    f"`{bad}` path — tier-1 tests must always run "
                    f"(see the marker's description)"))
    return out


def _is_tier1_marked(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        # module-level `pytestmark = pytest.mark.tier1_required` (or a
        # list containing it), and per-test decorators
        if isinstance(node, ast.Attribute) and \
                node.attr == "tier1_required":
            return True
    return False
