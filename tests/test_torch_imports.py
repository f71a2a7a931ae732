"""Import hygiene of the port: ``ddstore_tpu_torch`` and ``chip_smoke.py``
import neither jax (nor flax, optax) nor anything of ``ddstore_tpu``.

Checked twice: every module of the package is imported in a fresh
interpreter and ``sys.modules`` is inspected, and every import statement
of the package and of ``chip_smoke.py`` is read from its syntax tree."""

import ast
import json
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.tier1_required

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ddstore_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ddstore_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PKG):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _sources():
        if not path.startswith(PKG):
            continue
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_package_modules_load_without_jax():
    mods = _modules()
    assert "ddstore_tpu_torch.ops.attention" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, f"importing the port loaded {bad}"
    assert "torch" in loaded


def test_no_import_statement_names_jax_or_the_reference():
    assert os.path.exists(os.path.join(REPO, "chip_smoke.py"))
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", "")) in (
                        "import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                names = [str(node.args[0].value)]
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad
