"""Import guard: no module of the benchmark imports JAX or the JAX
package, compared by whole top-level names (``ddstore_tpu_torch`` begins
with ``ddstore_tpu`` and is allowed), and the plain reference imports
nothing of the program either."""

from __future__ import annotations

import ast
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ddstore_tpu"}
# what the judge's side computes with: no module of the program
PLAIN = ("reference.py", "corpus.py", "weights.py", "arith.py",
         "control.py")


def _sources():
    for dirpath, _dirs, names in os.walk(BENCH):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: sorted(top_level_imports(p) & FORBIDDEN) for p in _sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_the_names_are_compared_whole():
    assert "ddstore_tpu_torch".split(".")[0] not in FORBIDDEN


def test_the_reference_side_imports_nothing_of_the_program():
    for name in PLAIN:
        got = top_level_imports(os.path.join(BENCH, name))
        assert "ddstore_tpu_torch" not in got, name
