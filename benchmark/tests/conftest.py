"""Fixtures of the benchmark's tests: a copy of the benchmark's folder
with tiny cells added as files, each held to the limits of the full-size
cell it stands for. They run on the CPU with the port's plain paths (the
card's kernels have no CPU version), in bf16 as the cells compute.

Run them with ``python -m pytest benchmark/tests`` from the repository's
root; the tests marked ``gpu`` need a card."""

from __future__ import annotations

import json
import os
import shutil

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

TINY_MODEL = {"vocab": 512, "dim": 64, "heads": 4, "layers": 2,
              "mlp_ratio": 4, "compute_dtype": "bfloat16", "ln_eps": 1e-6,
              "initializer_range": 0.02}
_TRAIN = {"job": "train", "rows": 8, "seq": 64, "shard_windows": 4096,
          "order": "random", "ranks": 1, "lr": 3e-4, "checked_steps": 3,
          "warmup_steps": 1, "trace_steps": 2}
TINY_TRAFFIC = {
    "tiny_train": _TRAIN,
    "tiny_train_dp2": dict(_TRAIN, ranks=2),
}
# tiny cell -> (the full-size cell whose limits it keeps, traffic, chips)
TINY_CELLS = {
    "tiny.train": ("gpt2-medium.train", "tiny_train", 1),
    "tiny.train-dp2": ("gpt2-medium.train", "tiny_train_dp2", 2),
}


def _dump(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_tiny_root(dst: str) -> str:
    """A copy of the benchmark's folder at ``dst/benchmark`` with the tiny
    configuration, traffic mixes and cells added; returns that folder."""
    root = os.path.join(dst, "benchmark")
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(BENCH, "configs", "gpt2-medium.json")) as f:
        cfg = json.load(f)
    _dump(os.path.join(root, "configs", "tiny.json"),
          dict(cfg, name="tiny", model=TINY_MODEL))
    for name, t in TINY_TRAFFIC.items():
        _dump(os.path.join(root, "traffic", name + ".json"), t)
    for name, (full, traffic, chips) in TINY_CELLS.items():
        with open(os.path.join(BENCH, "workloads", full + ".json")) as f:
            w = json.load(f)
        w.update(config="tiny", traffic=traffic, chips=chips, ref_rows=2)
        _dump(os.path.join(root, "workloads", name + ".json"), w)
    return root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> str:
    return make_tiny_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def card():
    """Skips where there is no CUDA card (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
