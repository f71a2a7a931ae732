"""Whole runs of tiny cells on the CPU: the result line's keys, sound runs
judged correct, and each fault a cell can have, planted in the program
underneath the timed path, judged not correct. The control (the
reference in the program's place on fp8 operands) fails the limits of
the cell it stands for."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark import control
from benchmark.registry import Registry
from benchmark.run import main


REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2147483659  # more than 32 signed bits hold


def run_cell(root, capsys, cell, trace=0, seed=SEED, seconds=0.5):
    rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(trace), "--device", "cpu"],
              root=root)
    out = capsys.readouterr()
    assert rc == 0, out.err[-4000:]
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("cell,trace", [("tiny.train", 0), ("tiny.train", 1)])
def test_sound_run_is_correct_and_has_the_contract_keys(tiny_root, capsys,
                                                        cell, trace):
    res, err = run_cell(tiny_root, capsys, cell, trace)
    want = RESULT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(res) == want
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["device"]["platform"] == "cpu"
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in res["metrics"]
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"}, name
    # each number compared ends standard error, beside its limit
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[1] for line in tail] == list(res["checks"])
    assert all(" limit " in line for line in tail)


def _unchanged_state(monkeypatch):
    from ddstore_tpu_torch.models import transformer as tr
    make = tr.make_train_step

    def make_step(model, opt, **kw):
        step = make(model, opt, **kw)

        def frozen(*args):
            before = [p.detach().clone() for p in model.parameters()]
            loss = step(*args)
            with torch.no_grad():
                for p, b in zip(model.parameters(), before):
                    p.copy_(b)
            return loss
        return frozen

    monkeypatch.setattr(tr, "make_train_step", make_step)


def _half_batch(monkeypatch):
    from ddstore_tpu_torch.models import transformer as tr
    loss = tr.lm_loss

    def half(model, tokens, targets, positions, **kw):
        n = tokens.shape[0] // 2
        return loss(model, tokens[:n], targets[:n], positions[:n], **kw)

    monkeypatch.setattr(tr, "lm_loss", half)


def _token_altered(monkeypatch):
    from ddstore_tpu_torch.data.dataset import ShardedDataset
    fetch = ShardedDataset.fetch

    def altered(self, indices, out=None):
        got = fetch(self, indices, out)
        got[0][0, 0] ^= 1
        return got

    monkeypatch.setattr(ShardedDataset, "fetch", altered)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.train", _unchanged_state), ("tiny.train", _half_batch),
    ("tiny.train", _token_altered)])
def test_a_planted_fault_is_not_correct(tiny_root, capsys, monkeypatch, cell,
                                        fault):
    fault(monkeypatch)
    res, _ = run_cell(tiny_root, capsys, cell)
    assert res["correct"] is False, res["checks"]


def _dp2(tiny_root, tmp_path, patch: str) -> subprocess.CompletedProcess:
    """A run of the two-rank tiny cell with ``patch`` as every process's
    ``sitecustomize``; the rendezvous directory has to be gone after."""
    site = tmp_path / "site"
    site.mkdir(parents=True)
    (site / "sitecustomize.py").write_text(textwrap.dedent(patch))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(site), REPO]), TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "tiny.train-dp2", "--seed", str(SEED), "--seconds", "0.5",
         "--trace", "0", "--device", "cpu"],
        cwd=os.path.dirname(tiny_root), env=env, capture_output=True,
        text=True, timeout=300)
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(
        "bench-rdv-")], "the rendezvous directory was left behind"
    return proc


def _result(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_two_ranks_sound_and_without_the_exchange(tiny_root, tmp_path):
    """Over two gloo ranks a sound run is correct; with the gradient
    all-reduce left out of the step it is not."""
    res = _result(_dp2(tiny_root, tmp_path / "sound", ""))
    assert res["correct"] is True, res["checks"]
    assert res["device"]["count"] == 2
    res = _result(_dp2(tiny_root, tmp_path / "fault", """
        from ddstore_tpu_torch.models import transformer as tr
        tr.all_reduce_gradients = lambda *args, **kw: None
        """))
    assert res["correct"] is False, res["checks"]


def test_jax_on_another_rank_gives_no_result(tiny_root, tmp_path):
    """A module named ``jax`` loaded by rank 1 alone: rank 0 prints no
    result and exits with a code other than 0."""
    proc = _dp2(tiny_root, tmp_path, """
        import os, sys, types
        if os.environ.get("DDSTORE_RANK") == "1":
            sys.modules["jax"] = types.ModuleType("jax")
        """)
    assert proc.returncode != 0
    assert "{" not in proc.stdout, proc.stdout[-2000:]
    assert "{1: ['jax']}" in proc.stderr, proc.stderr[-4000:]


@pytest.mark.parametrize("reading", ["fp8", "frozen_ln", "frozen_ln_bias"])
def test_the_control_fails_the_limits(tiny_root, reading):
    """The reference computed on fp8 operands, and a step that leaves the
    LayerNorm leaves (and the biases) unchanged, judged by the run's own
    numbers, exceed at least one limit of the cell they stand for."""
    c = Registry(tiny_root).cell("tiny.train")
    got = control.train_readings(c, SEED, torch.device("cpu"))[reading]
    limits = c["workload"]["limits"]
    assert any(v > limits[k] for k, v in got.items()), got


def test_no_card_no_result(capsys):
    """Without the cards a cell asks for: no result, exit code not 0."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = main(["--workload", "gpt2-medium.train", "--seed", "1",
               "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
