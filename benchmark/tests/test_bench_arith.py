"""The yardstick's arithmetic reproduces the figures the cells are
reckoned from."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import arith

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("config,rows,seq,flops", [
    ("gpt2-medium", 16, 1024, 3.722e13), ("pythia-1.4b", 4, 2048, 6.939e13),
    # the cells' own sizes: every term is linear in the rows
    ("gpt2-medium", 64, 1024, 4 * 3.722e13),
    ("pythia-1.4b", 12, 2048, 3 * 6.939e13)])
def test_model_flops_per_train_step(config, rows, seq, flops):
    m = _model(config)
    got = arith.lm_flops_per_step(m["vocab"], m["dim"], m["layers"], rows,
                                  seq)
    assert got == pytest.approx(flops, rel=5e-4)


def test_model_flops_per_eval_batch():
    m = _model("gpt2-medium")
    got = arith.lm_forward_flops(m["vocab"], m["dim"], m["layers"], 64, 1024)
    assert got == pytest.approx(4.963e13, rel=5e-4)


@pytest.mark.parametrize("config,rows,seq,want,fwd_bound", [
    # the forward at hd 64 is bound by its bytes: q, k, v, out and the f32
    # lse once each (0.0401 ms without the lse's 4 MiB)
    ("gpt2-medium", 16, 1024, (0.0404, 0.0522, 0.0696), "bytes"),
    ("pythia-1.4b", 4, 2048, (0.0695, 0.1043, 0.1390), "operations"),
    ("gpt2-medium", 64, 1024, (0.1615, 0.2087, 0.2782), "bytes"),
    ("pythia-1.4b", 12, 2048, (0.2086, 0.3128, 0.4171), "operations")])
def test_flash_bounds(config, rows, seq, want, fwd_bound):
    m = _model(config)
    got = arith.flash_bounds_ms(m, rows, seq)
    assert [round(got[k], 4) for k in ("fwd", "dq", "dkv")] == list(want)
    hd = m["dim"] // m["heads"]
    flops, nbytes = arith.attention_work(rows, m["heads"], seq, seq, hd, 2,
                                         True, "fwd")
    assert arith.bound_of(flops, nbytes)[1] == fwd_bound


def test_live_pairs_closed_form_matches_the_sum():
    for sq, sk, qo, ko in [(7, 7, 0, 0), (5, 9, 4, 0), (8, 8, 3, 3)]:
        want = sum(min(sk, max(0, qo + i - ko + 1)) for i in range(sq))
        assert arith.live_pairs(sq, sk, True, qo, ko) == want
    assert arith.live_pairs(3, 4, False) == 12
