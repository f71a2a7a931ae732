"""The port's host tools against the reference's: ``diag.
capability_report()`` equals the JAX package's on the same host, field
for field, and ``utils.soak.mmap_soak`` runs over the port's ``DDStore``
through the reference's three uses of it, with their parameters and
assertions: the chaos mode (``tests/test_fault.py:434``), the corrupt mode
(``tests/test_integrity.py:608``) and the 10^8-row sparse file
(``tests/test_tiering.py:453``)."""

import json
import subprocess
import sys

import pytest

from ddstore_tpu import diag as jdiag
from ddstore_tpu_torch import diag as tdiag
from ddstore_tpu_torch.utils.soak import mmap_soak

from test_integrity import _set_budgets

pytestmark = pytest.mark.tier1_required


def test_capability_report_matches_reference():
    got, want = tdiag.capability_report(), jdiag.capability_report()
    assert sorted(got) == sorted(want) == ["cma", "cold_direct", "cores",
                                          "uring"]
    for key in want:
        assert got[key] == want[key], key


def test_diag_cli_prints_the_report():
    out = subprocess.run([sys.executable, "-m", "ddstore_tpu_torch.diag",
                          "--json"], capture_output=True, text=True,
                         check=True)
    assert json.loads(out.stdout) == json.loads(json.dumps(
        jdiag.capability_report()))
    text = subprocess.run([sys.executable, "-m", "ddstore_tpu_torch.diag"],
                          capture_output=True, text=True, check=True).stdout
    for label in ("io_uring:", "cma:", "cores:", "cold tier:"):
        assert label in text


def test_soak_chaos_mode():
    # tests/test_fault.py:434
    m = mmap_soak(rows=200_000, batch=4096, nbatches=8,
                  fault_spec="reset:0.25,delay:0.2:2", fault_seed=13)
    assert m["sentinels_ok"], m
    assert m["faults_ok"], m
    assert m["fault_injected"] > 0, m
    assert m["fault_giveups"] == 0, m


def test_soak_corrupt_mode(monkeypatch):
    # tests/test_integrity.py:608
    _set_budgets(monkeypatch)
    m = mmap_soak(rows=100_000, batch=2048, nbatches=12,
                  fault_spec="corrupt:0.3", fault_seed=11)
    assert m["faults_ok"], m
    assert m["fault_giveups"] == 0
    assert m["corrupt_injected"] > 0
    assert m["corrupt_detected"] > 0
    assert m["corrupt_errors"] == 0
    assert m["sentinels_ok"]


def test_mmap_soak_1e8_rows(tmp_path):
    # tests/test_tiering.py:453
    m = mmap_soak(rows=100_000_000, batch=65536, nbatches=32,
                  directory=str(tmp_path))
    assert m["sentinels_ok"]
    assert m["rows_sampled"] == 32 * 65536
    assert m["rss_add_delta_mb"] < 200, m
    assert m["rss_delta_mb"] < 1500, m
    assert m["rows_per_s"] > 50_000, m
