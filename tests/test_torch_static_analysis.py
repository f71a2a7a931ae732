"""ddlint over the port's tree (``ddstore_tpu_torch/analysis/``), held to
the reference's analyzer (``ddstore_tpu/analysis/``).

* On the reference's tree (``package="ddstore_tpu"``) the port's analyzer
  reports the reference analyzer's findings, path for path, line for
  line. Reading the reference's source as text is not an import.
* On the port's tree it reports nothing beyond its own baseline, and that
  baseline is the reference's with the paths renamed to the port's and
  the ``TcpTransport::ReadVOnRetry touches Conn::fd`` entry gone (the
  race is fixed in the port's copy, ROADMAP C); every other entry keeps
  its symbol, message and reason. Line anchors are the port's own: a
  finding's identity is ``category:file:symbol``, and the port's copy of
  the core carries other comments.
* The knob-registry check reads the port's registry and Python roots."""

import json
import os

import pytest

from ddstore_tpu import analysis as janalysis
from ddstore_tpu_torch import analysis
from ddstore_tpu_torch.analysis import contracts

pytestmark = pytest.mark.tier1_required

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXED = "TcpTransport::ReadVOnRetry@Conn::fd"


def _rows(findings):
    return sorted((f.category, f.file, f.line, f.symbol, f.message)
                  for f in findings)


def _entries(path):
    with open(path) as f:
        return json.load(f)["findings"]


def test_reference_tree_findings_match_reference_analyzer():
    got = analysis.run_all(REPO, "ddstore_tpu")
    want = janalysis.run_all(REPO)
    assert _rows(got) == _rows(want)
    assert any(f.symbol == FIXED for f in got)
    new, stale, _ = analysis.run_against_baseline(REPO, "ddstore_tpu")
    assert not new and not stale
    assert analysis.baseline_path(REPO, "ddstore_tpu") == \
        janalysis.baseline_path()


def test_port_tree_is_clean_against_its_baseline():
    new, stale, found = analysis.run_against_baseline(REPO)
    assert not new, "\n".join(f.render() for f in new)
    assert not stale, [e["symbol"] for e in stale]
    assert found and all(f.file.startswith("ddstore_tpu_torch/")
                         for f in found if f.category == "guard")
    assert not any(f.symbol == FIXED for f in found)
    assert analysis.baseline_path(REPO) == os.path.join(
        REPO, "ddstore_tpu_torch", "analysis", "baseline.json")


def test_port_baseline_is_the_reference_baseline_renamed():
    def strip(e, rename=False):
        e = {k: v for k, v in e.items() if k != "line"}
        if rename:
            e["file"] = e["file"].replace("ddstore_tpu/",
                                          "ddstore_tpu_torch/", 1)
        return e

    port = _entries(analysis.baseline_path(REPO))
    ref = _entries(janalysis.baseline_path())
    want = [strip(e, rename=True) for e in ref if e["symbol"] != FIXED]
    assert len(want) == len(ref) - 1
    key = lambda e: (e["file"], e["symbol"])  # noqa: E731
    assert sorted(map(strip, port), key=key) == sorted(want, key=key)


def test_model_sees_the_port_core():
    m = analysis.build_model(REPO)
    conn = m.classes["TcpTransport::Conn"]
    assert conn.guarded["fd"] == "Conn::mu"
    files = {f.file for f in m.functions}
    assert "ddstore_tpu_torch/native/tcp_transport.cc" in files


def test_cli_exits_zero_on_both_trees(capsys):
    from ddstore_tpu_torch.analysis.__main__ import main

    assert main([]) == 0
    assert "0 new" in capsys.readouterr().out
    assert main(["--package", "ddstore_tpu"]) == 0
    assert "0 new" in capsys.readouterr().out


def test_knob_registry_reads_the_port_tree(tmp_path):
    pkg = tmp_path / "ddstore_tpu_torch"
    (pkg / "native").mkdir(parents=True)
    (pkg / "sched").mkdir()
    with open(os.path.join(REPO, "ddstore_tpu_torch", "sched",
                           "knobs.py")) as f:
        (pkg / "sched" / "knobs.py").write_text(f.read())
    (pkg / "native" / "x.cc").write_text(
        'const char* k = getenv("DDSTORE_NOT_A_KNOB");\n')
    (pkg / "mod.py").write_text(
        'import os\nos.environ.get("DDSTORE_SANITIZE")\n'
        'os.environ.get("DDSTORE_ALSO_NOT_ONE")\n')
    (tmp_path / "chip_smoke.py").write_text(
        'import os\nos.getenv("DDSTORE_NOR_THIS")\n')
    found = contracts.check_knob_registry(str(tmp_path),
                                          "ddstore_tpu_torch")
    assert sorted(f.symbol for f in found) == [
        "DDSTORE_ALSO_NOT_ONE@mod.py", "DDSTORE_NOR_THIS@chip_smoke.py",
        "DDSTORE_NOT_A_KNOB@x.cc"]
    assert {f.file for f in found} == {"ddstore_tpu_torch/native/x.cc",
                                       "ddstore_tpu_torch/mod.py",
                                       "chip_smoke.py"}
