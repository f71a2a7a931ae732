"""The harness is driven by files: a cell, a configuration, a traffic mix
and a metric dropped in as new files are found and run with no edit to
any other file; and ``BENCHMARK.json`` agrees with the files it names."""

from __future__ import annotations

import json
import os
import textwrap

from benchmark.registry import Registry
from benchmark.run import main

from conftest import BENCH, REPO, TINY_MODEL, TINY_TRAFFIC, make_tiny_root


def _sources():
    """mtime of every file of the benchmark's folder, by path."""
    return {os.path.join(dp, n): os.path.getmtime(os.path.join(dp, n))
            for dp, _, ns in os.walk(BENCH) if "__pycache__" not in dp
            for n in ns}


def test_new_files_are_found_and_run(tmp_path, capsys):
    before = _sources()
    root = make_tiny_root(str(tmp_path))  # the tiny cells are new files
    (tmp_path / "benchmark" / "configs" / "wee.json").write_text(json.dumps(
        {"name": "wee", "model": dict(TINY_MODEL, layers=1)}))
    (tmp_path / "benchmark" / "traffic" / "wee_mix.json").write_text(
        json.dumps(dict(TINY_TRAFFIC["tiny_train"], rows=2)))
    (tmp_path / "benchmark" / "workloads" / "wee.train.json").write_text(
        json.dumps({"config": "wee", "traffic": "wee_mix", "chips": 1,
                    "ref_rows": 1, "limits": {"batch_mismatch": 0}}))
    (tmp_path / "benchmark" / "metrics" / "window_steps.train.py") \
        .write_text(textwrap.dedent('''
            KIND = "per_layer"
            UNIT = "steps"
            BETTER = "higher"
            SOURCE = "host_clock"
            LAYER = "train step"
            MOVES = "train_tokens_per_s"


            def read(run):
                return run.steps if run.kind == "train" else None
            '''))
    reg = Registry(root)
    assert reg.cell("wee.train")["config"]["model"]["layers"] == 1
    assert "window_steps.train" in reg.metrics("per_layer")
    rc = main(["--workload", "wee.train", "--seed", "4294967311",
               "--seconds", "0.3", "--trace", "1", "--device", "cpu"],
              root=root)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["window_steps.train"]["value"] == res["attempted"]
    assert _sources() == before


def test_benchmark_json_agrees_with_the_files():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    reg = Registry()
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key, was in cfg["published"].items():
            assert key in c["reduced"] and cfg[key] != was
    for w in bench["workloads"]:
        cell = reg.cell(w["name"])
        assert (cell["workload"]["config"], cell["workload"]["traffic"],
                cell["workload"]["chips"]) == (w["config"], w["traffic"],
                                               w["chips"])
        assert cell["traffic"].get("ranks", 1) == w["chips"]
    listed = {m["name"]: (m, "end_to_end") for m in bench["end_to_end"]}
    listed.update({m["name"]: (m, "per_layer") for m in bench["per_layer"]})
    assert set(listed) == set(reg.metric_names())
    for name, (m, kind) in listed.items():
        r = reg.metric(name)
        assert (r.KIND, r.UNIT, r.BETTER, r.SOURCE) == (
            kind, m["unit"], m["better"], m["source"]), name
        if kind == "per_layer":
            assert (r.LAYER, r.MOVES) == (m["layer"], m["moves"]), name
            moved = listed[m["moves"]][0]
            assert set(m["workloads"]) <= set(moved.get(
                "workloads", [w["name"] for w in bench["workloads"]]))
