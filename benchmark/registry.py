"""Everything a run needs, found by name under the benchmark's folder.

* a cell: ``workloads/<cell>.json`` (its configuration, traffic mix,
  chips, environment and the limits of its checks);
* a configuration: ``configs/<config>.json``;
* a traffic mix: ``traffic/<traffic>.json``, read by the job it names;
* a job: ``jobs/<job>.py``, the timed path of one kind of work (today
  ``train``);
* a metric: ``metrics/<metric>.py``, one reader each.

A new cell, configuration, traffic mix or metric is a new file: nothing
that is there needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

ROOT = os.path.dirname(os.path.abspath(__file__))

# What every metric reader declares, besides ``read(run)``.
READER_KEYS = ("KIND", "UNIT", "BETTER", "SOURCE")
PER_LAYER_KEYS = ("LAYER", "MOVES")


class Registry:
    """The files under ``root`` (the benchmark's folder by default)."""

    def __init__(self, root: str = ROOT):
        self.root = root

    def _json(self, folder: str, name: str) -> Dict:
        path = os.path.join(self.root, folder, name + ".json")
        if not os.path.isfile(path):
            raise KeyError(f"no {folder[:-1]} named {name!r} ({path})")
        with open(path) as f:
            return json.load(f)

    def _module(self, folder: str, name: str) -> ModuleType:
        path = os.path.join(self.root, folder, name + ".py")
        if not os.path.isfile(path):
            raise KeyError(f"no {folder[:-1]} named {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{folder}_{name}".replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def workload(self, name: str) -> Dict:
        return self._json("workloads", name)

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def job(self, name: str) -> ModuleType:
        return self._module("jobs", name)

    def metric_names(self) -> List[str]:
        folder = os.path.join(self.root, "metrics")
        return sorted(n[:-3] for n in os.listdir(folder)
                      if n.endswith(".py") and not n.startswith("_"))

    def metric(self, name: str) -> ModuleType:
        mod = self._module("metrics", name)
        keys = READER_KEYS + (PER_LAYER_KEYS if getattr(
            mod, "KIND", None) == "per_layer" else ())
        missing = [k for k in keys + ("read",) if not hasattr(mod, k)]
        if missing:
            raise ValueError(f"metric reader {name!r} lacks {missing}")
        return mod

    def metrics(self, kind: str) -> Dict[str, ModuleType]:
        """Every reader of ``kind`` (``"end_to_end"`` or
        ``"per_layer"``), by metric name."""
        out = {}
        for n in self.metric_names():
            mod = self.metric(n)
            if mod.KIND == kind:
                out[n] = mod
        return out

    def cell(self, name: str) -> Dict:
        """A cell with its configuration and traffic mix resolved:
        ``{"name", "workload", "config", "traffic"}``."""
        w = self.workload(name)
        return {"name": name, "workload": w,
                "config": self.config(w["config"]),
                "traffic": self.traffic(w["traffic"])}
