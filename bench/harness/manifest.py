"""``BENCHMARK.json`` and the files it names, found by name.

  - a cell (``workloads`` entry) names its configuration and traffic;
  - ``bench/configs/<config>.json``: the configuration (its ``run`` sizes,
    the port's ``arch`` and ``overrides``, ``reference`` and ``counts``,
    the modules of ``bench/reference`` and ``bench/counts`` that compute
    and count it);
  - ``bench/traffic/<traffic>.json``: the traffic mix;
  - ``bench/limits/<cell>.json``: the limits of the numbers that decide
    ``correct`` in that cell;
  - ``bench/metrics/<metric>.py``: a per-layer metric's reader, a
    function ``read(record)`` returning a number, or None where the
    record holds nothing to read.

A new configuration, traffic mix, cell or metric is new files and entries;
no file here changes for it.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _json(*parts: str) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


class Manifest:
    """``BENCHMARK.json`` of the checkout at ``root`` and the data files
    under its ``bench/``."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.dir = os.path.join(root, "bench")
        self.bench = _json(root, "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _json(self.dir, "configs", name + ".json")

    def traffic(self, name: str) -> dict:
        return _json(self.dir, "traffic", name + ".json")

    def limits(self, cell: str) -> Dict[str, float]:
        return _json(self.dir, "limits", cell + ".json")["limits"]

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, name: str):
        """The ``read`` function of ``bench/metrics/<name>.py``."""
        path = os.path.join(self.dir, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(f"bench.metrics.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def module(kind: str, name: str):
    """``bench.<kind>.<name>`` (a reference or a count)."""
    return importlib.import_module(f"bench.{kind}.{name}")
