"""The cells of ``BENCHMARK.json`` and the files each names, found by name:

- ``configs`` entries give their file (``portbench/configs/<config>.json``):
  the BLASR flags, the genome's spec, the stated scoring, ``assumed``,
  ``reduced``;
- ``portbench/traffic/<traffic>.json``: the generator's name and its
  parameters, the chunk and pool sizes, the read format;
- ``portbench/checks/<workload>.json``: the sample size, the control's
  flags and the limit of each number the check compares;
- ``portbench/metrics/<metric>.py``: one reader per per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # portbench/
ROOT = os.path.dirname(PKG)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` at ``root`` and the cell ``workload`` of it."""

    def __init__(self, workload: str, root: str = ROOT):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(cells: {', '.join(sorted(cells))})")
        self.cell = cells[workload]
        self.name = workload
        conf = {c["name"]: c for c in self.spec["configs"]}[self.cell["config"]]
        self.config = load_json(os.path.join(root, conf["file"]))
        self.traffic = load_json(os.path.join(PKG, "traffic", self.cell["traffic"] + ".json"))
        self.checks = load_json(os.path.join(PKG, "checks", workload + ".json"))

    def end_to_end(self) -> list[dict]:
        return [m for m in self.spec["end_to_end"] if self._in_cell(m)]

    def per_layer(self) -> list[dict]:
        return [m for m in self.spec["per_layer"] if self._in_cell(m)]

    def _in_cell(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def load_reader(metric: str):
    """The ``read(records) -> float | None`` of ``metrics/<metric>.py``."""
    path = os.path.join(PKG, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
