"""BENCHMARK.json and the files it names: every configuration, traffic
mix, check and per-layer metric loads by name, and names, units and
keys keep to the benchmark's contract."""

import json
import os

import pytest

from portbench import generators
from portbench.harness import spec

BENCH = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + WORKLOADS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert spec.NAME_RE.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"setup_s", "bases_per_s", "true_locus_pct", "peak_device_gib"} <= e2e
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_load_by_name(workload):
    b = spec.Bench(workload)
    assert b.config["name"] == b.cell["config"]
    assert isinstance(b.config["flags"], list) and isinstance(b.config["reduced"], list)
    gen = generators.load(b.traffic["generator"])
    assert callable(gen.generate)
    assert set(b.checks["limits"]) >= {"missing_reads", "locus_off_pct", "score_off_pct"}
    assert b.end_to_end() and b.per_layer()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    read = spec.load_reader(metric)
    assert callable(read)


def test_files_named_from_name_characters():
    for dirpath, dirs, files in os.walk(spec.PKG):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", ".cache", ".pytest_cache")]
        for f in files:
            if f.endswith(".pyc"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
            assert all(ch.isalnum() or ch in "_.-/" for ch in rel), rel
