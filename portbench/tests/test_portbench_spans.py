"""The readers of the program's counters, the idle time put down to the
program's spans, and the traced passes on a tiny genome on the CPU."""

import json

import numpy as np
import pytest
import torch

from portbench.harness import spans
from portbench.harness.spec import load_reader
from test_portbench_run import CELL, _drive, dummy_root  # noqa: F401 (fixture)

OUT = spans.OUTSIDE


@pytest.fixture
def counts(monkeypatch):
    """The program's counters set by hand: (syncs by site, DP launches)."""
    from blasr_tpu_torch import ops

    def set_counts(syncs, dp, arrows=0):
        monkeypatch.setattr(ops, "counters",
                            lambda: {"syncs": syncs, "max_arrow_bytes": arrows})
        monkeypatch.setattr(ops, "launch_counts",
                            lambda: {"banded_dp": dp, "gather_spans": dp, "gather_rows": dp})

    return set_counts


@pytest.mark.parametrize("syncs, dp, want", [
    ({"walk": 900, "to_device": 20, "to_host": 10}, 10, 93.0),
    ({"walk": 7, "to_device": 0, "to_host": 1}, 2, 4.0),
    ({"walk": 5, "to_device": 2, "to_host": 1}, 0, None),   # no DP kernel: the CPU
])
def test_syncs_per_batch_reader(counts, syncs, dp, want):
    counts(syncs, dp)
    assert load_reader("step.syncs_per_batch")({}) == want


def test_syncs_per_batch_reader_without_counters(monkeypatch):
    # a program that keeps no such counts (the parent of the change)
    from blasr_tpu_torch import ops

    monkeypatch.delattr(ops, "counters")
    assert load_reader("step.syncs_per_batch")({}) is None


@pytest.mark.parametrize("arrows, peak, card, want", [
    (30 * 2**30, 40 * 2**30, True, 75.0),
    (3, 4, True, 75.0),
    (30, 40, False, None),      # no card
    (0, 40, True, None),        # no DP call, or a program without the count
    (30, 0, True, None),
])
def test_arrows_share_reader(monkeypatch, arrows, peak, card, want):
    from blasr_tpu_torch.ops.banded_cuda import banded_align

    monkeypatch.setattr(banded_align, "max_arrow_bytes", arrows)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: peak)
    assert load_reader("memory.arrows_pct")({}) == want


# (start, end, depth, name): a run holding a dispatch holding a walk, then
# a fetch; gaps in ns
SPANS = [(0, 100, 0, "run"), (10, 50, 1, "dispatch"), (20, 40, 2, "walk"),
         (60, 90, 1, "fetch")]


@pytest.mark.parametrize("gaps, want", [
    ([(15, 25)], {"dispatch": 5, "walk": 5}),                 # clipped across two spans
    ([(22, 38)], {"walk": 16}),                               # the nested span wins
    ([(45, 65)], {"dispatch": 5, "run": 10, "fetch": 5}),
    ([(110, 130), (-20, -10)], {OUT: 30}),                    # outside every span
    ([(95, 120)], {"run": 5, OUT: 20}),
    ([], {}),
])
def test_idle_by_span(gaps, want):
    got = spans.idle_by_span(gaps, SPANS)
    assert got == pytest.approx({k: v * 1e-9 for k, v in want.items()})


def test_idle_by_span_without_spans():
    assert spans.idle_by_span([(0, 10)], []) == pytest.approx({OUT: 10e-9})


def test_span_intervals_on_the_profilers_clock():
    from blasr_tpu_torch.pipeline.trace import StageClock

    clock = StageClock("cpu", sync=False)
    clock.open("run")
    clock.open("dispatch")
    clock.close()
    clock.close()
    wall = spans.span_intervals(clock)
    assert [(d, n) for _, _, d, n in wall] == [(0, "run"), (1, "dispatch")]
    off = clock.anchor[1] - clock.anchor[0]
    assert [(a - off, b - off) for a, b, _, _ in wall] == [
        (s.start_ns, s.end_ns) for s in clock.spans]


@pytest.fixture(scope="module")
def tiny_run():
    """A stand-in for the harness's ``CellRun`` on a 30 kb genome, CPU."""
    from blasr_tpu_torch.index.artifacts import build_index_from_arrays
    from blasr_tpu_torch.io.batching import Read
    from blasr_tpu_torch.io.seqdb import SeqDB
    from blasr_tpu_torch.params import MappingParams
    from blasr_tpu_torch.pipeline import runner

    rng = np.random.default_rng(3)
    G = 30_000
    g = rng.integers(0, 4, G).astype(np.uint8)
    index = build_index_from_arrays(g, SeqDB(["c"], np.array([0, G]), ["0" * 32]), k=10)
    reads = [Read(f"r{i}", g[s : s + 300].copy(), None, i)
             for i, s in enumerate(rng.integers(0, G - 400, 8))]
    params = MappingParams(batch_size=8, max_read_len=512, min_match_length=10, direct_lut=True)

    class Run:
        device, cuda, MappingMetrics = "cpu", False, runner.MappingMetrics

        def _sync(self):
            pass

        def _map(self, part, met, **kw):
            return runner.run_mapping(index, part, params, device="cpu", metrics=met, **kw)

    return Run(), reads


def test_spanned_pass_on_the_cpu(tiny_run):
    run, part = tiny_run
    got = spans.spanned_pass(run, part)
    assert len(got["plain_s"]) == len(got["spanned_s"]) == 2
    assert got["syncs"]["walk"] > 0 and got["syncs"]["to_host"] == 1
    assert got["dp_calls"] == 0 and got["syncs_per_batch"] is None   # no DP kernel here
    assert {"run", "dispatch", "walk", "fetch", "finalize"} <= set(got["self_s"])
    assert got["bytes"]["h2d_bytes"] > 0


def test_profiled_spans_on_the_cpu_has_no_device_events(tiny_run):
    run, part = tiny_run
    assert spans.profiled_spans(run, part) == {"launches": 0, "dp_calls": 0}


def test_dry_traced_run_prints_no_counter_metrics(dummy_root):  # noqa: F811
    r = _drive(dummy_root, CELL, "trace")["trace"]
    assert r["correct"] is True and list(r)[-1] == "checks"
    assert "step.syncs_per_batch" not in r["metrics"]
    assert "memory.arrows_pct" not in r["metrics"]
    assert json.dumps(r)
