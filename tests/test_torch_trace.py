"""The port's tracer (``pipeline/trace.StageClock``) and its counters.

On a 60 kb genome, 16 noisy reads (every fourth with an insertion burst
the narrow band clips, so band escalation runs a nested pass): a run
traced without synchronising maps the lines of an untraced run, its spans
nest as the run loop opens them, and the stages are the synchronising
clock's. The host-wait counters and the DP's arrow bytes on hand-made
inputs, their reset, and the ``-metrics`` file of a CLI run. (On a card,
``tests/test_torch_cuda.py`` holds the spans to the profiler's clock.)"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from blasr_tpu_torch import ops
from blasr_tpu_torch.cli import blasr as tcli
from blasr_tpu_torch.core.encode import revcomp_codes
from blasr_tpu_torch.index.artifacts import build_index_from_arrays
from blasr_tpu_torch.io.batching import Read
from blasr_tpu_torch.io.fasta import write_fasta
from blasr_tpu_torch.io.seqdb import SeqDB
from blasr_tpu_torch.ops.banded_align import SRC_LEFT
from blasr_tpu_torch.ops.banded_cuda import banded_align
from blasr_tpu_torch.ops.traceback_device import WALK_UNROLL, walk_arrows_device
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.params import MappingParams
from blasr_tpu_torch.pipeline.runner import run_mapping
from blasr_tpu_torch.pipeline.trace import Span, StageClock, covered

from conftest import mutate_read

torch.set_num_threads(1)

PARAMS = MappingParams(
    batch_size=8, max_read_len=1024, n_candidates=4, n_dp_candidates=2,
    anchor_stride=4, max_anchors_per_read=128, narrow_band=32,
    narrow_band_max=1024, min_match_length=10, direct_lut=True,
    emit_moves=False, best_n=1,
)
STAGES = {"anchors", "candidates", "setup", "dp", "walk", "select"}
BATCH_SPANS = ("dispatch", "fetch", "finalize")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(17)
    G = 60_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    index = build_index_from_arrays(genome, SeqDB(["chrA"], np.array([0, G]), ["0" * 32]),
                                    k=10)
    reads = []
    for i in range(16):
        start = int(rng.integers(0, G - 900))
        r = mutate_read(rng, genome, start, int(rng.integers(300, 700)))
        if i % 4 == 3:
            mid = len(r) // 2
            r = np.concatenate([r[:mid], rng.integers(0, 4, 90).astype(np.uint8), r[mid:]])
        if rng.integers(0, 2):
            r = revcomp_codes(r)
        reads.append(Read(f"read{i}", r, None, i))
    return index, reads, genome


@pytest.fixture(scope="module")
def runs(corpus):
    """The corpus mapped untraced, with the tracer (no synchronisation) and
    with the synchronising clock: (lines, unmapped, clock) each."""
    index, reads, _ = corpus
    out = {}
    for name, clock in (("none", None), ("spans", StageClock("cpu", sync=False)),
                        ("sync", StageClock("cpu"))):
        recs, unm = run_mapping(index, reads, PARAMS, device="cpu", clock=clock)
        out[name] = ([format_m4(r) for r in recs], unm, clock)
    return out


@pytest.mark.parametrize("kind", ["spans", "sync"])
def test_traced_run_maps_the_untraced_lines(runs, kind):
    lines, unm, _ = runs[kind]
    assert lines == runs["none"][0] and unm == runs["none"][1]
    assert len(lines) >= 12


def test_spans_nest_as_the_run_loop_opens_them(runs):
    clock = runs["spans"][2]
    spans = clock.spans
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)
    parent = {i: (spans[s.parent].name if s.parent >= 0 else None) for i, s in enumerate(spans)}
    by_name = {}
    for i, s in enumerate(spans):
        by_name.setdefault(s.name, []).append(i)
    top = [i for i in by_name["run"] if parent[i] is None]
    assert len(top) == 1 and spans[top[0]].attrs == {"pass_name": "first"}
    for i in by_name["dispatch"] + by_name["fetch"] + by_name["finalize"]:
        assert parent[i] == "run"
    for stage in STAGES:
        assert all(parent[i] == "dispatch" for i in by_name[stage])
    # each batch: one dispatch, one fetch and one finalize under one id, and
    # its stages carry the same id
    ids = {}
    for name in BATCH_SPANS:
        for i in by_name[name]:
            ids.setdefault(spans[i].batch, []).append(name)
    assert all(sorted(v) == sorted(BATCH_SPANS) for v in ids.values())
    assert len(ids) == len(by_name["dp"])
    assert {spans[i].batch for s in STAGES for i in by_name[s]} == set(ids)
    # the stages are the synchronising clock's, and both clocks kept seconds
    assert STAGES == set(runs["sync"][2].seconds) == set(clock.seconds)
    assert {n for n in by_name if n in STAGES} == STAGES


def test_escalation_opens_a_nested_run(runs):
    spans = runs["spans"][2].spans
    nested = [s for s in spans if s.name == "run" and s.parent >= 0]
    assert [s.attrs["pass_name"] for s in nested] == ["escalate"]
    assert spans[nested[0].parent].name == "run"
    assert any(s.batch and s.batch[0] == "escalate" for s in spans if s.name == "dispatch")


def test_spans_summary_counts_and_self_time(runs):
    clock = runs["spans"][2]
    summ = clock.summary()
    assert summ["run"]["count"] == 2 and summ["dispatch"]["count"] == summ["dp"]["count"]
    for name, row in summ.items():
        assert 0 <= row["self_seconds"] <= row["seconds"] + 1e-9
        assert row["max_memory"] is None   # no device memory on the CPU
    # a dispatch holds its stages: its self time is the copies and the gaps
    assert summ["dispatch"]["self_seconds"] < summ["dispatch"]["seconds"]
    assert clock.counters["h2d_bytes"] > 0 and clock.counters["d2h_bytes"] > 0


@pytest.mark.parametrize("intervals, lo, hi, want", [
    ([], 0, 10, 0),
    ([(2, 4), (3, 6)], 0, 10, 4),          # overlapping children count once
    ([(-5, 2), (8, 20)], 0, 10, 4),        # clipped at the parent's edges
    ([(1, 2), (4, 5), (4, 5)], 0, 10, 2),
])
def test_covered_is_the_union_inside_the_span(intervals, lo, hi, want):
    assert covered(intervals, lo, hi) == want


def test_summary_of_hand_made_spans():
    clock = StageClock("cpu", sync=False)
    clock.spans = [Span("run", 0, 100), Span("dispatch", 10, 40, parent=0),
                   Span("walk", 20, 30, parent=1), Span("fetch", 50, 60, parent=0)]
    s = clock.summary()
    assert s["run"]["self_seconds"] == pytest.approx(60e-9)
    assert s["dispatch"]["self_seconds"] == pytest.approx(20e-9)
    assert s["walk"]["self_seconds"] == pytest.approx(10e-9)
    assert clock.to_wall_ns(clock.anchor[0] + 5) == clock.anchor[1] + 5


def test_spans_from_many_threads_keep_their_parents():
    clock = StageClock("cpu", sync=False)
    n_threads, n_each = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for b in range(n_each):
                clock.open("run", batch=(f"t{t}", b))
                clock.open("dispatch")
                clock.count("n", 1)
                clock.close()
                clock.close()

        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    spans = clock.spans
    assert len(spans) == 2 * n_threads * n_each and clock.counters["n"] == n_threads * n_each
    for s in spans:
        if s.name == "dispatch":
            p = spans[s.parent]
            assert p.name == "run" and p.batch == s.batch and p.start_ns <= s.start_ns
        else:
            assert s.parent == -1


def _walk_left(S, I, W, a0, scores):
    """Walk arrows that step left (a deletion: one anti-diagonal back) from
    ``a0`` until the path leaves the matrix."""
    arrows = torch.full((S, I, W), SRC_LEFT, dtype=torch.uint16)
    qoff = torch.zeros(S, dtype=torch.int32)
    best_a = torch.full((I,), a0, dtype=torch.int32)
    best_w = torch.zeros(I, dtype=torch.int32)
    ops.reset_launch_counts()
    walk_arrows_device(arrows, qoff, best_a, best_w, torch.tensor(scores, dtype=torch.int32),
                       with_moves=False)
    return walk_arrows_device.syncs


@pytest.mark.parametrize("a0, scores", [(40, [1, 2]), (0, [-5, 3]), (7, [-5, -1]),
                                        (40, [-5, 0]), (83, [-5, -5])])
def test_walk_counts_its_activity_checks(a0, scores):
    S, I, W = 84, 2, 32
    n_it = -(-(2 * S + 4) // WALK_UNROLL)
    # a live item takes a0 + 1 sub-steps; the loop checks before each
    # iteration and once more to stop, unless it runs out of iterations
    steps = a0 + 1 if any(s < 0 for s in scores) else 0
    want = min(n_it, -(-steps // WALK_UNROLL) + 1)
    assert _walk_left(S, I, W, a0, scores) == want


def _dp(I, L, T, W):
    g = torch.Generator().manual_seed(I * L)
    q = torch.randint(0, 4, (I, L), generator=g, dtype=torch.uint8)
    t = torch.randint(0, 4, (I, T), generator=g, dtype=torch.uint8)
    qlen = torch.full((I,), L, dtype=torch.int32)
    tlo = torch.zeros(I, dtype=torch.int32)
    thi = torch.full((I,), T, dtype=torch.int32)
    qoff = torch.zeros(L + T - 1, dtype=torch.int32)
    return banded_align(q, qlen, t, tlo, thi, qoff, with_traceback=True, band_width=W)


@pytest.mark.parametrize("shapes", [[(3, 16, 24, 32)], [(2, 16, 32, 64), (4, 8, 16, 32)],
                                    [(4, 8, 16, 32), (2, 16, 32, 64)]])
def test_max_arrow_bytes_is_the_largest_arrow_tensor(shapes):
    ops.reset_launch_counts()
    for shp in shapes:
        res = _dp(*shp)
        I, L, T, W = shp
        assert tuple(res.arrows.shape) == (L + T - 1, I, W)
    want = max((L + T - 1) * I * W * 2 for I, L, T, W in shapes)
    assert banded_align.max_arrow_bytes == want == ops.counters()["max_arrow_bytes"]


def test_reset_zeroes_the_new_counters(corpus):
    index, reads, _ = corpus
    run_mapping(index, reads[:8], PARAMS, device="cpu")
    got = ops.counters()
    assert got["max_arrow_bytes"] > 0 and all(v > 0 for v in got["syncs"].values())
    ops.SECONDARY["checked"] += 1
    ops.reset_launch_counts()
    got = ops.counters()
    assert got["max_arrow_bytes"] == 0 and set(got["syncs"].values()) == {0}
    assert set(got["secondary"]) == {"checked", "gated", "cut_sdp", "replaced", "refined",
                                     "cut_refined", "refine_calls", "native"}
    assert set(got["secondary"].values()) == {0}


def test_cli_metrics_file_holds_spans_and_counters(corpus, tmp_path):
    _, reads, genome = corpus
    write_fasta(str(tmp_path / "g.fa"), [("chrA", genome)])
    write_fasta(str(tmp_path / "r.fa"), [(r.name, r.codes) for r in reads])
    argv = [str(tmp_path / "r.fa"), str(tmp_path / "g.fa"), "-m", "4", "-batchSize", "8",
            "-maxReadLen", "1024", "-minMatch", "10", "-device", "cpu"]
    assert tcli.main([*argv, "-out", str(tmp_path / "plain.m4")]) == 0
    ops.reset_launch_counts()   # the counters are the process's: one run each
    assert tcli.main([*argv, "-out", str(tmp_path / "traced.m4"),
                      "-metrics", str(tmp_path / "m.json")]) == 0
    plain = (tmp_path / "plain.m4").read_bytes()
    assert plain and (tmp_path / "traced.m4").read_bytes() == plain
    met = json.loads((tmp_path / "m.json").read_text())
    assert {"run", *BATCH_SPANS, *STAGES} <= set(met["spans"])
    assert all(set(v) == {"count", "seconds", "self_seconds", "max_memory"}
               for v in met["spans"].values())
    c = met["counters"]
    assert c["syncs"]["walk"] > 0 and c["syncs"]["to_host"] == met["spans"]["fetch"]["count"]
    assert c["max_arrow_bytes"] > 0 and c["h2d_bytes"] > 0 and c["d2h_bytes"] > 0
    assert c["index_builds"] + c["index_cache_reads"] >= 1
    assert isinstance(c["compiler_runs"], list)
    assert met["kernelLaunches"] == ops.launch_counts()
