"""The -bestn 2 -m 5 slice of the port against the JAX package.

``secondary_refine``'s public functions on seeded numpy inputs, and
run_mapping at best_n 2 with band escalation on a genome with planted
repeats, whose -m 0/1/2/3/5, -m 4 and SAM text must equal the JAX
package's on every record the refinement does not touch. On that fixture
one secondary takes the SDP chain's span (the ``_agree`` test fails) and
others fall to the ``min_interval`` anchor gate; the test asserts that
both happened. The port refines the secondary on the chain's span along
the chain (the JAX package emits the chain's SDP blocks there), and each
refined record is held to the benchmark's plain reference
(``refined_records.check_records``)."""

import dataclasses
import io

import numpy as np
import pytest
import torch

from blasr_tpu.core.encode import revcomp_codes
from blasr_tpu.index.artifacts import build_index_from_arrays
from blasr_tpu.io.batching import Read
from blasr_tpu.io.seqdb import SeqDB
from blasr_tpu.output.m4 import format_m4 as jformat_m4
from blasr_tpu.output import sam_writer as jsam
from blasr_tpu.output import verbose as jverbose
from blasr_tpu.pipeline import secondary_refine as jsr
from blasr_tpu.pipeline.runner import run_mapping as jax_run_mapping
from blasr_tpu_torch import ops
from blasr_tpu_torch.cli.args import build_arg_parser, params_from_args
from blasr_tpu_torch.io.batching import read_records
from blasr_tpu_torch.io.fastq import write_fastq
from blasr_tpu_torch.ops.banded_align import n_knots, qoff_from_knots
from blasr_tpu_torch.output import sam_writer as tsam
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.output import verbose as tverbose
from blasr_tpu_torch.pipeline import secondary_refine as tsr
from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping
from blasr_tpu_torch.pipeline.trace import StageClock

from conftest import mutate_read
from refined_records import check_records, untouched
from test_torch_slice import BASE

torch.set_num_threads(1)

BESTN2 = dataclasses.replace(BASE, best_n=2, emit_moves=True)
SDP_CASES = ["copy", "partial", "junk", "noisy", "indel", "n_bases"]


def _sdp_pair(case: str):
    """(query, target window, sdp_interval_align keywords) of one case."""
    rng = np.random.default_rng(SDP_CASES.index(case))
    t = rng.integers(0, 4, 1200).astype(np.uint8)
    kw = {}
    if case == "copy":
        q = t[150:850].copy()
    elif case == "partial":                      # only q200-500 is supported
        q = rng.integers(0, 4, 800).astype(np.uint8)
        q[200:500] = t[300:600]
        kw = dict(prefix_len=0)
    elif case == "junk":
        q = rng.integers(0, 4, 700).astype(np.uint8)
    elif case == "noisy":                        # a read-like copy, the admission's settings
        q = mutate_read(rng, t, 100, 900)
        kw = dict(indel_rate=0.9, affine_open=50, affine_extend=0)
    elif case == "indel":                        # a 200-base insertion in the query
        q = np.concatenate([t[100:500], rng.integers(0, 4, 200).astype(np.uint8), t[500:900]])
        kw = dict(word=11, prefix_len=0, indel_rate=0.3)
    else:                                        # N bases in both
        q = t[200:900].copy()
        q[::37] = 4
        t = t.copy()
        t[::53] = 4
    return q, t, kw


@pytest.mark.parametrize("case", SDP_CASES)
def test_sdp_blocks_stats_and_ops_equal_jax(case):
    q, t, kw = _sdp_pair(case)
    js, jb = jsr.sdp_interval_align(q, t, **kw)
    ts, tb = tsr.sdp_interval_align(q, t, **kw)
    assert ts == js and [list(b) for b in tb] == [list(b) for b in jb]
    if case != "junk":
        assert tb                                # a chain was found
    assert tsr.stats_from_blocks(tb, q, t) == jsr.stats_from_blocks(jb, q, t)
    np.testing.assert_array_equal(tsr.blocks_to_ops(tb), jsr.blocks_to_ops(jb))
    np.testing.assert_array_equal(tsr.revcomp_codes(q), jsr.revcomp_codes(q))


@pytest.mark.parametrize("case", ["copy", "noisy", "indel"])
def test_chain_knots_follow_the_blocks(case):
    """The refinement's guide knots (``secondary._chain_knots``: the guided
    band's ``make_qoff_knots`` on the blocks' first and last cells) keep
    every cell of every block of each chain inside the band, for items of
    one call with chains of different lengths (the padded anchors masked)."""
    from blasr_tpu_torch.pipeline.secondary import REFINE_BAND, _chain_knots, _Guide

    q, t, kw = _sdp_pair(case)
    _, blocks = tsr.sdp_interval_align(q, t, **kw)
    W = REFINE_BAND
    # the refinement's frames: the chain's query span and its genome span,
    # widened by a knot spacing before it; the second item holds the first
    # half of the chain only
    guides = [_Guide(row=0, strand=0, q_lo=bl[0][0], q_hi=bl[-1][0] + bl[-1][2],
                     g_lo=bl[0][1] - 64, g_hi=len(t), blocks=bl, t0=0)
              for bl in (blocks, blocks[: max(1, len(blocks) // 2)])]
    L = -(-(max(g.q_hi - g.q_lo for g in guides) + W // 2) // 8) * 8
    S = L + max(g.g_hi - g.g_lo for g in guides) - 1
    knots = _chain_knots(guides, S, L, W)
    assert knots.shape == (2, n_knots(S)) and knots.dtype == np.int32
    sched = qoff_from_knots(torch.from_numpy(knots), S).numpy()      # (S, I)
    for i, g in enumerate(guides):
        b = np.asarray(g.blocks, np.int64)
        for bq, bt, n in zip(b[:, 0] - g.q_lo, b[:, 1] - g.g_lo, b[:, 2]):
            k = np.arange(n)
            lo = sched[bq + bt + 2 * k, i]
            assert ((lo <= bq + k) & (bq + k < lo + W)).all()


@pytest.mark.parametrize("min_match,deficit", [(12, 5), (14, 0), (10, 3)])
def test_reference_anchor_list_and_window_sums_equal_jax(min_match, deficit):
    rng = np.random.default_rng(min_match)
    G = 30_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[20_000:21_500] = genome[2_000:3_500]          # a repeat
    index = build_index_from_arrays(genome, SeqDB(["a"], np.array([0, G]), ["0" * 32]), k=10)
    q = mutate_read(rng, genome, 1_800, 1_000, sub=0.03, ins=0.03, dele=0.02)
    args = (q, genome, index.sa, index.sa_kmers, index.k)
    ja = jsr.reference_anchor_list(*args, min_match=min_match, length_deficit=deficit)
    ta = tsr.reference_anchor_list(*args, min_match=min_match, length_deficit=deficit)
    assert len(ta[0]) > 10
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(a, b)
    for lo, hi in ((0, G), (1_500, 3_000), (19_000, 22_000), (5_000, 6_000)):
        assert tsr.sum_anchors_window(ta[1], ta[2], lo, hi) == (
            jsr.sum_anchors_window(ja[1], ja[2], lo, hi))


def repeat_corpus():
    """A 200 kb two-contig genome with six planted repeat copies (2-20%
    substitutions; every second copy with a 150-base insertion in its
    middle), 18 noisy reads over the repeats' sources and 6 elsewhere (two
    with an insertion burst the narrow band clips): (index, reads)."""
    rng = np.random.default_rng(8)
    G = 200_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    plants = []
    for j, (ln, d) in enumerate([(1500, 0.02), (1500, 0.06), (1200, 0.12), (1500, 0.2),
                                 (700, 0.03), (900, 0.08)]):
        src, dst = 10_000 + j * 15_000, 110_000 + j * 13_000
        seg = genome[src : src + ln].copy()
        m = rng.random(ln) < d
        seg[m] = (seg[m] + rng.integers(1, 4, m.sum())) % 4
        if j % 2 == 1:
            seg = np.concatenate([seg[: ln // 2], rng.integers(0, 4, 150).astype(np.uint8),
                                  seg[ln // 2 :]])
        genome[dst : dst + len(seg)] = seg
        plants.append((src, ln))
    seqdb = SeqDB(["chrA", "chrB"], np.array([0, 120_000, G], np.int64), ["0" * 32] * 2)
    index = build_index_from_arrays(genome, seqdb, k=10)
    reads = []
    for src, ln in plants:
        for off in (0, ln // 3, -300):
            start = src + off if off >= 0 else src + ln + off
            r = mutate_read(rng, genome, start, int(rng.integers(500, 1000)))
            if rng.integers(0, 2):
                r = revcomp_codes(r)
            reads.append(Read(f"read{len(reads)}", r, None, len(reads)))
    for k in range(6):
        r = mutate_read(rng, genome, int(rng.integers(0, G - 1200)), int(rng.integers(400, 1000)))
        if k % 3 == 2:
            mid = len(r) // 2
            r = np.concatenate([r[:mid], rng.integers(0, 4, 90).astype(np.uint8), r[mid:]])
        reads.append(Read(f"read{len(reads)}", r, None, len(reads)))
    return index, reads


@pytest.fixture(scope="module")
def repeat_mapping():
    """``repeat_corpus`` mapped at best_n 2 by both packages: (reads, JAX
    records and unmapped, port records and unmapped, the port's metrics,
    the index)."""
    index, reads = repeat_corpus()
    jrec, junm = jax_run_mapping(index, reads, BESTN2)
    met = MappingMetrics()
    trec, tunm = run_mapping(index, reads, BESTN2, device="cpu", metrics=met)
    return reads, (jrec, junm), (trec, tunm), met, index


def test_run_mapping_bestn2_m5_equals_jax(repeat_mapping):
    reads, (jrec, junm), (trec, tunm), met, index = repeat_mapping
    by = {r.name: r for r in reads}
    jkeep, tkeep, refined = untouched(jrec, trec)
    jl = [jverbose.format_m5(r, by[r.qname], index) for r in jkeep]
    tl = [tverbose.format_m5(r, by[r.qname], index) for r in tkeep]
    assert tl == jl
    assert tunm == junm and len(trec) >= 25
    assert len(trec) > len({r.qname for r in trec})          # secondaries were emitted
    assert met.escalated_reads > 0                            # band escalation ran
    assert met.secondary_gated >= 1                           # the min_interval gate dropped one
    assert met.secondary_replaced >= 1                        # one took the SDP chain's span
    # ... and was emitted refined: the walk's move string, held to the reference
    assert refined and all(r.path.packed is not None and r.path.n_aligned > 0 for r in refined)
    assert len(jrec) - len(jkeep) == len(refined)             # the JAX package's SDP records
    got = check_records(refined, reads, index)
    assert got["n"] == len(refined) and got["path_off"] == 0 and got["below"] == 0
    assert met.secondary_checked >= met.secondary_gated + met.secondary_replaced
    assert met.secondary_seconds > 0


@pytest.mark.parametrize("fmt", [0, 1, 2, 3, 5])
def test_write_verbose_equals_jax(repeat_mapping, fmt):
    reads, (jrec, _), (trec, _), _, index = repeat_mapping
    jkeep, tkeep, refined = untouched(jrec, trec)
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jverbose.write_verbose(jkeep, reads, index, jbuf, fmt=fmt, header=True)
    tverbose.write_verbose(tkeep, reads, index, tbuf, fmt=fmt, header=True)
    assert tbuf.getvalue() == jbuf.getvalue()
    assert tbuf.getvalue().count("\n") >= len(tkeep)
    full = io.StringIO()
    tverbose.write_verbose(trec, reads, index, full, fmt=fmt, header=True)
    assert full.getvalue().count("\n") >= len(trec)
    assert check_records(refined, reads, index)["path_off"] == 0


@pytest.mark.parametrize("clipping", ["soft", "hard", "none"])
def test_write_sam_bestn2_equals_jax(repeat_mapping, clipping):
    """-bestn 2 as SAM: each read's lowest score is its primary, the others
    carry FLAG 256. The records the refinement does not touch write as the
    JAX package writes them; a refined secondary carries the walk's move
    string, takes the writer's moves route and is held to the reference."""
    reads, (jrec, junm), (trec, tunm), _, index = repeat_mapping
    jkeep, tkeep, refined = untouched(jrec, trec)
    kw = dict(clipping=clipping, movie_name="reads.fasta", program_line="blasr_tpu -bestn 2 -sam")
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jsam.write_sam(jkeep, reads, index.seqdb, jbuf, unmapped=junm, genome=index.genome, **kw)
    tsam.write_sam(tkeep, reads, index.seqdb, tbuf, unmapped=tunm, genome=index.genome, **kw)
    assert tbuf.getvalue() == jbuf.getvalue()
    full = io.StringIO()
    tsam.write_sam(trec, reads, index.seqdb, full, unmapped=tunm, genome=index.genome, **kw)
    body = [ln.split("\t") for ln in full.getvalue().splitlines() if not ln.startswith("@")]
    assert sum(int(f[1]) & 256 > 0 for f in body) == len(trec) - len({r.qname for r in trec}) > 0
    assert refined and all(r.path.packed is not None for r in trec)
    assert check_records(refined, reads, index)["path_off"] == 0


@pytest.mark.parametrize("best_n", [2, 4])
def test_remove_contained_m4_equals_jax(repeat_mapping, best_n):
    """-removeContained on the repeat fixture: the device gate drops a
    read's records whose read span lies inside a better one's; the -m 4
    lines equal the JAX package's with the flag on and off (the refined
    records held to the reference)."""
    reads, _, _, _, index = repeat_mapping
    n_records = []
    for remove_contained in (False, True):
        params = dataclasses.replace(BESTN2, best_n=best_n, n_dp_candidates=best_n,
                                     remove_contained=remove_contained)
        jrec, junm = jax_run_mapping(index, reads, params)
        trec, tunm = run_mapping(index, reads, params, device="cpu")
        jkeep, tkeep, refined = untouched(jrec, trec)
        assert [format_m4(r) for r in tkeep] == [jformat_m4(r) for r in jkeep]
        assert check_records(refined, reads, index)["path_off"] == 0
        assert tunm == junm
        n_records.append(len(trec))
    assert n_records[0] > n_records[1] >= len(reads) - len(tunm)


def test_config2_sam_from_fastq_held_to_the_reference(tmp_path):
    """BLASR reference config 2 (``-sam -clipping soft -bestn 10
    -nCandidates 10``, at this genome's seed length) on one batch of
    ``repeat_corpus``'s reads (those of its first three repeats; one of
    their secondaries takes the SDP chain's span) as FASTQ, through the
    port's reader, run_mapping and write_sam:
    every record's CIGAR consumes the read between its clips and scores
    exactly its AS under the phred-scaled scoring, no AS is better than its
    spans' optimum, and the refinement ran (``ops.counters()``, the tracer's
    ``refine`` span)."""
    index, reads = repeat_corpus()
    qrng = np.random.default_rng(30)
    write_fastq(str(tmp_path / "r.fastq"), [
        (r.name, r.codes, np.clip(qrng.normal(30, 6, len(r.codes)), 4, 40).astype(np.uint8))
        for r in reads[:8]])
    reads = read_records(str(tmp_path / "r.fastq"))
    args = build_arg_parser().parse_args(
        ["r.fastq", "g.fa", "-sam", "-clipping", "soft", "-bestn", "10", "-nCandidates", "10",
         "-maxReadLen", "1024", "-batchSize", "8", "-minMatch", "10"])
    params = params_from_args(args)
    ops.reset_launch_counts()
    clock, met = StageClock("cpu", sync=False), MappingMetrics()
    trec, tunm = run_mapping(index, reads, params, device="cpu", metrics=met, clock=clock)
    counts = ops.counters()["secondary"]
    # one refine span a batch with records to refine, inside its finalize
    refine = [sp for sp in clock.spans if sp.name == "refine"]
    assert len(refine) == counts["refine_calls"] and all(
        sp.batch is not None and clock.spans[sp.parent].name == "finalize" for sp in refine)
    assert met.secondary_seconds >= clock.summary()["refine"]["seconds"]
    assert counts["refined"] >= 1 and counts["refine_calls"] >= 1
    assert counts["replaced"] == counts["refined"] + counts["cut_refined"]
    assert sum(r.refined for r in trec) == counts["refined"]
    assert len(trec) > len({r.qname for r in trec})
    buf = io.StringIO()
    tsam.write_sam(trec, reads, index.seqdb, buf, clipping="soft", unmapped=tunm,
                   genome=index.genome)
    assert sum(ln.split("\t")[1] in ("256", "272") for ln in buf.getvalue().splitlines()) > 0
    got = check_records(trec, reads, index)
    assert got["n"] == len(trec) and got["path_off"] == 0 and got["below"] == 0
