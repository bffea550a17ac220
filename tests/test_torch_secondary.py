"""The -bestn 2 -m 5 slice of the port against the JAX package.

``secondary_refine``'s public functions on seeded numpy inputs, and
run_mapping at best_n 2 with band escalation on a genome with planted
repeats, whose -m 0/1/2/3/5 text must equal the JAX package's. On that
fixture one secondary takes the SDP chain's span (the ``_agree`` test
fails) and others fall to the ``min_interval`` anchor gate; the test
asserts that both happened."""

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
from blasr_tpu_torch.output import sam_writer as tsam
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.output import verbose as tverbose
from blasr_tpu_torch.pipeline import secondary_refine as tsr
from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping

from conftest import mutate_read
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


@pytest.fixture(scope="module")
def repeat_mapping():
    """A 200 kb two-contig genome with six planted repeat copies (2-20%
    substitutions; every second copy with a 150-base insertion in its
    middle), 18 noisy reads over the repeats' sources and 6 elsewhere (two
    with an insertion burst the narrow band clips), mapped at best_n 2 by
    both packages: (reads, JAX records and unmapped, port records and
    unmapped, the port's metrics, the index)."""
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
    jrec, junm = jax_run_mapping(index, reads, BESTN2)
    met = MappingMetrics()
    trec, tunm = run_mapping(index, reads, BESTN2, device="cpu", metrics=met)
    return reads, (jrec, junm), (trec, tunm), met, index


def test_run_mapping_bestn2_m5_equals_jax(repeat_mapping):
    reads, (jrec, junm), (trec, tunm), met, index = repeat_mapping
    by = {r.name: r for r in reads}
    jl = [jverbose.format_m5(r, by[r.qname], index) for r in jrec]
    tl = [tverbose.format_m5(r, by[r.qname], index) for r in trec]
    assert tl == jl
    assert tunm == junm and len(trec) >= 25
    assert len(trec) > len({r.qname for r in trec})          # secondaries were emitted
    assert met.escalated_reads > 0                            # band escalation ran
    assert met.secondary_gated >= 1                           # the min_interval gate dropped one
    assert met.secondary_replaced >= 1                        # one took the SDP chain's span
    # ... and was emitted: its path carries the SDP blocks' ops, no move string
    sdp = [r for r in trec if r.path.packed is None]
    assert sdp and all(r.path.n_aligned == len(r.path.ops) > 0 for r in sdp)
    assert met.secondary_checked >= met.secondary_gated + met.secondary_replaced
    assert met.secondary_seconds > 0


@pytest.mark.parametrize("fmt", [0, 1, 2, 3, 5])
def test_write_verbose_equals_jax(repeat_mapping, fmt):
    reads, (jrec, _), (trec, _), _, index = repeat_mapping
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jverbose.write_verbose(jrec, reads, index, jbuf, fmt=fmt, header=True)
    tverbose.write_verbose(trec, reads, index, tbuf, fmt=fmt, header=True)
    assert tbuf.getvalue() == jbuf.getvalue()
    assert tbuf.getvalue().count("\n") >= len(trec)


@pytest.mark.parametrize("clipping", ["soft", "hard", "none"])
def test_write_sam_bestn2_equals_jax(repeat_mapping, clipping):
    """-bestn 2 as SAM: each read's lowest score is its primary, the others
    carry FLAG 256; a secondary on the SDP chain's span has no move string
    and takes the xeq_cigar route."""
    reads, (jrec, junm), (trec, tunm), _, index = repeat_mapping
    kw = dict(clipping=clipping, movie_name="reads.fasta", program_line="blasr_tpu -bestn 2 -sam")
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jsam.write_sam(jrec, reads, index.seqdb, jbuf, unmapped=junm, genome=index.genome, **kw)
    tsam.write_sam(trec, reads, index.seqdb, tbuf, unmapped=tunm, genome=index.genome, **kw)
    assert tbuf.getvalue() == jbuf.getvalue()
    body = [ln.split("\t") for ln in tbuf.getvalue().splitlines() if not ln.startswith("@")]
    assert sum(int(f[1]) & 256 > 0 for f in body) == len(trec) - len({r.qname for r in trec}) > 0
    assert any(r.path.packed is None for r in trec)


@pytest.mark.parametrize("best_n", [2, 4])
def test_remove_contained_m4_equals_jax(repeat_mapping, best_n):
    """-removeContained on the repeat fixture: the device gate drops a
    read's records whose read span lies inside a better one's; the -m 4
    lines equal the JAX package's with the flag on and off."""
    reads, _, _, _, index = repeat_mapping
    n_records = []
    for remove_contained in (False, True):
        params = dataclasses.replace(BESTN2, best_n=best_n, n_dp_candidates=best_n,
                                     remove_contained=remove_contained)
        jrec, junm = jax_run_mapping(index, reads, params)
        trec, tunm = run_mapping(index, reads, params, device="cpu")
        assert [format_m4(r) for r in trec] == [jformat_m4(r) for r in jrec]
        assert tunm == junm
        n_records.append(len(trec))
    assert n_records[0] > n_records[1] >= len(reads) - len(tunm)
