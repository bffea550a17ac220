"""Piecewise mapping of the port against the JAX package: ``-alignContigs``
and reads longer than ``max_read_len``.

The stitcher's functions (``split_long_reads``, ``_try_stitch``,
``_trim_leading``, ``_gap_stats``, ``_select_colinear``), the dense gap
filler ``native.global_align`` (C++ and plain) and ``sdp.sdp_align`` on
seeded inputs; then ``run_mapping_piecewise`` on the fixtures of
``tests/test_piecewise.py`` (an 80 kb genome, k 13, ``max_read_len``
1024: a 20 kb contig, its reverse complement, an inversion that splits,
a reverse-complement read with a deletion, noisy long reads whose segment
gaps take SDP fills, and reads that pass through whole; and a contig over
a planted repeat), whose -m 4, -m 5 and SAM text must equal the JAX
package's, and ``run_mapping``'s automatic segmentation of 4-8 kb reads.
Tolerance 0 everywhere.

The JAX package raises when segments map at best_n 1 without move
strings (``SEG_BESTN`` 1, ``emit_moves`` off: ``_merge_run`` unpacks a
move string that was never shipped); the port ships them for segments, so
its lines there equal the JAX package's with ``emit_moves`` on."""

import io

import numpy as np
import pytest
import torch

from blasr_tpu import native as jnative
from blasr_tpu.index.artifacts import build_index_from_arrays as jbuild_index
from blasr_tpu.io.batching import Read as JRead
from blasr_tpu.io.seqdb import SeqDB as JSeqDB
from blasr_tpu.ops import sdp as jsdp
from blasr_tpu.ops.banded_align import AlignScores as JScores
from blasr_tpu.output import sam_writer as jsam
from blasr_tpu.output import verbose as jverbose
from blasr_tpu.output.m4 import format_m4 as jformat_m4
from blasr_tpu.params import MappingParams as JParams
from blasr_tpu.pipeline import piecewise as jpw
from blasr_tpu.pipeline import runner as jrunner
from blasr_tpu.sim import simulate_genome
from blasr_tpu_torch import native
from blasr_tpu_torch.core.encode import revcomp_codes
from blasr_tpu_torch.index.artifacts import build_index_from_arrays
from blasr_tpu_torch.io.batching import Read
from blasr_tpu_torch.io.seqdb import SeqDB
from blasr_tpu_torch.ops import sdp
from blasr_tpu_torch.ops.banded_align import AlignScores
from blasr_tpu_torch.output import sam_writer as tsam
from blasr_tpu_torch.output import verbose as tverbose
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.params import MappingParams
from blasr_tpu_torch.pipeline import piecewise as tpw
from blasr_tpu_torch.pipeline import runner as trunner

from conftest import mutate_read

torch.set_num_threads(1)

# the fixture parameters of tests/test_piecewise.py
PW = dict(batch_size=16, max_read_len=1024, n_candidates=2, best_n=1, min_match_length=13,
          piecewise=True)
REPEAT_PW = dict(PW, max_read_len=2048, n_candidates=4, segment_length=1024)


def _record_pair(rng, i):
    """The same random segment record in both packages."""
    kw = dict(
        qname=f"p{i % 3}", tname="ab"[int(rng.integers(0, 2))],
        score=-int(rng.integers(100, 5000)), pct_similarity=90.0, qstrand=0,
        qstart=int(rng.integers(0, 9000)), qend=0, qlength=12_000,
        tstrand=int(rng.integers(0, 2)), tstart=0, tend=0, tlength=80_000,
        mapqv=int(rng.integers(0, 255)), contig_index=0,
        tstart_fwd=int(rng.integers(0, 70_000)), tend_fwd=0,
    )
    kw["qend"] = kw["qstart"] + int(rng.integers(200, 1100))
    kw["tend_fwd"] = kw["tstart_fwd"] + int(rng.integers(200, 1300))
    return jrunner.AlignmentRecord(**kw), trunner.AlignmentRecord(**kw)


def _key(rec):
    return (rec.tname, rec.tstrand, rec.qstart, rec.qend, rec.tstart_fwd, rec.tend_fwd,
            rec.score)


@pytest.mark.parametrize("split_if_longer", [None, 2000])
def test_split_long_reads_equal_jax(split_if_longer):
    rng = np.random.default_rng(11)
    jreads, treads = [], []
    for i, n in enumerate([500, 1024, 1025, 2500, 4096, 3000, 7]):
        codes = rng.integers(0, 5, n).astype(np.uint8)
        qual = rng.integers(0, 60, n).astype(np.uint8) if i % 2 else None
        jreads.append(JRead(f"r{i}", codes, qual, i))
        treads.append(Read(f"r{i}", codes, qual, i))
    jout, jpar = jpw.split_long_reads(jreads, 1024, split_if_longer)
    tout, tpar = tpw.split_long_reads(treads, 1024, split_if_longer)
    assert tpw.SEG_SEP == jpw.SEG_SEP
    assert list(tpar) == list(jpar) and len(tout) == len(jout) > len(treads)
    for j, t in zip(jout, tout):
        assert (t.name, t.index) == (j.name, j.index)
        np.testing.assert_array_equal(t.codes, j.codes)
        assert (t.qual is None) == (j.qual is None)
        if t.qual is not None:
            np.testing.assert_array_equal(t.qual, j.qual)


def test_try_stitch_and_select_colinear_equal_jax():
    rng = np.random.default_rng(12)
    pairs = [_record_pair(rng, i) for i in range(400)]
    n_true = 0
    for (ja, ta), (jb, tb) in zip(pairs[::2], pairs[1::2]):
        # the second record placed just after the first on both axes, often
        jb.qstart = tb.qstart = ta.qend + int(rng.integers(-100, 300))
        if rng.integers(0, 2):
            jb.tstart_fwd = tb.tstart_fwd = ta.tend_fwd + int(rng.integers(-100, 400))
            jb.tend_fwd = tb.tend_fwd = tb.tstart_fwd + 900
        jb.tname, jb.tstrand = ja.tname, ja.tstrand
        tb.tname, tb.tstrand = ta.tname, ta.tstrand
        for max_gap in (200, 100_000):
            got = tpw._try_stitch(ta, tb, max_gap, 0.3)
            assert got == jpw._try_stitch(ja, jb, max_gap, 0.3)
            n_true += got
    assert n_true > 20
    # joint selection over segments with one to three placements each
    for trial in range(6):
        jby, tby = {}, {}
        k = 0
        for si in range(int(rng.integers(1, 12))):
            for _ in range(int(rng.integers(1, 4))):
                ja, ta = pairs[k]
                k += 1
                jby.setdefault(si * 2, []).append(ja)
                tby.setdefault(si * 2, []).append(ta)
        got = tpw._select_colinear(tby, 100_000, 0.3, 4000)
        want = jpw._select_colinear(jby, 100_000, 0.3, 4000)
        assert [_key(r) for r in got] == [_key(r) for r in want]


def test_trim_leading_and_gap_stats_equal_jax():
    rng = np.random.default_rng(13)
    for _ in range(200):
        ops = rng.integers(1, 4, int(rng.integers(0, 200))).astype(np.uint8)
        qt, tt = int(rng.integers(0, 80)), int(rng.integers(0, 80))
        j = jpw._trim_leading(ops, qt, tt)
        t = tpw._trim_leading(ops, qt, tt)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1:] == j[1:]
        q = rng.integers(0, 5, int((ops != 3).sum())).astype(np.uint8)
        tg = rng.integers(0, 5, int((ops != 2).sum())).astype(np.uint8)
        assert tpw._gap_stats(ops, q, tg) == jpw._gap_stats(ops, q, tg)


def _global_case(case):
    """(q, t) of the dense cases of tests/test_sdp.py, and one with N."""
    rng = np.random.default_rng(["identity", "indel", "mixed", "n_codes"].index(case))
    if case == "identity":
        q = rng.integers(0, 4, 200).astype(np.uint8)
        return q, q
    if case == "indel":
        t = rng.integers(0, 4, 150).astype(np.uint8)
        return np.delete(t, 60), t
    t = rng.integers(0, 4, 120).astype(np.uint8)
    q = t.copy()
    q[30] = (q[30] + 1) % 4
    q = np.insert(q, 70, 2)
    if case == "n_codes":
        q[::17] = 4
        t = t.copy()
        t[::23] = 4
    return q, t


@pytest.mark.parametrize("case", ["identity", "indel", "mixed", "n_codes"])
def test_global_align_equal_jax(case, monkeypatch):
    q, t = _global_case(case)
    S = JScores()
    args = (S.match, S.mismatch, S.n_score, S.insertion, S.deletion)
    assert jnative.available() and native.available()
    jc = jnative.global_align(q, t, *args)
    monkeypatch.setattr(jnative, "global_align", lambda *a, **k: None)
    jplain = jsdp.global_align_dense(q, t, S)             # the JAX numpy row sweep
    for ops, score in (native.global_align(q, t, *args), native.global_align_plain(q, t, *args),
                       sdp.global_align_dense(q, t, AlignScores())):
        for jops, jscore in (jc, jplain):
            np.testing.assert_array_equal(ops, jops)
            assert score == jscore
    if case == "identity":
        assert score == 200 * S.match


def test_global_align_empty_sides_equal_jax():
    t = np.asarray([0, 1, 2], np.uint8)
    e = np.zeros(0, np.uint8)
    for q_, t_ in ((e, t), (t, e), (e, e)):
        ops, score = sdp.global_align_dense(q_, t_, AlignScores())
        jops, jscore = jsdp.global_align_dense(q_, t_, JScores())
        np.testing.assert_array_equal(ops, jops)
        assert score == jscore


def _sdp_case(case):
    rng = np.random.default_rng({"recursion": 3, "structural_gap": 4, "tandem_gap": 29,
                                 "tandem_only": 31}[case])
    if case == "recursion":
        t = rng.integers(0, 4, 30_000).astype(np.uint8)
        q = t.copy()
        mut = rng.random(len(q)) < 0.05
        q[mut] = (q[mut] + rng.integers(1, 4, mut.sum())) % 4
    elif case == "structural_gap":
        t = rng.integers(0, 4, 20_000).astype(np.uint8)
        q = np.concatenate([t[:8_000], t[11_000:]])
    elif case == "tandem_gap":
        unit = rng.integers(0, 4, 150).astype(np.uint8)
        left = rng.integers(0, 4, 45_000).astype(np.uint8)
        right = rng.integers(0, 4, 45_000).astype(np.uint8)
        t = np.concatenate([left, np.tile(unit, 60), right])
        q = np.concatenate([left, np.tile(unit, 57), right])
    else:
        unit = rng.integers(0, 4, 200).astype(np.uint8)
        t, q = np.tile(unit, 80), np.tile(unit, 76)
    return q, t


@pytest.mark.parametrize("case", ["recursion", "structural_gap", "tandem_gap", "tandem_only"])
def test_sdp_align_equal_jax(case, monkeypatch):
    q, t = _sdp_case(case)
    jops, jscore = jsdp.sdp_align(q, t, JScores(), no_recurse_under=10_000)
    ops, score = sdp.sdp_align(q, t, AlignScores(), no_recurse_under=10_000)
    np.testing.assert_array_equal(ops, jops)
    assert score == jscore
    assert int((ops != sdp.OP_D).sum()) == len(q) and int((ops != sdp.OP_I).sum()) == len(t)
    if case == "structural_gap":
        # the same with every dense fill by the plain row sweep
        monkeypatch.setattr(native._build, "load_host_library", lambda: None)
        ops, score = sdp.sdp_align(q, t, AlignScores(), no_recurse_under=10_000)
        np.testing.assert_array_equal(ops, jops)
        assert score == jscore


def _both(genome, k=13):
    """The k = 13 index of ``genome`` in both packages."""
    seqdb = (["ref"], np.array([0, len(genome)], np.int64), ["0" * 32])
    return (jbuild_index(genome, JSeqDB(*seqdb), k=k), build_index_from_arrays(
        genome, SeqDB(*seqdb), k=k))


def _queries_80k():
    """The 80 kb genome of tests/test_piecewise.py and its queries."""
    g = simulate_genome(80_000, seed=31, repeat_fraction=0.0)
    rng = np.random.default_rng(17)
    inv = np.concatenate([g[10_000:18_000], revcomp_codes(g[18_000:26_000].copy()),
                          g[26_000:34_000]])
    rcdel = revcomp_codes(np.concatenate([g[30_000:31_480], g[31_520:33_000]]))
    noisy = [mutate_read(rng, g, s, n) for s, n in ((50_000, 6_000), (61_000, 4_500))]
    queries = [
        ("contig0", g[10_000:30_000].copy()),
        ("contigrc", revcomp_codes(g[40_000:60_000].copy())),
        ("inv", inv),
        ("rcdel", rcdel),
        ("noisy0", noisy[0]),
        ("noisy1", revcomp_codes(noisy[1])),
        ("short", g[5_000:5_700].copy()),
        ("short_noisy", mutate_read(rng, g, 70_000, 900)),
    ]
    return g, queries


def _queries_repeat():
    """The planted-repeat genome of tests/test_piecewise.py and its contig."""
    rng = np.random.default_rng(91)
    g = rng.integers(0, 4, 200_000).astype(np.uint8)
    g[150_000:153_000] = g[50_000:53_000]
    return g, [("ctg", g[46_000:58_000].copy())]


def _map_both(genome, queries, kw, runner="piecewise", jkw=None):
    """The queries through both packages: (reads, JAX (records, unmapped),
    port (records, unmapped), port metrics, port index)."""
    jidx, tidx = _both(genome)
    jreads = [JRead(n, c, None, i) for i, (n, c) in enumerate(queries)]
    treads = [Read(n, c, None, i) for i, (n, c) in enumerate(queries)]
    met = trunner.MappingMetrics()
    if runner == "piecewise":
        jout = jpw.run_mapping_piecewise(jidx, jreads, JParams(**(jkw or kw)))
        tout = tpw.run_mapping_piecewise(tidx, treads, MappingParams(**kw), device="cpu",
                                         metrics=met)
    else:
        jout = jrunner.run_mapping(jidx, jreads, JParams(**(jkw or kw)))
        tout = trunner.run_mapping(tidx, treads, MappingParams(**kw), device="cpu",
                                   metrics=met)
    return treads, jout, tout, met, tidx


@pytest.fixture(scope="module")
def piecewise_80k():
    g, queries = _queries_80k()
    return _map_both(g, queries, PW)


@pytest.fixture(scope="module")
def piecewise_repeat():
    g, queries = _queries_repeat()
    return _map_both(g, queries, REPEAT_PW)


def _text(pkg, fmt, records, unmapped, reads, index):
    buf = io.StringIO()
    if fmt == "m4":
        fm = jformat_m4 if pkg == "jax" else format_m4
        return [fm(r) for r in records]
    if fmt == "m5":
        (jverbose if pkg == "jax" else tverbose).write_verbose(records, reads, index, buf, fmt=5)
    else:
        (jsam if pkg == "jax" else tsam).write_sam(
            records, reads, index.seqdb, buf, clipping=fmt.split("_")[1], unmapped=unmapped,
            movie_name="contigs.fasta", program_line="blasr -alignContigs -sam",
            genome=index.genome)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("fixture", ["piecewise_80k", "piecewise_repeat"])
@pytest.mark.parametrize("fmt", ["m4", "m5", "sam_soft", "sam_hard"])
def test_run_mapping_piecewise_lines_equal_jax(fixture, fmt, request):
    reads, (jrec, junm), (trec, tunm), met, index = request.getfixturevalue(fixture)
    assert tunm == junm
    want = _text("jax", fmt, jrec, junm, reads, index)
    got = _text("port", fmt, trec, tunm, reads, index)
    assert got == want
    if fixture == "piecewise_repeat":
        # one whole-contig record: the joint selection keeps the in-chain copy
        assert len(trec) == 1 and (trec[0].qstart, trec[0].qend) == (0, 12_000)
        return
    by = {}
    for r in trec:
        by.setdefault(r.qname, []).append(r)
    assert len(by["contig0"]) == len(by["contigrc"]) == 1
    assert by["contigrc"][0].tstrand == 1
    assert {r.tstrand for r in by["inv"]} == {0, 1} and len(by["inv"]) >= 3
    # stitched records carry their ops and no move string
    assert all(by[n][0].path.packed is None for n in ("contig0", "noisy0", "rcdel"))
    assert met.piecewise_segments == sum(-(-len(r) // 1024) for r in reads if len(r) > 1024)
    assert met.piecewise_pass_through == 2 and met.piecewise_stitched == len(trec) - 2
    assert met.piecewise_gap_fills > 0 and met.piecewise_seconds > 0
    assert met.n_reads == len(reads) and met.n_records == len(trec)


def _long_reads():
    """4-8 kb noisy reads on the 80 kb genome (both strands) and two that
    pass through whole."""
    g, _ = _queries_80k()
    rng = np.random.default_rng(23)
    queries = []
    for i in range(6):
        r = mutate_read(rng, g, int(rng.integers(0, 70_000)), int(rng.integers(4_000, 8_000)))
        queries.append((f"long{i}", revcomp_codes(r) if i % 2 else r))
    queries += [(f"mid{i}", mutate_read(rng, g, int(rng.integers(0, 78_000)), 800))
                for i in range(2)]
    return g, queries


def test_run_mapping_auto_segments_long_reads_equal_jax():
    g, queries = _long_reads()
    kw = {k: v for k, v in PW.items() if k != "piecewise"}
    reads, (jrec, junm), (trec, tunm), met, _ = _map_both(g, queries, kw, runner="run_mapping")
    assert [format_m4(r) for r in trec] == [jformat_m4(r) for r in jrec]
    assert tunm == junm
    assert {r.qname for r in trec} == {n for n, _ in queries}
    assert met.piecewise_segments > 0 and met.piecewise_pass_through == 2


def test_segments_at_best_n_1_without_moves_map():
    """SEG_BESTN 1 (-nCandidates 1) under -m 4 (emit_moves off): the JAX
    package raises; the port maps as the JAX package does with moves."""
    g, queries = _long_reads()
    queries = [(n, c[:4000]) for n, c in queries[:3]]
    kw = {k: v for k, v in PW.items() if k != "piecewise"}
    kw.update(n_candidates=1, emit_moves=False)
    reads, (jrec, junm), (trec, tunm), met, _ = _map_both(
        g, queries, kw, runner="run_mapping", jkw=dict(kw, emit_moves=True))
    assert [format_m4(r) for r in trec] == [jformat_m4(r) for r in jrec] and tunm == junm
    assert len(trec) == 3 and met.piecewise_segments == 12
    jidx, _ = _both(g)
    with pytest.raises(TypeError):
        jrunner.run_mapping(jidx, [JRead(n, c, None, i) for i, (n, c) in enumerate(queries)],
                            JParams(**kw))
