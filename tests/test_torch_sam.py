"""The port's SAM output against the JAX package's, exact (tolerance 0:
the lines are strings and every field in them an integer or a string).

  * ``format_sam_record`` and ``write_sam`` on hand-built records: both
    strands, every clip mode, with and without quality values and QV
    tracks (values above 93), a primary with the walk's packed move string
    (the ``native.sam_fields`` route) and a secondary with ops and no move
    string (the ``native.xeq_cigar`` route), and a window whose head is
    clipped at the start of a contig;
  * the C++ helpers ``xeq_cigar`` and ``sam_fields`` against their plain
    versions and against the JAX package's on random inputs;
  * the ``best_n = 2`` map_batch wire with move strings at W = 128 and 256
    with a quality stream, and ``write_sam`` after run_mapping on a
    CLR-like FASTQ fixture with band escalation: every line equal, and an
    escalated read's line carries its retry's path.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from blasr_tpu import native as jnative
from blasr_tpu.index import artifacts as jart
from blasr_tpu.io import batching as jbat
from blasr_tpu.io import seqdb as jseqdb
from blasr_tpu.output import sam_writer as jsam
from blasr_tpu.params import MappingParams as JParams
from blasr_tpu.pipeline import mapper as jmap
from blasr_tpu.pipeline import runner as jrunner
from blasr_tpu.pipeline import traceback as jtb
from blasr_tpu_torch import native
from blasr_tpu_torch.index import artifacts as tart
from blasr_tpu_torch.io import batching as tbat
from blasr_tpu_torch.io import seqdb as tseqdb
from blasr_tpu_torch.output import sam_writer as tsam
from blasr_tpu_torch.params import MappingParams
from blasr_tpu_torch.pipeline import mapper as tmap
from blasr_tpu_torch.pipeline import runner as trunner
from blasr_tpu_torch.pipeline import traceback as ttb

from test_torch_quality import PARAMS, _reads

torch.set_num_threads(1)

M, I, D = 1, 2, 3
CLIPS = ["soft", "hard", "none", "subread"]
OPS = {
    "mixed": [M] * 12 + [I] * 3 + [M] * 20 + [D] * 4 + [M] * 9 + [I, D, D] + [M] * 30,
    "edge_gaps": [I] * 2 + [D] + [M] * 40 + [D] * 3 + [M] * 5 + [I],
    "matches": [M] * 60,
}
QV_TAGS = ("iq", "dq", "sq", "mq", "st", "dt")


def pack_moves(ops) -> np.ndarray:
    """START->END ops as the walk's 2-bit packed move string (END->START:
    the j-th op from the end at bits 2*(j & 3) of byte j >> 2)."""
    rev = np.asarray(ops, np.uint8)[::-1]
    packed = np.zeros(max((len(rev) + 3) // 4, 1), np.uint8)
    for j, op in enumerate(rev):
        packed[j >> 2] |= op << (2 * (j & 3))
    return packed


def _records(pkg_art, pkg_seqdb, pkg_bat, pkg_runner, pkg_tb):
    """(records, reads, index): per kind of ops and strand a read with
    FASTQ quality (odd reads without) and QV tracks (every third read
    without), a packed primary and an ops-only secondary of it; a read at
    the start of contig 1 whose window head is clipped (t_start past the
    contig-forward start); a read that is listed unmapped; two reads of the
    same name."""
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 6000).astype(np.uint8)
    genome[::43] = 4                               # N bases in the genome
    starts = np.array([0, 2500, 6000], np.int64)
    index = pkg_art.build_index_from_arrays(
        genome, pkg_seqdb.SeqDB(["chr1", "chr2"], starts, ["0" * 32] * 2), k=8)
    reads, recs = [], []

    def add(kind, ops, strand, ts_f, t_start, ci, name=None):
        ops_a = np.asarray(ops, np.uint8)
        n_q, n_t = int((ops_a != D).sum()), int((ops_a != I).sum())
        qlen = n_q + 25
        q_start = 9 + strand
        g0 = int(starts[ci]) + ts_f
        # the read copies the genome under its matches, so = and X both occur
        codes = rng.integers(0, 5, qlen).astype(np.uint8)
        qi, ti = q_start, g0
        for op in ops_a:
            if op == M and rng.random() < 0.8:
                codes[qi] = genome[ti]
            qi += op != D
            ti += op != I
        if strand:
            codes = np.where(codes < 4, 3 - codes, codes)[::-1].copy()
        i = len(reads)
        qual = None if i % 2 else rng.integers(0, 95, qlen).astype(np.uint8)
        qvs = None
        if i % 3:
            qvs = {t: rng.integers(0, 255, qlen).astype(np.uint8) for t in QV_TAGS[:4]}
            qvs.update({t: rng.integers(0, 5, qlen).astype(np.uint8) for t in QV_TAGS[4:]})
            qvs["dq"] = qvs["dq"][:-1]                 # a track of the wrong length: left out
        if name is None:                           # every fourth a PacBio movie/zmw/span name
            name = f"m{i}/{100 + i}/0_{qlen}" if i % 4 == 0 else f"{kind}_{strand}"
        reads.append(pkg_bat.Read(name, codes, qual, i, qvs=qvs))
        c_len = int(starts[ci + 1] - starts[ci])
        for secondary in (False, True):
            path = pkg_tb.AlignmentPath(
                q_start=q_start, q_end=q_start + n_q, t_start=t_start, t_end=t_start + n_t,
                ops=ops_a if secondary else None, score=-5 * n_q + 7 * secondary,
                n_match=n_q - 3, n_mismatch=2, n_ins=int((ops_a == I).sum()),
                n_del=int((ops_a == D).sum()),
                packed=None if secondary else pack_moves(ops_a), packed_nops=len(ops_a))
            qs, qe, ts, te = q_start, q_start + n_q, ts_f, ts_f + n_t
            if strand:
                qs, qe, ts, te = qlen - qe, qlen - qs, c_len - te, c_len - ts
            recs.append(pkg_runner.AlignmentRecord(
                qname=name, tname=f"chr{ci + 1}", score=path.score,
                pct_similarity=round(path.pct_similarity, 4), qstrand=0, qstart=qs, qend=qe,
                qlength=qlen, tstrand=strand, tstart=ts, tend=te, tlength=c_len,
                mapqv=30 + i, contig_index=ci, tstart_fwd=ts_f, tend_fwd=ts_f + n_t,
                path=path, read_index=i))

    for k, (kind, ops) in enumerate(OPS.items()):
        for strand in (0, 1):
            add(kind, ops, strand, ts_f=150 + 61 * k + 9 * strand, t_start=4 * k, ci=(k + strand) % 2)
    add("head", OPS["mixed"], 1, ts_f=3, t_start=11, ci=1)        # window head before chr2
    add("head0", OPS["edge_gaps"], 0, ts_f=2, t_start=6, ci=0)    # ... before the genome
    unmapped_codes = rng.integers(0, 4, 80).astype(np.uint8)
    reads.append(pkg_bat.Read("lost", unmapped_codes, None, len(reads)))
    reads.append(pkg_bat.Read("lost_q", unmapped_codes, np.full(80, 12, np.uint8), len(reads)))
    add("dup", OPS["matches"], 0, ts_f=900, t_start=0, ci=0, name="dup")
    add("dup", OPS["matches"], 1, ts_f=1200, t_start=0, ci=1, name="dup")
    return recs, reads, index


@pytest.fixture(scope="module")
def both():
    return (_records(jart, jseqdb, jbat, jrunner, jtb),
            _records(tart, tseqdb, tbat, trunner, ttb))


@pytest.mark.parametrize("clipping", CLIPS)
@pytest.mark.parametrize("samqv", [None, ("sq", "st", "iq")])
def test_format_sam_record_equals_jax(both, clipping, samqv):
    (jrec, jreads, jidx), (trec, treads, tidx) = both
    for j, (a, b) in enumerate(zip(jrec, trec)):
        rj, rt = jreads[a.read_index], treads[b.read_index]
        for genome in (False, True):
            kw = dict(clipping=clipping, rgid="cf740c45b6", is_primary=j % 2 == 0, samqv=samqv,
                      genome_start=int(jidx.seqdb.starts[a.contig_index]))
            want = jsam.format_sam_record(a, rj, genome=jidx.genome if genome else None, **kw)
            got = tsam.format_sam_record(b, rt, genome=tidx.genome if genome else None, **kw)
            assert got == want, (j, genome)
            fields = got.split("\t")
            assert int(fields[1]) & 256 == (256 if j % 2 else 0)
            if genome:
                assert "=" in fields[5] and "X" in fields[5] and "M" not in fields[5]
    # the window heads before a contig's start take the padded route
    assert any(r.tstart_fwd - r.path.t_start < 0 for r in trec)


@pytest.mark.parametrize("clipping", CLIPS)
@pytest.mark.parametrize("print_unmapped", [True, False])
def test_write_sam_equals_jax(both, clipping, print_unmapped):
    (jrec, jreads, jidx), (trec, treads, tidx) = both
    kw = dict(clipping=clipping, unmapped=["lost", "lost_q"], movie_name="m54006_160504_020705",
              print_unmapped=print_unmapped, samqv=None, program_line="blasr_tpu r.fq g.fa -sam")
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jsam.write_sam(jrec, jreads, jidx.seqdb, jbuf, genome=jidx.genome, **kw)
    tsam.write_sam(trec, treads, tidx.seqdb, tbuf, genome=tidx.genome, **kw)
    assert tbuf.getvalue() == jbuf.getvalue()
    lines = tbuf.getvalue().splitlines()
    assert lines[1].startswith(f"@RG\tID:{tsam.read_group_id('m54006_160504_020705')}\t")
    assert sum(ln.startswith("dup/") for ln in lines) == 4      # both reads named dup
    assert any(ln.startswith("lost\t4\t") for ln in lines) == print_unmapped


def test_sam_header_helpers_equal_jax(both):
    (_, _, jidx), (_, _, tidx) = both
    for movie in ("default", "m54006_160504_020705_s1_p0", "reads_clr.fastq", "a_b"):
        assert tsam.read_group_id(movie) == jsam.read_group_id(movie)
        assert tsam.chip_id_of(movie) == jsam.chip_id_of(movie)
        assert tsam.sam_header(tidx.seqdb, "cmd", [movie, movie]) == (
            jsam.sam_header(jidx.seqdb, "cmd", [movie, movie]))
    assert tidx.seqdb.num_contigs == jidx.seqdb.num_contigs == 2
    for name in ("m1/77/0_100", "alchemy/3|ref|1|2|0", "plain", "m/x/1"):
        assert tsam._parse_zmw(name) == jsam._parse_zmw(name)


def _random_alignment(rng, n_ops, strand, head_pad):
    """Ops with runs of M, I and D; forward read codes with N bases; the
    forward target window (N bases, ``head_pad`` codes of 5 in front) that
    the span starts index; quality values up to 94."""
    runs = []
    while sum(len(r) for r in runs) < n_ops:
        runs.append([int(rng.choice([M, M, M, I, D]))] * int(rng.integers(1, 9)))
    ops = np.asarray(sum(runs, []), np.uint8)[:n_ops]
    q_start, t_start = int(rng.integers(0, 30)), head_pad + int(rng.integers(0, 20))
    n_q, n_t = int((ops != D).sum()), int((ops != I).sum())
    n = q_start + n_q + int(rng.integers(0, 30))
    fwd = rng.integers(0, 5, n).astype(np.uint8)
    aligned = np.where(fwd < 4, 3 - fwd, fwd)[::-1] if strand else fwd
    t_aln = rng.integers(0, 5, t_start + n_t).astype(np.uint8)
    t_aln[:head_pad] = 5
    qi, ti = q_start, t_start
    for op in ops:                       # mostly matches under the M ops
        if op == M and rng.random() < 0.7:
            t_aln[ti] = aligned[qi]
        qi += op != D
        ti += op != I
    qual = rng.integers(0, 95, n).astype(np.uint8)
    return ops, q_start, t_start, fwd, aligned, t_aln, qual


@pytest.mark.parametrize("strand", [0, 1])
@pytest.mark.parametrize("clip_mode", [0, 1, 2])
def test_native_sam_helpers_equal_plain_and_jax(strand, clip_mode):
    assert native.available() and jnative.available()
    rng = np.random.default_rng(10 * strand + clip_mode)
    clip_op = "H" if clip_mode == 2 else "S"
    for case in range(40):
        n_ops = (0, 1, 3)[case] if case < 3 else int(rng.integers(4, 400))
        ops, q0, t0, fwd, aligned, t_aln, qual = _random_alignment(
            rng, n_ops, strand, head_pad=(0, 7)[case % 2])
        packed, pre = pack_moves(ops), q0
        post = len(fwd) - q0 - int((ops != D).sum())
        args = (packed, len(ops), q0, t0, fwd, qual if case % 3 else None, t_aln, strand,
                clip_mode, clip_op)
        got = native.sam_fields(*args)
        assert got == native.sam_fields_plain(*args) == jnative.sam_fields(*args), case
        clipped = (pre if clip_mode else 0, post if clip_mode else 0)
        xargs = (ops, aligned, t_aln, q0, t0, *clipped, clip_op)
        cig = native.xeq_cigar(*xargs)
        assert cig == native.xeq_cigar_plain(*xargs) == jnative.xeq_cigar(*xargs), case
        # both routes give one CIGAR, and the JAX writer's numpy route agrees
        assert cig == got[0]
        runs = jsam._xeq_runs(ops, aligned, t_aln, q0, t0)
        body = "".join(f"{ln}{op}" for ln, op in runs)
        assert cig == (f"{clipped[0]}{clip_op}" if clipped[0] else "") + body + (
            f"{clipped[1]}{clip_op}" if clipped[1] else "")


def test_quality_above_94_fails_alike():
    """A QUAL value of 95 or more is a byte of 128 or more, which no route
    of either package decodes: each raises the same error (logged in
    ROADMAP.md queue 3 as a reference-side fault)."""
    rng = np.random.default_rng(3)
    ops, q0, t0, fwd, _, t_aln, _ = _random_alignment(rng, 50, 0, 0)
    qual = np.full(len(fwd), 200, np.uint8)
    args = (pack_moves(ops), len(ops), q0, t0, fwd, qual, t_aln, 0, 1, "S")
    for fn in (native.sam_fields, native.sam_fields_plain, jnative.sam_fields):
        with pytest.raises(UnicodeDecodeError):
            fn(*args)


# ---- run_mapping end to end on the CLR-like FASTQ fixture ----

SAM_PARAMS = dict(PARAMS, emit_moves=True)


@pytest.fixture(scope="module")
def clr():
    """The FASTQ fixture of test_torch_quality (a 60 kb two-contig genome,
    12 noisy reads with quality values, one with an insertion burst the
    narrow band clips), mapped with move strings by both packages."""
    rng = np.random.default_rng(17)
    G = 60_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    starts = np.array([0, 35_000, G], np.int64)
    jidx = jart.build_index_from_arrays(genome, jseqdb.SeqDB(["chrA", "chrB"], starts,
                                                              ["0" * 32] * 2), k=10)
    tidx = tart.build_index_from_arrays(genome, tseqdb.SeqDB(["chrA", "chrB"], starts,
                                                              ["0" * 32] * 2), k=10)
    raw = _reads(rng, genome, 12)
    jreads = [jbat.Read(n, c, q, i) for i, (n, c, q) in enumerate(raw)]
    treads = [tbat.Read(n, c, q, i) for i, (n, c, q) in enumerate(raw)]
    jout = jrunner.run_mapping(jidx, jreads, JParams(**SAM_PARAMS))
    met = trunner.MappingMetrics()
    tout = trunner.run_mapping(tidx, treads, MappingParams(**SAM_PARAMS), device="cpu",
                               metrics=met)
    return (jidx, jreads, jout), (tidx, treads, tout), met


@pytest.mark.parametrize("clipping", CLIPS)
def test_write_sam_after_run_mapping_equals_jax(clr, clipping):
    (jidx, jreads, (jrec, junm)), (tidx, treads, (trec, tunm)), met = clr
    assert met.escalated_reads > 0 and tunm == junm
    jbuf, tbuf = io.StringIO(), io.StringIO()
    kw = dict(clipping=clipping, movie_name="reads.fastq", program_line="blasr_tpu r.fastq -sam")
    jsam.write_sam(jrec, jreads, jidx.seqdb, jbuf, unmapped=junm, genome=jidx.genome, **kw)
    tsam.write_sam(trec, treads, tidx.seqdb, tbuf, unmapped=tunm, genome=tidx.genome, **kw)
    assert tbuf.getvalue() == jbuf.getvalue()
    body = [ln for ln in tbuf.getvalue().splitlines() if not ln.startswith("@")]
    assert len(body) == len(treads) and all(r.path.packed is not None for r in trec)


def test_escalated_read_carries_its_retry_path(clr):
    """The narrow pass and the wide-band retry run on their own: every read
    whose retry scored better prints the retry's SAM line in the escalated
    run, not the narrow pass's."""
    _, (tidx, treads, (trec, _)), _ = clr
    params = MappingParams(**SAM_PARAMS)
    narrow, _ = trunner.run_mapping(tidx, treads, dataclasses.replace(params, band_escalation=False),
                                    device="cpu")
    names = trunner._escalation_candidates(trunner._best_by_read(narrow), params)
    retry_reads = [r for r in treads if r.name in names]
    esc = dataclasses.replace(params, band_escalation=False, sensitive_retry=False,
                              narrow_band=0, guided_band=False)
    wide, _ = trunner.run_mapping(tidx, retry_reads, esc, device="cpu")
    by = {r.name: r for r in treads}

    def line(rec):
        return tsam.format_sam_record(rec, by[rec.qname], genome=tidx.genome,
                                      genome_start=int(tidx.seqdb.starts[rec.contig_index]))

    final = {r.qname: line(r) for r in trec}
    n_narrow = {r.qname: line(r) for r in narrow}
    better = [r for r in wide if r.score < min(x.score for x in narrow if x.qname == r.qname)]
    assert better
    for r in better:
        assert final[r.qname] == line(r) != n_narrow[r.qname]


@pytest.mark.parametrize("W", [128, 256])
def test_map_batch_wire_best_n_2_with_moves_and_quality_equal_jax(clr, W):
    """The wide band's walk with move strings at two rows a read, on a
    single quality stream: the wire bytes equal."""
    (jidx, jreads, _), (tidx, treads, _), _ = clr
    kw = dict(SAM_PARAMS, best_n=2, narrow_band=0, band_width=W)
    jm = jmap.Mapper(jidx, JParams(**kw))
    tm = tmap.Mapper(tidx, MappingParams(**kw), device="cpu")
    jb = list(jbat.batch_reads(jreads, 8, 512))
    tb = list(tbat.batch_reads(treads, 8, 512))
    assert len(jb) == len(tb) >= 2
    for j, t in zip(jb, tb):
        assert t.qual is not None and t.qual.dtype == np.uint8
        jr = jm.map_batch(j.codes, j.lengths, j.qual)
        tr = tm.map_batch(t.codes, t.lengths, t.qual)
        assert (jr.i2, jr.p, jr.b, jr.rcols) == (tr.i2, tr.p, tr.b, tr.rcols)
        assert tr.i2 == 2 * t.codes.shape[0] and tr.p > 0
        np.testing.assert_array_equal(np.asarray(jr.wire), tr.wire.numpy())
