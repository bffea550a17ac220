"""The port's verbose writers (-m 0, 1, 2, 3, 5) against the JAX package's
on hand-built records: both strands, both contigs, N bases, insertion and
deletion runs side by side between match blocks, leading and trailing
gaps, an empty move string, and a record whose read is not in the read
list."""

import io

import numpy as np
import pytest

from blasr_tpu.index import artifacts as jart
from blasr_tpu.io import batching as jbat
from blasr_tpu.io import seqdb as jseqdb
from blasr_tpu.output import verbose as jverbose
from blasr_tpu.pipeline import runner as jrunner
from blasr_tpu.pipeline import traceback as jtb
from blasr_tpu_torch.index import artifacts as tart
from blasr_tpu_torch.io import batching as tbat
from blasr_tpu_torch.io import seqdb as tseqdb
from blasr_tpu_torch.output import verbose as tverbose
from blasr_tpu_torch.pipeline import runner as trunner
from blasr_tpu_torch.pipeline import traceback as ttb

M, I, D = 1, 2, 3
# move strings by name; a read's span covers its ops' query columns
OPS = {
    "matches": [M] * 60,
    "mixed": [M] * 12 + [I] * 3 + [M] * 20 + [D] * 4 + [M] * 9 + [I, D, D] + [M] * 30,
    "ins_and_del": [M] * 8 + [I] * 5 + [D] * 7 + [M] * 15 + [D] * 2 + [I] * 2 + [M] * 4,
    "edge_gaps": [I] * 2 + [D] + [M] * 40 + [D] * 3 + [M] * 5 + [I],
    "empty": [],
}


def _records(pkg_art, pkg_seqdb, pkg_bat, pkg_runner, pkg_tb):
    rng = np.random.default_rng(12)
    genome = rng.integers(0, 4, 6000).astype(np.uint8)
    genome[::41] = 4                               # N bases in the genome
    starts = np.array([0, 2500, 6000], np.int64)
    index = pkg_art.build_index_from_arrays(
        genome, pkg_seqdb.SeqDB(["chr1", "chr2"], starts, ["0" * 32] * 2), k=8)
    reads, recs = [], []
    for i, (kind, ops) in enumerate(OPS.items()):
        for strand in (0, 1):
            ops_a = np.asarray(ops, np.uint8)
            n_q = int((ops_a != D).sum())
            n_t = int((ops_a != I).sum())
            qlen = n_q + 30
            codes = rng.integers(0, 5, qlen).astype(np.uint8)
            name = f"r{i}_{strand}"
            reads.append(pkg_bat.Read(name, codes, None, len(reads)))
            ci = (i + strand) % 2
            c_len = int(starts[ci + 1] - starts[ci])
            ts_f = 100 + 37 * i
            q_start = 10 + strand
            path = pkg_tb.AlignmentPath(
                q_start=q_start, q_end=q_start + n_q, t_start=0, t_end=n_t, ops=ops_a,
                score=-5 * n_q + 3 * i, n_match=n_q - i, n_mismatch=i,
                n_ins=int((ops_a == I).sum()), n_del=int((ops_a == D).sum()))
            qs, qe = q_start, q_start + n_q
            ts, te = ts_f, ts_f + n_t
            if strand:                           # m4's reverse-strand coordinates
                qs, qe, ts, te = qlen - qe, qlen - qs, c_len - te, c_len - ts
            recs.append(pkg_runner.AlignmentRecord(
                qname=name, tname=f"chr{ci + 1}", score=path.score,
                pct_similarity=round(path.pct_similarity, 4), qstrand=0, qstart=qs, qend=qe,
                qlength=qlen, tstrand=strand, tstart=ts, tend=te, tlength=c_len,
                mapqv=20 + i, contig_index=ci, tstart_fwd=ts_f, tend_fwd=ts_f + n_t,
                path=path, read_index=len(reads) - 1))
    # a record whose read is not in the read list: -m 1 and -m 3 still print it
    recs.append(recs[2].__class__(**{**recs[2].__dict__, "qname": "absent"}))
    return recs, reads, index


@pytest.fixture(scope="module")
def both():
    return (_records(jart, jseqdb, jbat, jrunner, jtb),
            _records(tart, tseqdb, tbat, trunner, ttb))


@pytest.mark.parametrize("fmt", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("header", [False, True])
def test_write_verbose_equals_jax(both, fmt, header):
    (jrec, jreads, jidx), (trec, treads, tidx) = both
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jverbose.write_verbose(jrec, jreads, jidx, jbuf, fmt=fmt, header=header)
    tverbose.write_verbose(trec, treads, tidx, tbuf, fmt=fmt, header=header)
    assert tbuf.getvalue() == jbuf.getvalue()
    if fmt in (1, 3):                            # one line a record, the absent read's too
        assert tbuf.getvalue().count("\n") == len(trec) + (header and fmt == 1)
    assert ("absent" in tbuf.getvalue()) == (fmt == 1)


@pytest.mark.parametrize("kind", list(OPS))
def test_alignment_strings_and_cigar_runs_equal_jax(both, kind):
    (jrec, jreads, jidx), (trec, treads, tidx) = both
    k = list(OPS).index(kind)
    for j in (2 * k, 2 * k + 1):                 # both strands
        assert tverbose.alignment_strings(trec[j], treads[j], tidx) == (
            jverbose.alignment_strings(jrec[j], jreads[j], jidx))
        assert trec[j].path.cigar_runs() == jrec[j].path.cigar_runs()
        assert tverbose.format_m5(trec[j], treads[j], tidx) == (
            jverbose.format_m5(jrec[j], jreads[j], jidx))
