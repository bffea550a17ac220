"""Quality-scaled mapping in the port against the JAX package, exact
(tolerance 0: every output is an integer).

  * the plain banded DP with a single uint8 and a dual uint16 quality
    stream against ``blasr_tpu.ops.banded_align.banded_align`` (the XLA
    oracle that ``tests/test_qv.py`` holds equal to the Pallas kernel), on
    the ``tests/test_qv.py`` fixtures and one random batch;
  * the map_batch wire bytes for a uint8 and a dual uint16 batch that both
    hold rows without quality values;
  * the -m 4 lines of a FASTQ run with band escalation, and
    ``ignore_qualities`` giving the FASTA result.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasr_tpu.core.encode import codes_to_seq, revcomp_codes
from blasr_tpu.index.artifacts import build_index_from_arrays as jax_build_index
from blasr_tpu.io.batching import Read as JRead
from blasr_tpu.io.batching import batch_reads as jax_batch_reads
from blasr_tpu.io.batching import read_records as jax_read_records
from blasr_tpu.io.seqdb import SeqDB as JSeqDB
from blasr_tpu.ops import banded_align as jba
from blasr_tpu.output.m4 import format_m4 as jax_format_m4
from blasr_tpu.params import MappingParams as JParams
from blasr_tpu.pipeline import mapper as jmap
from blasr_tpu.pipeline.runner import run_mapping as jax_run_mapping
from blasr_tpu_torch.index.artifacts import build_index_from_arrays
from blasr_tpu_torch.io.batching import Read, batch_reads, read_records
from blasr_tpu_torch.io.seqdb import SeqDB
from blasr_tpu_torch.ops import banded_align as tba
from blasr_tpu_torch.ops.banded_cuda import banded_align as dp_wrapper
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.params import MappingParams
from blasr_tpu_torch.pipeline import mapper as tmap
from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping

from conftest import mutate_read

# The suite runs in parallel worker processes: one intra-op thread each
# keeps PyTorch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

PARAMS = dict(
    batch_size=8, max_read_len=512, n_candidates=4, n_dp_candidates=2,
    anchor_stride=4, max_anchors_per_read=128, narrow_band=32,
    narrow_band_max=512, min_match_length=10, direct_lut=True,
    emit_moves=False, best_n=1,
)


def _dual(sub, ins):
    return np.asarray(sub, np.uint16) | (np.asarray(ins, np.uint16) << 8)


def _qv_fixture_batch(mode):
    """The reads of tests/test_qv.py, one per row: a one-mismatch read and a
    one-insertion read of a random 80 bp target, with that file's quality
    streams; for the dual stream also a row with the high byte >= 128 and
    the low byte at 255 (the clip sees the unsigned value)."""
    rng = np.random.default_rng(0)
    t = rng.integers(0, 4, 80).astype(np.uint8)
    q = t[10:70].copy()
    q[30] = (q[30] + 1) % 4
    rng1 = np.random.default_rng(1)
    t1 = rng1.integers(0, 4, 80).astype(np.uint8)
    qi = np.insert(t1[10:70].copy(), 30, (t1[40] + 1) % 4)
    low_ins = np.full(61, 15, np.uint8)
    low_ins[30] = 4
    if mode == "single":
        rows = [(q, t, np.full(60, v, np.uint8)) for v in (30, 5, 15)]
        rows += [(qi, t1, low_ins), (qi, t1, np.full(61, 200, np.uint8))]
    else:
        rows = [(q, t, _dual(np.full(60, 30), np.full(60, 15))),
                (q, t, _dual(np.full(60, 15), np.full(60, 30))),
                (qi, t1, _dual(np.full(61, 15), np.full(61, 5))),
                (qi, t1, _dual(np.full(61, 255), np.full(61, 200))),
                (q, t, _dual(np.full(60, 4), np.full(60, 128)))]
    L, T = 61, 80
    I = len(rows)
    Q = np.full((I, L), 4, np.uint8)
    Tc = np.zeros((I, T), np.uint8)
    qual = np.zeros((I, L), np.uint16 if mode == "dual" else np.uint8)
    qlen = np.zeros(I, np.int32)
    for i, (qq, tt, qv) in enumerate(rows):
        Q[i, : len(qq)] = qq
        Tc[i] = tt
        qual[i, : len(qq)] = qv
        qlen[i] = len(qq)
    return Q, qlen, Tc, np.zeros(I, np.int32), np.full(I, T, np.int32), qual


def _random_batch(mode, seed=3, I=8, L=96, T=140):
    rng = np.random.default_rng(seed)
    Q = rng.integers(0, 4, (I, L)).astype(np.uint8)
    Tc = rng.integers(0, 4, (I, T)).astype(np.uint8)
    for i in range(I):
        Tc[i, 10 : 10 + L - 20] = Q[i, : L - 20]
    Q[:, ::11] = (Q[:, ::11] + 1) % 4
    Q[2, 7] = 4                                  # an N keeps n_score unscaled
    qlen = np.full(I, L, np.int32)
    qlen[0] = L - 30
    hi = 256 if mode == "dual" else 64
    qual = rng.integers(0, hi, (I, L)).astype(np.uint8)
    if mode == "dual":
        qual = _dual(qual, rng.integers(0, 256, (I, L)))
    return Q, qlen, Tc, np.zeros(I, np.int32), np.full(I, T, np.int32), qual


def _torch_qual(qual):
    return torch.from_numpy(qual.view(np.int16) if qual.dtype == np.uint16 else qual)


@pytest.mark.parametrize("mode", ["single", "dual"])
@pytest.mark.parametrize("W", [32, 64])
@pytest.mark.parametrize("batch", ["qv_fixtures", "random"])
def test_plain_dp_with_quality_matches_jax(mode, W, batch):
    Q, qlen, Tc, tlo, thi, qual = (
        _qv_fixture_batch(mode) if batch == "qv_fixtures" else _random_batch(mode)
    )
    L, T = Q.shape[1], Tc.shape[1]
    qoff = np.array(jba.make_qoff(L, T, W, (T - L) // 2))
    ref = jba.banded_align(
        *(jnp.asarray(a) for a in (Q, qlen, Tc, tlo, thi, qoff, qual)),
        with_traceback=True, band_width=W,
    )
    args = [torch.from_numpy(a) for a in (Q, qlen, Tc, tlo, thi, qoff)]
    got = dp_wrapper(*args, _torch_qual(qual), with_traceback=True, band_width=W)
    for name in ("score", "best_a", "best_w"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)), getattr(got, name).numpy(), name)
    np.testing.assert_array_equal(
        np.asarray(ref.arrows), got.arrows.view(torch.int16).numpy().view(np.uint16))
    # the quality values change the result: not the quality-free DP
    plain = tba.banded_align_plain(*args, band_width=W)
    assert not torch.equal(plain.score, got.score)


def test_qv_scaled_costs_and_modes():
    q = torch.arange(0, 256, dtype=torch.int32)
    for base in (6, 5, -3):
        np.testing.assert_array_equal(
            np.asarray(jba.qv_scaled_costs(jnp.int32(base), jnp.asarray(q.numpy()))),
            tba.qv_scaled_costs(base, q).numpy())
    assert tba.qual_mode(None) == "none"
    assert tba.qual_mode(torch.zeros(1, dtype=torch.uint8)) == "single"
    assert tba.qual_mode(torch.zeros(1, dtype=torch.int16)) == "dual"
    with pytest.raises(ValueError):
        tba.qual_mode(torch.zeros(1, dtype=torch.int32))


def _reads(rng, genome, n, lo=300, hi=480):
    out = []
    for i in range(n):
        start = int(rng.integers(0, len(genome) - hi - 50))
        r = mutate_read(rng, genome, start, int(rng.integers(lo, hi)), sub=0.02, ins=0.05, dele=0.03)
        if i == 5:                               # clipped by the narrow band
            mid = len(r) // 2
            r = np.concatenate([r[:mid], rng.integers(0, 4, 70).astype(np.uint8), r[mid:]])
        strand = int(rng.integers(0, 2))
        if strand:
            r = revcomp_codes(r)
        out.append((f"sim/{i}|ref|{start}|{start + len(r)}|{strand}", r,
                    rng.integers(3, 45, len(r)).astype(np.uint8)))
    return out


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(17)
    G = 60_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    starts = np.array([0, 35_000, G], np.int64)
    jidx = jax_build_index(genome, JSeqDB(["chrA", "chrB"], starts, ["0" * 32] * 2), k=10)
    tidx = build_index_from_arrays(genome, SeqDB(["chrA", "chrB"], starts, ["0" * 32] * 2), k=10)
    return jidx, tidx, _reads(rng, genome, 12)


def _mixed_reads(raw, mode, read_cls):
    """Rows with and without quality values: in the single batch every
    third read has none; in the dual batch reads carry iq+sq, sq only, the
    FASTQ qual only, or nothing."""
    out = []
    for i, (name, codes, qual) in enumerate(raw):
        if mode == "single":
            out.append(read_cls(name, codes, None if i % 3 == 2 else qual, i))
            continue
        kind = i % 4
        qvs = None
        if kind == 0:
            qvs = {"sq": qual, "iq": (qual * 7 % 250).astype(np.uint8) + 4}
        elif kind == 1:
            qvs = {"sq": (255 - qual).astype(np.uint8)}
        out.append(read_cls(name, codes, None if kind == 3 else qual, i, qvs=qvs))
    return out


@pytest.mark.parametrize("mode", ["single", "dual"])
def test_map_batch_wire_bytes_with_quality_equal_jax(corpus, mode):
    jidx, tidx, raw = corpus
    jm = jmap.Mapper(jidx, JParams(**PARAMS))
    tm = tmap.Mapper(tidx, MappingParams(**PARAMS), device="cpu")
    jb = list(jax_batch_reads(_mixed_reads(raw, mode, JRead), 8, 512))
    tb = list(batch_reads(_mixed_reads(raw, mode, Read), 8, 512))
    assert len(jb) == len(tb) >= 2
    for j, t in zip(jb, tb):
        assert t.qual.dtype == (np.uint16 if mode == "dual" else np.uint8)
        np.testing.assert_array_equal(j.qual, t.qual)
        jr = jm.map_batch(j.codes, j.lengths, j.qual)
        tr = tm.map_batch(t.codes, t.lengths, t.qual)
        assert (jr.i2, jr.p, jr.b, jr.rcols) == (tr.i2, tr.p, tr.b, tr.rcols)
        np.testing.assert_array_equal(np.asarray(jr.wire), tr.wire.numpy())


def test_fastq_run_mapping_m4_equals_jax_with_escalation(corpus, tmp_path):
    jidx, tidx, raw = corpus
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as f:
        for name, codes, qual in raw:
            f.write(f"@{name}\n{codes_to_seq(codes)}\n+\n{(qual + 33).tobytes().decode()}\n")
    jreads, treads = jax_read_records(str(fq)), read_records(str(fq))
    assert all(r.qual is not None for r in treads)
    jrec, junm = jax_run_mapping(jidx, jreads, JParams(**PARAMS))
    met = MappingMetrics()
    params = MappingParams(**PARAMS)
    trec, tunm = run_mapping(tidx, treads, params, device="cpu", metrics=met)
    assert [format_m4(r) for r in trec] == [jax_format_m4(r) for r in jrec]
    assert tunm == junm
    assert met.escalated_reads > 0            # the wide-band retry ran
    assert len(trec) >= 10

    # -ignoreQualities gives the FASTA result
    ign, _ = run_mapping(tidx, treads, dataclasses.replace(params, ignore_qualities=True),
                         device="cpu")
    fasta_reads = [Read(r.name, r.codes, None, r.index) for r in treads]
    fa, _ = run_mapping(tidx, fasta_reads, params, device="cpu")
    assert [format_m4(r) for r in ign] == [format_m4(r) for r in fa]
    assert [format_m4(r) for r in ign] != [format_m4(r) for r in trec]
