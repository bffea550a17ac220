"""Guided bands (``-useGuidedAlign``) in the port against the JAX package,
exact (tolerance 0: every output is an integer).

  * the knot schedule (``make_qoff_knots``, ``clamp_knots_to_shared``,
    ``qoff_from_knots``) on random anchors with ties and items without
    anchors, at W = 32, 64 and 128, with the JAX package's clamp bounds;
  * the plain DP with a per-item (S, I) schedule against the XLA oracle
    ``blasr_tpu.ops.banded_align.banded_align`` on the reads of
    ``tests/test_guided.py`` (insertion bursts, deletions, drift), without
    and with single and dual quality values, items near contig ends;
  * the knot walk against ``walk_arrows_device(qoff_knots=...)``;
  * map_batch wire bytes with guided bands at a W=32 and a W=128 bucket,
    and run_mapping -m 4 lines with guided bands and band escalation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasr_tpu.index.artifacts import build_index_from_arrays as jax_build_index
from blasr_tpu.io.batching import Read as JRead
from blasr_tpu.io.batching import batch_reads as jax_batch_reads
from blasr_tpu.io.seqdb import SeqDB as JSeqDB
from blasr_tpu.ops import banded_align as jba
from blasr_tpu.ops import traceback_device as jtb
from blasr_tpu.ops.banded_pallas import _guided_geometry
from blasr_tpu.output.m4 import format_m4 as jax_format_m4
from blasr_tpu.params import MappingParams as JParams
from blasr_tpu.pipeline import mapper as jmap
from blasr_tpu.pipeline.runner import run_mapping as jax_run_mapping
from blasr_tpu_torch.index.artifacts import build_index_from_arrays
from blasr_tpu_torch.io.batching import Read, batch_reads
from blasr_tpu_torch.io.seqdb import SeqDB
from blasr_tpu_torch.ops import banded_align as tba
from blasr_tpu_torch.ops import traceback_device as ttb
from blasr_tpu_torch.ops.banded_cuda import banded_align as dp_wrapper
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.params import MappingParams
from blasr_tpu_torch.pipeline import mapper as tmap
from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping

from conftest import mutate_read

# The suite runs in parallel worker processes: one intra-op thread each
# keeps PyTorch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)


def _jax_max_dev(W):
    """The clamp bound the JAX mapper applies (mapper.py:694-704)."""
    if W < 128:
        return _guided_geometry(True, 128 // W, W)[1] * W - 8
    return W - 8


@pytest.mark.parametrize("W", [32, 64, 128])
def test_knot_schedule_matches_jax(W):
    rng = np.random.default_rng(W)
    I, A, L, T = 9, 24, 600, 856
    S = L + T - 1
    aq = np.sort(rng.integers(0, L, (I, A)), axis=1).astype(np.int32)
    drift = rng.integers(-60, 60, (I, 1))
    a_anchor = (2 * aq + drift + rng.integers(-12, 12, (I, A)) + 128).astype(np.int32)
    a_anchor[:, 5] = a_anchor[:, 4]          # ties in a: input order decides
    a_anchor[2, :] = 300                     # every anchor of one item tied
    v_anchor = (aq - W // 2 + rng.integers(-3, 3, (I, A))).astype(np.int32)
    mask = rng.random((I, A)) < 0.7
    mask[1] = False                          # no anchors: the shared line
    mask[3] = False
    mask[3, 7] = True                        # one anchor: the drift line both ways
    assert tba.n_knots(S) == jba.n_knots(S)
    qoff_shared = np.array(jba.make_qoff_num(L, T, W, 128, 33437))
    assert tba.guided_max_dev(W) == _jax_max_dev(W)
    for num in (jba.QOFF_NUM_HALF, 33437):
        jk = jba.make_qoff_knots(
            jnp.asarray(a_anchor), jnp.asarray(v_anchor), jnp.asarray(mask),
            S, L, W, diag=128, num=jnp.int32(num),
        )
        tk = tba.make_qoff_knots(
            torch.from_numpy(a_anchor), torch.from_numpy(v_anchor), torch.from_numpy(mask),
            S, L, W, diag=128, num=torch.tensor(num, dtype=torch.int32),
        )
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
        jc = jba.clamp_knots_to_shared(jk, jnp.asarray(qoff_shared), W, max_dev=_jax_max_dev(W))
        tc = tba.clamp_knots_to_shared(tk, torch.from_numpy(qoff_shared), W,
                                       max_dev=tba.guided_max_dev(W))
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        assert not np.array_equal(np.asarray(jc), np.asarray(jk))   # the clamp bit
        jq = np.asarray(jba.qoff_from_knots(jc, S))
        tq = tba.qoff_from_knots(tc, S).numpy()
        np.testing.assert_array_equal(jq, tq)
        d = np.diff(tq, axis=0)
        assert d.min() >= 0 and d.max() <= 1 and tq.min() >= 0 and tq.max() <= L - W


def _guided_fixture(W, I=7, L=384, pad2=64, seed=77):
    """The reads of tests/test_guided.py's kernel tests: an insertion
    burst, a deletion or none, 4% substitutions, true-path anchors every
    40 template bases; the knots clamped as the mapper clamps them. Item 4
    lies near the start of a contig (tlo > 0), item 5 near its end."""
    rng = np.random.default_rng(seed)
    n_tpl = L - 84
    T = L + 2 * pad2
    S = L + T - 1
    Q = np.full((I, L), 4, np.uint8)
    Tc = np.full((I, T), 5, np.uint8)
    qlen = np.zeros(I, np.int32)
    aq = np.zeros((I, 8), np.int32)
    at = np.zeros((I, 8), np.int32)
    msk = np.zeros((I, 8), bool)
    burst = 50 if W < 128 else 60
    for i in range(I):
        tpl = rng.integers(0, 4, n_tpl).astype(np.uint8)
        if i % 3 == 0:
            q = np.concatenate([tpl[:150], rng.integers(0, 4, burst).astype(np.uint8), tpl[150:]])
        elif i % 3 == 1:
            q = np.concatenate([tpl[:120], tpl[120 + burst:]])
        else:
            q = tpl.copy()
        mut = rng.random(len(q)) < 0.04
        q[mut] = (q[mut] + rng.integers(1, 4, mut.sum())) % 4
        q = q[:L]
        Q[i, : len(q)] = q
        qlen[i] = len(q)
        Tc[i, pad2 : pad2 + n_tpl] = tpl
        Tc[i, :pad2] = rng.integers(0, 4, pad2)
        Tc[i, pad2 + n_tpl :] = rng.integers(0, 4, T - pad2 - n_tpl)
        for k in range(8):
            p = 36 * k + 10
            qp = p
            if i % 3 == 0 and p >= 150:
                qp = p + burst
            elif i % 3 == 1 and p >= 120:
                if p < 120 + burst:
                    continue
                qp = p - burst
            aq[i, k], at[i, k], msk[i, k] = qp, pad2 + p, True
    tlo = np.zeros(I, np.int32)
    thi = np.full(I, T, np.int32)
    tlo[4], thi[5] = pad2 + 40, pad2 + 200    # contig ends inside the window
    msk[6] = False                            # no anchors: the shared line
    qoff_shared = np.array(jba.make_qoff(L, T, W, pad2))
    knots = jba.make_qoff_knots(
        jnp.asarray(aq + at), jnp.asarray(aq - W // 2), jnp.asarray(msk),
        S, L, W, diag=pad2, num=jba.QOFF_NUM_HALF,
    )
    knots = np.array(jba.clamp_knots_to_shared(
        knots, jnp.asarray(qoff_shared), W, max_dev=_jax_max_dev(W)))
    return Q, qlen, Tc, tlo, thi, qoff_shared, knots


def _qual(mode, shape, seed=5):
    rng = np.random.default_rng(seed)
    if mode == "none":
        return None
    if mode == "single":
        return rng.integers(0, 50, shape).astype(np.uint8)
    return (rng.integers(0, 256, shape).astype(np.uint16)
            | (rng.integers(0, 256, shape).astype(np.uint16) << 8))


def _torch_qual(qual):
    if qual is None:
        return None
    return torch.from_numpy(qual.view(np.int16) if qual.dtype == np.uint16 else qual)


@pytest.mark.parametrize("W,mode", [(32, "none"), (64, "single"), (128, "none"),
                                    (128, "single"), (32, "dual")])
def test_guided_plain_dp_and_knot_walk_match_jax(W, mode):
    Q, qlen, Tc, tlo, thi, qoff_shared, knots = _guided_fixture(W)
    S = Q.shape[1] + Tc.shape[1] - 1
    qual = _qual(mode, Q.shape)
    jq = jba.qoff_from_knots(jnp.asarray(knots), S)
    ref = jba.banded_align(
        *(jnp.asarray(a) for a in (Q, qlen, Tc, tlo, thi)), jq,
        None if qual is None else jnp.asarray(qual),
        with_traceback=True, band_width=W,
    )
    tk = torch.from_numpy(knots)
    args = [torch.from_numpy(a) for a in (Q, qlen, Tc, tlo, thi)]
    got = dp_wrapper(*args, None, _torch_qual(qual), knots=tk, with_traceback=True, band_width=W)
    for name in ("score", "best_a", "best_w"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)), getattr(got, name).numpy(), name)
    np.testing.assert_array_equal(
        np.asarray(ref.arrows), got.arrows.view(torch.int16).numpy().view(np.uint16))
    assert (np.asarray(ref.score) < 0).all()
    # the per-item schedules place the bands elsewhere than the shared one
    shared = tba.banded_align_plain(*args, torch.from_numpy(qoff_shared), _torch_qual(qual),
                                    band_width=W)
    assert not torch.equal(shared.best_w, got.best_w)

    pad2 = 64
    jw = jtb.walk_arrows_device(
        ref.arrows, jnp.asarray(qoff_shared), ref.best_a, ref.best_w, ref.score,
        jnp.asarray(Q), jnp.asarray(Tc), qoff_params=(pad2, W, Q.shape[1]),
        qoff_knots=jnp.asarray(knots),
    )
    tw = ttb.walk_arrows_device(
        got.arrows, torch.from_numpy(qoff_shared), got.best_a, got.best_w, got.score,
        qoff_params=(pad2, W, Q.shape[1]), qoff_knots=tk,
    )
    for f in jw._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jw, f)), getattr(tw, f).numpy(), f)


def test_knot_walk_matches_jax_on_a_shared_line():
    """tests/test_guided.py:158's shape: knots that replicate the shared
    line walk like the table walk, in both packages."""
    rng = np.random.default_rng(77)
    I, L, W, pad2 = 4, 256, 64, 64
    T = L + 2 * pad2
    S = L + T - 1
    Q = np.zeros((I, L), np.uint8)
    Tc = np.full((I, T), 5, np.uint8)
    for i in range(I):
        tpl = rng.integers(0, 4, L).astype(np.uint8)
        Tc[i, pad2 : pad2 + L] = tpl
        Tc[i, :pad2] = rng.integers(0, 4, pad2)
        Tc[i, pad2 + L :] = rng.integers(0, 4, pad2)
        mut = rng.random(L) < 0.08
        Q[i] = np.where(mut, (tpl + 1) % 4, tpl)
    a_anchor = np.stack([np.arange(0, S, 97, dtype=np.int32)] * I)
    v_anchor = ((a_anchor - pad2) // 2 - W // 2).astype(np.int32)
    ones = np.ones_like(a_anchor, bool)
    tk = tba.make_qoff_knots(torch.from_numpy(a_anchor), torch.from_numpy(v_anchor),
                             torch.from_numpy(ones), S, L, W, diag=pad2, num=jba.QOFF_NUM_HALF)
    jk = jba.make_qoff_knots(jnp.asarray(a_anchor), jnp.asarray(v_anchor), jnp.asarray(ones),
                             S, L, W, diag=pad2, num=jba.QOFF_NUM_HALF)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    args = [torch.from_numpy(a) for a in (Q, np.full(I, L, np.int32), Tc,
                                          np.zeros(I, np.int32), np.full(I, T, np.int32))]
    res = dp_wrapper(*args, None, knots=tk, with_traceback=True, band_width=W)
    q0 = tba.qoff_from_knots(tk, S)[:, 0].contiguous()
    jres = jba.banded_align(*(jnp.asarray(a.numpy()) for a in args),
                            jba.qoff_from_knots(jk, S), with_traceback=True, band_width=W)
    jw = jtb.walk_arrows_device(jres.arrows, jnp.asarray(q0.numpy()), jres.best_a, jres.best_w,
                                jres.score, jnp.asarray(Q), jnp.asarray(Tc), qoff_knots=jk)
    by_knots = ttb.walk_arrows_device(res.arrows, q0, res.best_a, res.best_w, res.score,
                                      qoff_knots=tk)
    by_table = ttb.walk_arrows_device(res.arrows, q0, res.best_a, res.best_w, res.score)
    for f in jw._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jw, f)), getattr(by_knots, f).numpy(), f)
        assert torch.equal(getattr(by_knots, f), getattr(by_table, f)), f


PARAMS = dict(
    batch_size=8, max_read_len=512, n_candidates=4, n_dp_candidates=2,
    anchor_stride=4, max_anchors_per_read=128, narrow_band=32,
    narrow_band_max=256, min_match_length=10, direct_lut=True,
    emit_moves=False, best_n=1, guided_band=True,
)


@pytest.fixture(scope="module")
def corpus():
    """A 60 kb two-contig genome and 16 noisy reads: 8 of 150-250 bp (the
    256 bucket, guided at W=32) and 8 of 300-480 bp (the 512 bucket, above
    narrow_band_max: guided at the base band 128); every fourth read with
    an insertion burst, every third reverse complemented."""
    rng = np.random.default_rng(23)
    G = 60_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    starts = np.array([0, 35_000, G], np.int64)
    jidx = jax_build_index(genome, JSeqDB(["chrA", "chrB"], starts, ["0" * 32] * 2), k=10)
    tidx = build_index_from_arrays(genome, SeqDB(["chrA", "chrB"], starts, ["0" * 32] * 2), k=10)
    reads = []
    for i in range(16):
        lo, hi = (150, 230) if i < 8 else (300, 440)
        start = int(rng.integers(0, G - hi - 50))
        r = mutate_read(rng, genome, start, int(rng.integers(lo, hi)), sub=0.02, ins=0.06, dele=0.03)
        if i % 4 == 3:
            mid = len(r) // 2
            r = np.concatenate([r[:mid], rng.integers(0, 4, 36).astype(np.uint8), r[mid:]])
        if i % 3 == 0:
            r = r[::-1].copy()
            r = np.where(r < 4, 3 - r, r).astype(np.uint8)
        reads.append((f"sim/{i}", r))
    return jidx, tidx, reads


def test_map_batch_wire_bytes_guided_equal_jax(corpus, monkeypatch):
    jidx, tidx, raw = corpus
    jm = jmap.Mapper(jidx, JParams(**PARAMS))
    tm = tmap.Mapper(tidx, MappingParams(**PARAMS), device="cpu")
    knot_widths = []

    def spy(*args, **kw):
        knot_widths.append(args[5])                # W
        return tba.make_qoff_knots(*args, **kw)

    monkeypatch.setattr(tmap, "make_qoff_knots", spy)
    jb = list(jax_batch_reads([JRead(n, c, None, i) for i, (n, c) in enumerate(raw)], 8, 512))
    tb = list(batch_reads([Read(n, c, None, i) for i, (n, c) in enumerate(raw)], 8, 512))
    assert len(jb) == len(tb) >= 2
    for j, t in zip(jb, tb):
        jr = jm.map_batch(j.codes, j.lengths)
        tr = tm.map_batch(t.codes, t.lengths)
        assert (jr.i2, jr.p, jr.b, jr.rcols) == (tr.i2, tr.p, tr.b, tr.rcols)
        np.testing.assert_array_equal(np.asarray(jr.wire), tr.wire.numpy())
    assert sorted(set(knot_widths)) == [32, 128]     # guided at both bucket kinds


def test_run_mapping_guided_m4_equals_jax_with_escalation(corpus):
    jidx, tidx, raw = corpus
    jrec, junm = jax_run_mapping(jidx, [JRead(n, c, None, i) for i, (n, c) in enumerate(raw)],
                                 JParams(**PARAMS))
    met = MappingMetrics()
    params = MappingParams(**PARAMS)
    trec, tunm = run_mapping(tidx, [Read(n, c, None, i) for i, (n, c) in enumerate(raw)],
                             params, device="cpu", metrics=met)
    assert [format_m4(r) for r in trec] == [jax_format_m4(r) for r in jrec]
    assert tunm == junm
    assert len(trec) >= 12
    assert met.escalated_reads > 0            # the unguided wide-band retry ran

