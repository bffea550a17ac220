"""The port's candidate-ranking modes and the optional modes' functions
against the JAX package on the CPU, tolerance 0 (every output is integer,
or a record line).

  * ``global_chain_exact`` on random fragment sets, and
    ``chain_weight_device`` against the JAX function and against the
    oracle restricted to each window's members (tests/test_chain.py's
    inputs);
  * the plain DP's score-only ``global_q`` mode against JAX
    ``banded_align(global_q=True)`` (shared and per-item schedules, with
    and without quality values);
  * ``find_anchors_search`` against JAX ``find_anchors`` called without a
    prefix table (tests/test_anchors.py's inputs, with expand and stride);
  * the map_batch wire bytes at -pvaltype 2 and 3 and with exact_chain,
    and run_mapping's -m 4 lines in each, on the corpus of
    test_torch_modes_passes.py (-pvaltype 2/3 through the JAX mapper copy
    of ``jax_mapper_module``, which repairs its one fault);
  * ``-placeRepeatsRandomly`` at -bestn 2 on the exact repeat's reads,
    whose two records tie: the JAX runner's order for each seed."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasr_tpu.index.artifacts import build_index_from_arrays
from blasr_tpu.io.batching import batch_reads
from blasr_tpu.io.seqdb import SeqDB
from blasr_tpu.ops import anchors as janchors
from blasr_tpu.ops import banded_align as jba
from blasr_tpu.ops import candidates as jcand
from blasr_tpu.pipeline import mapper as jmap
from blasr_tpu_torch.ops import anchors as tanchors
from blasr_tpu_torch.ops import banded_align as tba
from blasr_tpu_torch.ops import candidates as tcand
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.pipeline import mapper as tmap
from blasr_tpu_torch.pipeline.runner import run_mapping

from test_torch_modes_passes import BASE, _both, corpus, jax_mapper_module  # noqa: F401

torch.set_num_threads(1)


def test_global_chain_exact_equals_jax():
    rng = np.random.default_rng(3)
    for _ in range(60):
        n = int(rng.integers(0, 14))
        q = rng.integers(0, 80, n).astype(np.int64)
        t = rng.integers(0, 80, n).astype(np.int64)
        ln = rng.integers(5, 20, n).astype(np.int64)
        assert tcand.global_chain_exact(q, t, ln) == jcand.global_chain_exact(q, t, ln)


@pytest.mark.parametrize("seed", [17, 18])
def test_chain_weight_device_equals_jax_and_the_oracle(seed):
    rng = np.random.default_rng(seed)
    B, A, C, k, win = 12, 48, 4, 14, 128
    for _ in range(3):
        t = rng.integers(0, 40_000, (B, A)).astype(np.int32)
        q = rng.integers(0, 800, (B, A)).astype(np.int32)
        for b in range(B):           # coherent clusters, so windows hold chains
            d0 = rng.integers(0, 30_000)
            sel = rng.choice(A, rng.integers(6, 20), replace=False)
            t[b, sel] = q[b, sel] + d0 + rng.integers(0, win, len(sel))
        q[:, :4] = q[:, 4:8]         # equal read positions: the rank's index ties
        valid = rng.random((B, A)) < 0.8
        dstar = np.stack([(t[b] - q[b])[rng.choice(A, C, replace=False)] for b in range(B)])
        cvalid = rng.random((B, C)) < 0.9
        want = np.asarray(jcand.chain_weight_device(
            *(jnp.asarray(a) for a in (t, q, valid, dstar, cvalid)), k=k, win=win))
        got = tcand.chain_weight_device(
            *(torch.from_numpy(a) for a in (t, q, valid, dstar, cvalid)), k=k, win=win)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        for b in range(B):
            for c in range(C):
                d = t[b] - q[b]
                m = valid[b] & (d - dstar[b, c] >= 0) & (d - dstar[b, c] < win) & cvalid[b, c]
                w, _ = tcand.global_chain_exact(q[b][m].astype(np.int64),
                                                t[b][m].astype(np.int64),
                                                np.full(int(m.sum()), k, np.int64))
                assert got[b, c] == w


@pytest.mark.parametrize("per_item,qual", [(False, False), (True, False), (False, True)],
                         ids=["shared", "per-item", "quality"])
def test_global_q_score_equals_jax(per_item, qual):
    rng = np.random.default_rng(29)
    I, L, T, W = 8, 64, 112, 32
    Q = rng.integers(0, 4, (I, L)).astype(np.uint8)
    Tc = rng.integers(0, 4, (I, T)).astype(np.uint8)
    for i in range(I - 2):       # partial copies; the last two items have none
        Tc[i, 20 : 20 + L - 10 - i] = Q[i, 5 : L - 5 - i]
    qlen = np.full(I, L, np.int32)
    qlen[2] = L - 9
    Q[2, qlen[2]:] = 4
    tlo = np.zeros(I, np.int32)
    thi = np.full(I, T, np.int32)
    thi[3] = T - 25
    qoff = np.array(jba.make_qoff(L, T, W, (T - L) // 2))
    if per_item:
        qoff = np.repeat(qoff[:, None], I, axis=1)
    qv = rng.integers(3, 40, (I, L)).astype(np.uint8) if qual else None
    sc = jba.AlignScores(affine_open=10, affine_extend=2)
    ref = jba.banded_align(
        *(jnp.asarray(a) for a in (Q, qlen, Tc, tlo, thi, qoff)),
        None if qv is None else jnp.asarray(qv),
        scores=sc, band_width=W, global_q=True)
    got = tba.banded_align_plain(
        *(torch.from_numpy(np.array(a)) for a in (Q, qlen, Tc, tlo, thi, qoff)),
        None if qv is None else torch.from_numpy(qv),
        scores=tba.AlignScores(affine_open=10, affine_extend=2), band_width=W,
        global_q=True)
    for a, b in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    local = tba.banded_align_plain(
        *(torch.from_numpy(np.array(a)) for a in (Q, qlen, Tc, tlo, thi, qoff)),
        None if qv is None else torch.from_numpy(qv),
        scores=tba.AlignScores(affine_open=10, affine_extend=2), band_width=W)
    # every query base consumed: never better than the local score, worse
    # where the copy is partial
    assert (got.score >= local.score).all() and (got.score > local.score).any()
    assert got.arrows is None
    with pytest.raises(ValueError, match="score-only"):
        tba.banded_align_plain(
            *(torch.from_numpy(np.array(a)) for a in (Q, qlen, Tc, tlo, thi, qoff)),
            band_width=W, global_q=True, with_traceback=True)


def _anchor_inputs(kind):
    """tests/test_anchors.py's problems: an exact read slice of a 5 kb
    random genome (k 8, with a padding row), and a read of a block repeated
    three times (k 10)."""
    rng = np.random.default_rng(0)
    if kind == "exact":
        genome = rng.integers(0, 4, size=5000).astype(np.uint8)
        codes = np.full((2, 256), 4, dtype=np.uint8)
        codes[0, :200] = genome[1234 : 1234 + 200]
        lengths = np.array([200, 0], dtype=np.int32)
        k = 8
    else:
        block = rng.integers(0, 4, size=100).astype(np.uint8)
        unique = rng.integers(0, 4, size=3000).astype(np.uint8)
        genome = np.concatenate([block, unique[:1000], block, unique[1000:2000], block])
        codes = np.full((1, 128), 4, dtype=np.uint8)
        codes[0, :60] = block[:60]
        lengths = np.array([60], dtype=np.int32)
        k = 10
    seqdb = SeqDB(["chr"], np.array([0, len(genome)], dtype=np.int64), ["0" * 32])
    return build_index_from_arrays(genome, seqdb, k), codes, lengths, k


@pytest.mark.parametrize("kind", ["exact", "repeat"])
@pytest.mark.parametrize("stride,expand", [(1, 0), (2, 1)])
def test_find_anchors_search_equals_jax(kind, stride, expand):
    idx, codes, lengths, k = _anchor_inputs(kind)
    kw = dict(k=k, max_hits_per_pos=8, max_anchors_per_read=512, anchor_stride=stride,
              expand=expand)
    want = janchors.find_anchors(
        jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(idx.sa),
        jnp.asarray(idx.sa_kmers), jnp.asarray(idx.pos_ok), **kw)
    got = tanchors.find_anchors_search(
        torch.from_numpy(codes), torch.from_numpy(lengths),
        torch.from_numpy(idx.sa.astype(np.int32)), torch.from_numpy(idx.sa_kmers),
        torch.from_numpy(idx.pos_ok), **kw)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert got[3].any()


MODES = {"pvaltype2": dict(pval_type=2), "pvaltype3": dict(pval_type=3),
         "exact_chain": dict(exact_chain=True)}


@pytest.mark.parametrize("mode", list(MODES))
def test_ranking_modes_wire_bytes_equal_jax(corpus, mode):  # noqa: F811
    index, reads = corpus
    params = dataclasses.replace(BASE, **MODES[mode])
    jm = (jax_mapper_module() if params.pval_type in (2, 3) else jmap).Mapper(index, params)
    tm = tmap.Mapper(index, params, device="cpu")
    n = 0
    for b in batch_reads(reads, params.batch_size, params.max_read_len):
        jr = jm.map_batch(b.codes, b.lengths)
        tr = tm.map_batch(b.codes, b.lengths)
        np.testing.assert_array_equal(np.asarray(jr.wire), tr.wire.numpy())
        n += 1
    assert n == 3


@pytest.mark.parametrize("mode", list(MODES))
def test_ranking_modes_lines_equal_jax(corpus, mode):  # noqa: F811
    index, reads = corpus
    jl, ju, tl, tu, _ = _both(index, reads, dataclasses.replace(BASE, **MODES[mode]))
    assert tl == jl and tu == ju
    assert len(tl) >= 14


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_place_repeats_randomly_equals_jax(corpus, seed):  # noqa: F811
    """-bestn 2 on two reads of the exact repeat and two plain reads: the
    repeat reads' two records tie, and the random draws order them as the
    JAX runner's do."""
    index, reads = corpus
    sub = [r for r in reads if r.name.startswith("repeat/")][:2] + reads[:2]
    params = dataclasses.replace(BASE, best_n=2, emit_moves=True,
                                 place_repeats_randomly=True, random_seed=seed)
    jl, ju, tl, tu, _ = _both(index, sub, params)
    assert tl == jl and tu == ju
    by_read: dict = {}
    for ln in tl:
        by_read.setdefault(ln.split()[0], []).append(ln.split()[2])
    assert any(len(s) == 2 and s[0] == s[1] for s in by_read.values())   # a tie


def test_place_repeats_randomly_moves_a_tie(corpus):  # noqa: F811
    """Some seed puts a tied pair in the other order than the stable sort,
    and every seed prints the same lines."""
    index, reads = corpus
    sub = [r for r in reads if r.name.startswith("repeat/")][:2]
    params = dataclasses.replace(BASE, best_n=2, emit_moves=True)
    plain = [format_m4(r) for r in run_mapping(index, sub, params, device="cpu")[0]]
    orders = {tuple(format_m4(r) for r in run_mapping(
        index, sub, dataclasses.replace(params, place_repeats_randomly=True, random_seed=s),
        device="cpu")[0]) for s in range(1, 5)}
    assert any(list(o) != plain for o in orders)
    assert all(sorted(o) == sorted(plain) for o in orders)
