"""``-scoreMatrix`` in the port against the JAX package, exact (tolerance
0: every output is an integer).

  * ``matrix_sub`` on every code pair, out-of-range codes included;
  * the plain DP and the walk with the matrices of ``tests/test_banded.py``
    (free A<->C substitutions, :250; a negative off-diagonal that lets a
    local alignment start on a mismatch, :298), without and with quality
    values, against the XLA oracle and ``walk_arrows_device``;
  * the map_batch wire with a matrix equal to the default scores is the
    wire without one;
  * run_mapping -m 4 lines with a ``-scoreMatrix`` parsed by each
    package's CLI parser.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasr_tpu.cli.blasr import build_arg_parser as jax_arg_parser
from blasr_tpu.cli.blasr import params_from_args as jax_params_from_args
from blasr_tpu.index.artifacts import build_index_from_arrays as jax_build_index
from blasr_tpu.io.batching import Read as JRead
from blasr_tpu.io.seqdb import SeqDB as JSeqDB
from blasr_tpu.ops import banded_align as jba
from blasr_tpu.ops import traceback_device as jtb
from blasr_tpu.output.m4 import format_m4 as jax_format_m4
from blasr_tpu.pipeline.runner import run_mapping as jax_run_mapping
from blasr_tpu_torch.cli.blasr import build_parser, params_from_args
from blasr_tpu_torch.index.artifacts import build_index_from_arrays
from blasr_tpu_torch.io.batching import Read, batch_reads
from blasr_tpu_torch.io.seqdb import SeqDB
from blasr_tpu_torch.ops import banded_align as tba
from blasr_tpu_torch.ops import traceback_device as ttb
from blasr_tpu_torch.ops.banded_cuda import banded_align as dp_wrapper
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.pipeline import mapper as tmap
from blasr_tpu_torch.pipeline.runner import run_mapping

from conftest import mutate_read

# The suite runs in parallel worker processes: one intra-op thread each
# keeps PyTorch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

# tests/test_banded.py:250: q=A against t=C and q=C against t=A are free
FREE_AC = tuple(
    -5 if (i == j and i < 4) or (i, j) in ((0, 1), (1, 0))
    else (0 if i >= 4 or j >= 4 else 6)
    for i in range(5) for j in range(5)
)
# tests/test_banded.py:298: A<->C scores -2, a negative off-diagonal
NEG_OFFDIAG = (
    -5, -2, 6, 6, 0,
    -2, -5, 6, 6, 0,
    6, 6, -5, 6, 0,
    6, 6, 6, -5, 0,
    0, 0, 0, 0, 0,
)
# the default scores as a matrix: match -5, mismatch 6, N 0
DEFAULT_EQUIV = tuple(
    0 if i == 4 or j == 4 else (-5 if i == j else 6) for i in range(5) for j in range(5)
)


def test_matrix_sub_matches_jax():
    q, t = np.meshgrid(np.arange(-3, 9, dtype=np.int8), np.arange(-3, 9, dtype=np.int8))
    for mat in (FREE_AC, NEG_OFFDIAG, tuple(range(25))):
        ref = jba.matrix_sub(jnp.asarray(q), jnp.asarray(t), mat)
        got = tba.matrix_sub(torch.from_numpy(q), torch.from_numpy(t), mat)
        np.testing.assert_array_equal(np.asarray(ref).astype(np.int32), got.numpy())


def _matrix_problem(mat):
    """tests/test_banded.py's reads for each matrix: A->C-mutated copies of
    the target (FREE_AC), or 100 bp islands with 15% substitutions in a
    random target, where alignments can start on a mismatch (NEG_OFFDIAG).
    Item 1 lies near contig ends (tlo > 0, thi < T)."""
    rng = np.random.default_rng(3 if mat is FREE_AC else 31)
    I, L, T = (4, 160, 220) if mat is FREE_AC else (6, 120, 180)
    Q = rng.integers(0, 4, (I, L)).astype(np.uint8)
    Tc = rng.integers(0, 4, (I, T)).astype(np.uint8)
    if mat is FREE_AC:
        Tc[:, 20 : 20 + L] = Q
        Q[Q == 0] = 1
    else:
        for i in range(I):
            c = Q[i, :100].copy()
            mut = rng.random(100) < 0.15
            c[mut] = (c[mut] + rng.integers(1, 4, 100)[mut]) % 4
            Tc[i, 30:130] = c
    tlo = np.zeros(I, np.int32)
    thi = np.full(I, T, np.int32)
    tlo[1], thi[1] = 25, T - 40
    return Q, np.full(I, L, np.int32), Tc, tlo, thi


@pytest.mark.parametrize("W", [32, 128])
@pytest.mark.parametrize("name,qual", [("free_ac", False), ("neg_offdiag", False),
                                       ("neg_offdiag", True)])
def test_matrix_dp_and_walk_match_jax(name, qual, W):
    mat = FREE_AC if name == "free_ac" else NEG_OFFDIAG
    Q, qlen, Tc, tlo, thi = _matrix_problem(mat)
    L, T = Q.shape[1], Tc.shape[1]
    qv = np.random.default_rng(8).integers(0, 50, Q.shape).astype(np.uint8) if qual else None
    qoff = np.array(jba.make_qoff(L, T, W, (T - L) // 2))
    ref = jba.banded_align(
        *(jnp.asarray(a) for a in (Q, qlen, Tc, tlo, thi, qoff)),
        None if qv is None else jnp.asarray(qv),
        scores=jba.AlignScores(matrix=mat), with_traceback=True, band_width=W,
    )
    args = [torch.from_numpy(a) for a in (Q, qlen, Tc, tlo, thi, qoff)]
    tq = None if qv is None else torch.from_numpy(qv)
    got = dp_wrapper(*args, tq, scores=tba.AlignScores(matrix=mat),
                     with_traceback=True, band_width=W)
    for f in ("score", "best_a", "best_w"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), getattr(got, f).numpy(), f)
    np.testing.assert_array_equal(
        np.asarray(ref.arrows), got.arrows.view(torch.int16).numpy().view(np.uint16))
    if mat is FREE_AC and W == 128:
        # every base scores -5: a match or a free A<->C substitution
        assert (got.score.numpy()[[0, 2, 3]] == -5 * L).all()
    # the matrix changes the result
    assert not torch.equal(tba.banded_align_plain(*args, tq, band_width=W).score, got.score)

    jw = jtb.walk_arrows_device(
        ref.arrows, jnp.asarray(qoff), ref.best_a, ref.best_w, jnp.minimum(ref.score, -1),
        jnp.asarray(Q), jnp.asarray(Tc),
    )
    tw = ttb.walk_arrows_device(got.arrows, args[5], got.best_a, got.best_w,
                                torch.clamp(got.score, max=-1))
    for f in jw._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jw, f)), getattr(tw, f).numpy(), f)
    if mat is NEG_OFFDIAG:
        # alignments that start on a mismatch: the tallies match the path
        ops_total = tw.n_match + tw.n_mismatch + tw.n_ins + tw.n_del
        assert torch.equal(ops_total, tw.nops)
        assert int(tw.n_mismatch.sum()) > 0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 40 kb genome and 10 noisy reads of 200-450 bp as FASTA."""
    rng = np.random.default_rng(41)
    G = 40_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    starts = np.array([0, G], np.int64)
    jidx = jax_build_index(genome, JSeqDB(["ref"], starts, ["0" * 32]), k=10)
    tidx = build_index_from_arrays(genome, SeqDB(["ref"], starts, ["0" * 32]), k=10)
    reads = []
    for i in range(10):
        start = int(rng.integers(0, G - 500))
        r = mutate_read(rng, genome, start, int(rng.integers(200, 450)),
                        sub=0.04, ins=0.05, dele=0.03)
        reads.append((f"sim/{i}", r))
    return jidx, tidx, reads


CLI = ["-minMatch", "10", "-batchSize", "8", "-maxReadLen", "512", "-nCandidates", "4",
       "-dpCandidates", "2", "-anchorStride", "4", "-bandSize", "16"]


def _params(parser, from_args, mat):
    argv = ["r.fa", "g.fa", *CLI]
    if mat is not None:
        argv += ["-scoreMatrix", " ".join(map(str, mat))]
    return from_args(parser.parse_args(argv))


def test_default_equivalent_matrix_gives_the_same_wire(corpus):
    _, tidx, raw = corpus
    base = _params(build_parser(), params_from_args, None)
    with_mat = _params(build_parser(), params_from_args, DEFAULT_EQUIV)
    assert with_mat.score_matrix == DEFAULT_EQUIV and base.score_matrix is None
    plain = tmap.Mapper(tidx, base, device="cpu")
    mapped = tmap.Mapper(tidx, with_mat, device="cpu")
    b = next(iter(batch_reads([Read(n, c, None, i) for i, (n, c) in enumerate(raw)], 8, 512)))
    assert torch.equal(plain.map_batch(b.codes, b.lengths).wire,
                       mapped.map_batch(b.codes, b.lengths).wire)


def test_score_matrix_run_mapping_m4_equals_jax(corpus):
    jidx, tidx, raw = corpus
    mat = (-5, 6, -2, 6, 0,
           6, -5, 6, -2, 0,
           -2, 6, -5, 6, 0,
           6, -2, 6, -5, 0,
           0, 0, 0, 0, 0)                   # transitions (A<->G, C<->T) at -2
    jp = _params(jax_arg_parser(), jax_params_from_args, mat)
    tp = _params(build_parser(), params_from_args, mat)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    jrec, junm = jax_run_mapping(jidx, [JRead(n, c, None, i) for i, (n, c) in enumerate(raw)], jp)
    trec, tunm = run_mapping(tidx, [Read(n, c, None, i) for i, (n, c) in enumerate(raw)], tp,
                             device="cpu")
    assert [format_m4(r) for r in trec] == [jax_format_m4(r) for r in jrec]
    assert tunm == junm and len(trec) >= 8
    base, _ = run_mapping(tidx, [Read(n, c, None, i) for i, (n, c) in enumerate(raw)],
                          dataclasses.replace(tp, score_matrix=None), device="cpu")
    assert [format_m4(r) for r in base] != [format_m4(r) for r in trec]
