"""The port's anchoring, candidate selection, chain evidence, MAPQ and
strand expansion against the JAX package (integers bit for bit, float
weights exactly equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasr_tpu.index.artifacts import build_index_from_arrays
from blasr_tpu.io.seqdb import SeqDB
from blasr_tpu.ops import anchors as janc
from blasr_tpu.ops import candidates as jcand
from blasr_tpu.ops import mapqv as jmq
from blasr_tpu.params import MappingParams
from blasr_tpu.pipeline import mapper as jmap
from blasr_tpu_torch.interop import device_index_from_numpy
from blasr_tpu_torch.ops import anchors as tanc
from blasr_tpu_torch.ops import candidates as tcand
from blasr_tpu_torch.ops import mapqv as tmq
from blasr_tpu_torch.ops import xla_math
from blasr_tpu_torch.pipeline import mapper as tmap

from conftest import mutate_read

# The suite runs in parallel worker processes: one intra-op thread each
# keeps PyTorch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

K = 10


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    G = 60_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[30_000:31_500] = genome[5_000:6_500]            # a repeat
    seqdb = SeqDB(["ref"], np.array([0, G], np.int64), ["0" * 32])
    index = build_index_from_arrays(genome, seqdb, k=K)
    params = MappingParams(max_read_len=1024, min_match_length=K, direct_lut=True)
    jdi = jmap.make_device_index(index, params)
    tdi = device_index_from_numpy(
        np.asarray(jdi.genome_pad), tuple(np.asarray(a) for a in jdi.arrays),
        np.asarray(jdi.starts), pad=jdi.pad, k=jdi.k, genome_len=jdi.genome_len,
        lut_meta=jdi.lut_meta,
    )
    B, L = 6, 1024
    codes = np.full((B, L), 4, np.uint8)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        start = int(rng.integers(0, G - 1100))
        if b == 0:
            start = 5_100  # inside the repeat
        r = mutate_read(rng, genome, start, int(rng.integers(300, 900)))[:L]
        codes[b, : len(r)] = r
        lengths[b] = len(r)
    return jdi, tdi, codes, lengths


def _anchors(jdi, tdi, codes, lengths, stride, expand):
    sa_valid, ctab16, lut_full, lut_valid = jdi.arrays
    kw = dict(k=K, max_hits_per_pos=8, max_anchors_per_read=128,
              lut_meta=jdi.lut_meta, anchor_stride=stride, expand=expand)
    ref = janc.find_anchors(
        jnp.asarray(codes), jnp.asarray(lengths), sa_valid, None, None,
        lut_full, None, lut_valid, ctab16, **kw,
    )
    tsa, tct, tlf, tlv = tdi.arrays
    got = tanc.find_anchors(
        torch.from_numpy(codes), torch.from_numpy(lengths), tsa, tlf, tlv, tct, **kw,
    )
    return [np.array(x) for x in ref], [x.numpy() for x in got]


# (read length cap, stride, expand): strided lengths 1024 > 512 take JAX's
# sorted selection, <= 512 its pairwise form; expand 1 the lut_full lookup
@pytest.mark.parametrize("L,stride,expand", [
    (1024, 1, 0), (1024, 4, 0), (512, 1, 0), (1024, 2, 1),
])
def test_find_anchors_matches_jax(setup, L, stride, expand):
    jdi, tdi, codes, lengths = setup
    c = np.ascontiguousarray(codes[:, :L])
    ln = np.minimum(lengths, L).astype(np.int32)
    (rt, rq, rn, rv), (gt, gq, gn, gv) = _anchors(jdi, tdi, c, ln, stride, expand)
    np.testing.assert_array_equal(rv, gv)
    assert rv.sum() > 100
    if -(-L // stride) > 512:
        # the same (sorted) selection on both sides: every slot equal
        for a, b in ((rt, gt), (rq, gq), (rn, gn)):
            np.testing.assert_array_equal(a, b)
    else:
        # the pairwise form fills unused slots differently; anchors equal
        for a, b in ((rt, gt), (rq, gq), (rn, gn)):
            np.testing.assert_array_equal(a[rv], b[gv])


def test_pack_query_kmers_matches_jax(setup):
    _, _, codes, lengths = setup
    for st in (1, 3, 4):
        ref = np.asarray(janc.pack_query_kmers(jnp.asarray(codes), jnp.asarray(lengths), K, st))
        got = tanc.pack_query_kmers(torch.from_numpy(codes), torch.from_numpy(lengths), K, st)
        np.testing.assert_array_equal(ref, got.numpy())


def test_candidates_chain_stats_match_jax(setup):
    jdi, tdi, codes, lengths = setup
    (at, aq, anh, av), _ = _anchors(jdi, tdi, codes, lengths, 4, 0)
    G = jdi.genome_len
    jw = jcand.anchor_weights(jnp.asarray(anh), jnp.asarray(av), G, 128, 0)
    tw = tcand.anchor_weights(torch.from_numpy(anh), torch.from_numpy(av), G, 128, 0)
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    jc = jcand.select_candidates(jnp.asarray(at), jnp.asarray(aq), jw, jnp.asarray(av),
                                 n_candidates=4, win=128, k=K)
    ta = [torch.from_numpy(x) for x in (at, aq)]
    tc = tcand.select_candidates(ta[0], ta[1], tw, torch.from_numpy(av),
                                 n_candidates=4, win=128, k=K)
    for f in jc._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)), getattr(tc, f).numpy(), f)
    assert np.asarray(jc.valid).sum() >= 6
    jr = jcand.chain_stats(jnp.asarray(at), jnp.asarray(aq), jnp.asarray(av), jc.dstar, jc.valid, k=K, win=128)
    tr = tcand.chain_stats(ta[0], ta[1], torch.from_numpy(av), tc.dstar, tc.valid, k=K, win=128)
    for a, b in zip(jr[:3], tr[:3]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jr[3], tr[3]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize(
    "G,win", [(4_600_000, 128), (60_000, 128), (100_000, 96), (3_000_000_000, 333)]
)
def test_anchor_weights_match_the_jitted_jax_function(G, win):
    """Every hit count 0-100,000 at the bench genome's size and others: the
    weights equal the JAX function's under jax.jit, as the JAX mapper runs
    it (XLA's folded constants and its CPU log), bit for bit."""
    nh = np.arange(0, 100_001, dtype=np.int32)
    valid = np.ones(nh.shape, bool)
    valid[::7] = False
    ref = jax.jit(jcand.anchor_weights, static_argnums=(2, 3, 4))(
        jnp.asarray(nh), jnp.asarray(valid), G, win, 0)
    got = tcand.anchor_weights(torch.from_numpy(nh), torch.from_numpy(valid), G, win, 0)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_xla_log_matches_xla_cpu_log():
    """Random positive float32 values over 40 binades and every power of
    two near them: bit-equal to jnp.log under jax.jit on the CPU."""
    rng = np.random.default_rng(3)
    x = np.exp(rng.uniform(-14, 14, 200_000)).astype(np.float32)
    x = np.concatenate([x, np.float32(2.0) ** np.arange(-20, 21, dtype=np.float32)])
    ref = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    np.testing.assert_array_equal(ref, xla_math.xla_log(torch.from_numpy(x)).numpy())


def _fma_exact(a, b, c):
    """float32 a * b + c rounded once to nearest even, from exact rationals."""
    from fractions import Fraction

    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    key = [(abs(Fraction(float(v)) - x), int(np.array(v).view(np.int32)) & 1) for v in cands]
    return cands[min(range(3), key=lambda i: key[i])]


def test_fma_rounds_once():
    """``fma_f32`` against the exactly rounded a * b + c: on random float32
    triples and on sums whose float64 rounding lands on a float32
    midpoint, where rounding twice would round to even the wrong way."""
    rng = np.random.default_rng(11)
    n = 2000
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    c = (rng.standard_normal(n) * 2.0 ** rng.integers(-60, 20, n)).astype(np.float32)
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24, a float32 midpoint; +-2^-80 is
    # below float64's half ulp there and decides the rounding
    mid = np.float32(1 + 2.0**-12)
    tiny = np.float32(2.0**-80)
    a = np.concatenate([a, [mid, mid, -mid, mid]]).astype(np.float32)
    b = np.concatenate([b, [mid, mid, mid, mid]]).astype(np.float32)
    c = np.concatenate([c, [tiny, -tiny, -tiny, np.float32(0)]]).astype(np.float32)
    want = np.array([_fma_exact(x, y, z) for x, y, z in zip(a, b, c)], np.float32)
    got = xla_math.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(want, got)
    assert got[n] == np.float32(1 + 2.0**-11 + 2.0**-23)   # rounding twice gives 1 + 2^-11
    assert got[n + 1] == np.float32(1 + 2.0**-11)
    assert got[n + 2] == -np.float32(1 + 2.0**-11 + 2.0**-23)


@pytest.mark.parametrize("CD", [2, 4, 10])
def test_map_qv_reference_matches_jax(CD):
    rng = np.random.default_rng(CD)
    B = 256
    # at the cells' CD of 10 the placements spread over 300 positions a
    # candidate, so that several partitions of a few members form
    lo = rng.integers(0, 300 if CD <= 4 else 300 * CD, (B, CD)).astype(np.int32)
    hi = lo + rng.integers(50, 900, (B, CD)).astype(np.int32)
    # near-duplicate placements so partitions and the gates engage
    lo[:, 1] = np.where(rng.random(B) < 0.6, lo[:, 0] + rng.integers(-8, 8, B), lo[:, 1])
    hi[:, 1] = np.where(rng.random(B) < 0.6, hi[:, 0] + rng.integers(-8, 8, B), hi[:, 1])
    nm = ((hi - lo) * rng.uniform(0.6, 0.95, (B, CD))).astype(np.int32)
    nx = rng.integers(0, 30, (B, CD)).astype(np.int32)
    ni = rng.integers(0, 60, (B, CD)).astype(np.int32)
    nd = rng.integers(0, 40, (B, CD)).astype(np.int32)
    sc = (-5 * nm + 6 * nx + 5 * (ni + nd)).astype(np.int32)
    sc[:, 1] = np.where(rng.random(B) < 0.3, sc[:, 0], sc[:, 1])  # score ties
    valid = (sc < 0) & (rng.random((B, CD)) < 0.9)
    args = (sc, valid, lo, hi, nm, nx, ni, nd)
    ref = np.asarray(jmq.map_qv_reference(*(jnp.asarray(a) for a in args)))
    got = tmq.map_qv_reference(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_array_equal(ref, got)
    assert len(np.unique(ref)) > 5


@pytest.mark.parametrize("L", [96, 100])
def test_revcomp_rows_matches_jax(L):
    rng = np.random.default_rng(L)
    B = 12
    codes = rng.integers(0, 5, (B, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:2] = [0, L]
    for b in range(B):
        codes[b, lengths[b]:] = 4
    ref = np.asarray(jmap._revcomp_rows(jnp.asarray(codes), jnp.asarray(lengths)))
    got = tmap._revcomp_rows(torch.from_numpy(codes), torch.from_numpy(lengths))
    np.testing.assert_array_equal(ref, got.numpy())


@pytest.mark.parametrize("vals", [
    [1.0, 2.0, 3.0, 4.0, np.nan], [0.5, np.nan, -0.25], [np.nan, np.nan],
    [0.1, 0.2, 0.30000001, 0.7, -0.01, np.nan, 0.02, 0.05],
])
def test_nanmedian_is_numpy_midpoint(vals):
    x = np.asarray(vals, np.float32)
    ref = np.asarray(jnp.nanmedian(jnp.asarray(x)))
    got = tmap._nanmedian(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ref, got)
