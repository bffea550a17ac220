"""The port's copies of XLA's float32 order and functions against the
JAX package's, as ``jax.jit`` compiles them on the CPU: the ordered sum of
the candidate and slope-fit weights, and MAPQ's exp, log1p, log10 and
pow(10, x) and the mapping quality built from them, bit for bit."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasr_tpu.ops import mapqv as jmq
from blasr_tpu_torch.ops import mapqv as tmq
from blasr_tpu_torch.ops import xla_math
from blasr_tpu_torch.ops.candidates import ordered_sum

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [33, 48, 64, 100, 500, 512, 1100, 2000])
def test_ordered_sum_matches_jitted_jnp_sum(n):
    """Rows of float32 values over 16 binades: XLA's 32-wide windows with
    the padding split over both ends, at lengths on and off multiples of
    32 (CPU float order)."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((1000, n)) * np.exp(rng.uniform(-8, 8, (1000, n)))).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: jnp.sum(v, axis=-1))(jnp.asarray(x)))
    got = ordered_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ref.view(np.uint32), got.view(np.uint32))


def _mapq_inputs(name, n=150_000):
    """float32 inputs over each function's range in MAPQ and beyond: the
    log10-sum's exp((mn - mx) ln 10) and log1p of it, the phred's log10 of
    1 - 10^x and pow(10, x) of x = prob - denom."""
    rng = np.random.default_rng(len(name))
    if name == "exp":
        parts = [rng.uniform(-90, 0, n), rng.uniform(-40, 40, n // 4),
                 -np.exp(rng.uniform(-30, 4, n // 4))]
    elif name == "log1p":
        parts = [rng.uniform(0, 1, n), np.exp(rng.uniform(-40, 0, n // 2)),
                 rng.uniform(-0.9, 5, n // 4)]
    elif name == "log10":
        parts = [np.exp(rng.uniform(-69, 0, n)), rng.uniform(0, 1, n // 2),
                 np.exp(rng.uniform(0, 40, n // 4))]
    else:
        parts = [rng.uniform(-20, 0.5, n), rng.uniform(-50, 40, n // 4),
                 -np.exp(rng.uniform(-30, 3, n // 4)), np.arange(-40, 5) / 2]
    return np.concatenate(parts).astype(np.float32)


MAPQ_FUNCTIONS = {
    "exp": (jnp.exp, xla_math.xla_exp),
    "log1p": (jnp.log1p, xla_math.xla_log1p),
    "log10": (jnp.log10, lambda x: xla_math.xla_log(x) * xla_math.INV_LN10),
    "pow10": (lambda v: jnp.power(jnp.float32(10.0), v), xla_math.pow10),
}


@pytest.mark.parametrize("name", sorted(MAPQ_FUNCTIONS))
def test_mapq_transcendental_matches_jitted_xla(name):
    """At least 10^5 float32 inputs each: the port's function gives the bits
    of the jitted JAX function on the CPU (subnormal results flushed, as
    XLA's runtime does)."""
    jf, tf = MAPQ_FUNCTIONS[name]
    x = _mapq_inputs(name)
    assert x.size >= 100_000
    ref = np.asarray(jax.jit(jf)(jnp.asarray(x)))
    got = tf(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ref.view(np.uint32), got.view(np.uint32))


def test_log10_sum_is_one_multiply_add():
    """MAPQ's running denominator mx + log1p(exp((mn - mx) ln 10)) / ln 10:
    XLA multiplies by the float32 reciprocal and fuses that multiply into
    the add; the port's ``fma_f32`` gives its bits, a true division does
    not."""
    rng = np.random.default_rng(5)
    n = 200_000
    a = (-rng.integers(0, 3000, n) / 10).astype(np.float32)
    b = a - rng.exponential(3.0, n).astype(np.float32)

    def jf(a, b):
        mx, mn = jnp.maximum(a, b), jnp.minimum(a, b)
        return mx + jnp.log1p(jnp.exp((mn - mx) * tmq.LOG10)) / tmq.LOG10

    ref = np.asarray(jax.jit(jf)(a, b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    mx, mn = torch.maximum(ta, tb), torch.minimum(ta, tb)
    lp = xla_math.xla_log1p(xla_math.xla_exp((mn - mx) * tmq.LOG10))
    got = xla_math.fma_f32(lp, tmq.INV_LOG10, mx).numpy()
    np.testing.assert_array_equal(ref.view(np.uint32), got.view(np.uint32))
    divided = (mx + lp / torch.full_like(lp, tmq.LOG10)).numpy()
    assert (divided.view(np.uint32) != ref.view(np.uint32)).any()


def test_fma64_rounds_once():
    """The float64 multiply-add of ``pow10`` against exact rationals, on
    random triples and on products whose exact sum sits a hair off a
    float64 midpoint."""
    rng = np.random.default_rng(9)
    n = 3000
    a = rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
    b = rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
    c = rng.standard_normal(n) * 2.0 ** rng.integers(-80, 30, n)
    # (1 + 2^-26)(1 + 2^-27) = 1 + 2^-26 + 2^-27 + 2^-53: a float64
    # midpoint, moved by c; rounding the product first loses c
    a = np.concatenate([a, [1 + 2.0**-26] * 3])
    b = np.concatenate([b, [1 + 2.0**-27, 1 + 2.0**-27, -1 - 2.0**-27]])
    c = np.concatenate([c, [2.0**-120, -2.0**-120, -2.0**-120]])
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                     for x, y, z in zip(a, b, c)])
    got = xla_math._fma64(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(want, got)
    assert got[n] == 1 + 2.0**-26 + 2.0**-27 + 2.0**-52
    assert got[n + 1] == 1 + 2.0**-26 + 2.0**-27


def _near_integer_sweep(CD=6):
    """Rows whose float mapping quality lies within 4 float32 ulps of an
    integer, where the last bits decide the truncated integer. Six
    overlapping candidates with equal match counts share one partition and
    one log10-sum; with unit costs candidate j's log-probability is
    -n_j / 10. A float64 search over the count gaps finds the rows whose
    exact quality lies within 10^-4 of an integer; each is shifted by 100
    common offsets, which move the float32 roundings, and the port's float
    quality keeps the shifted rows within 4 ulps."""
    rng = np.random.default_rng(1)
    gaps = np.sort(rng.integers(0, 60, (2_000_000, CD)), axis=1)
    p = -gaps / 10.0
    sub = p - np.log10(np.sum(10.0**p, axis=1, keepdims=True))
    q = -10 * np.log10(-np.expm1(sub * np.log(10)))
    close = (np.abs(q - np.round(q)) < 1e-4) & (q > 0.5) & (q < 200)
    gaps = gaps[close.any(axis=1)]
    n_err = (gaps[:, None, :] + np.arange(0, 400, 4)[None, :, None]).reshape(-1, CD)
    B = len(n_err)
    zeros = np.zeros((B, CD), np.int32)
    args = ((-4000 + 5 * n_err).astype(np.int32), np.ones((B, CD), bool), zeros,
            np.full((B, CD), 900, np.int32), np.full((B, CD), 800, np.int32), zeros,
            n_err.astype(np.int32), zeros)
    qf = tmq.map_qv_float(*(torch.from_numpy(a) for a in args), **UNIT_COSTS).numpy()
    near = (np.abs(qf - np.round(qf)) <= 4 * np.spacing(np.abs(qf))) & (qf > 0.5) & (qf < 253.5)
    keep = near.any(axis=1)
    return tuple(a[keep] for a in args), qf[keep]


UNIT_COSTS = dict(mismatch_prob=1, ins_cost=1, del_cost=1)


def test_map_qv_reference_near_integer_sweep():
    """The mapping quality of rows built to land within a few ulps of an
    integer, above and below it: equal to the jitted JAX function's,
    integer for integer (PyTorch's own exp, log1p, log10 and pow and a
    true division by 10 and by ln 10 differ on a few percent of them)."""
    args, qf = _near_integer_sweep()
    assert len(qf) >= 200
    below = (qf < np.round(qf)) & (np.round(qf) - qf <= 4 * np.spacing(np.abs(qf)))
    assert below.sum() >= 50
    ref = np.asarray(jmq.map_qv_reference(*(jnp.asarray(a) for a in args), **UNIT_COSTS))
    got = tmq.map_qv_reference(*(torch.from_numpy(a) for a in args), **UNIT_COSTS).numpy()
    np.testing.assert_array_equal(ref, got)
