"""float32 transcendentals as the JAX mapper computes them on the CPU.

Under ``jax.jit`` on the CPU, XLA emits its own polynomials for ``log``,
``exp`` and ``log1p``, fuses a multiply into the add that consumes it
(x86's single-rounding multiply-add), calls the C library's ``powf`` for
``power`` and flushes subnormal results to zero. PyTorch's CPU functions
and the card's libdevice round differently in the last bit for a few to a
few tens of percent of inputs (CPU figures), and an integer taken from a
float (a mapping quality, a truncated mean) changes where the float lies
within those bits of an integer. The functions here repeat XLA's
operations as plain IEEE float32 and float64 tensor operations and bit
moves, so the CPU and the card give XLA's bits alike.

The constants and the order of operations are read from XLA's compiled
code (the LLVM IR and object code that ``--xla_dump_to`` writes for
``jax.jit(jnp.exp)`` and the others) and from the C library's ``powf``
(glibc 2.36's, from ARM's optimized-routines, in its FMA build).
"""

from __future__ import annotations

import numpy as np
import torch

from blasr_tpu_torch.ops.transfer import to_device

_f32 = np.float32
_MIN_NORMAL = float(_f32(2.0**-126))


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add. The product
    of two float32 values is exact in float64. Their sum with c is rounded
    to odd in float64: an inexact sum (its error comes from a TwoSum) whose
    last bit is even moves one step towards the exact value. Rounding to
    odd at 53 bits and then to nearest at 24 bits is the correct rounding,
    also where the float64 sum alone would land on a float32 midpoint."""
    if isinstance(a, torch.Tensor):
        a = a.double()
    if isinstance(c, torch.Tensor):
        c = c.double()
    return _round_to_odd_sum(a * b, c).float()


def _two_sum(x: torch.Tensor, y) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, e) with s = RN(x + y) and s + e = x + y exactly."""
    s = x + y
    yb = s - x
    return s, (x - (s - yb)) + (y - yb)


def _round_to_odd_sum(x: torch.Tensor, y) -> torch.Tensor:
    """x + y in float64 rounded to odd: an inexact sum whose last bit is
    even moves one step towards the exact value."""
    s, err = _two_sum(x, y)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64)


_SPLIT = 134217729.0  # 2^27 + 1: Veltkamp's split of a float64


def _two_prod(a: torch.Tensor, b) -> tuple[torch.Tensor, torch.Tensor]:
    """(p, e) with p = RN(a * b) and p + e = a * b exactly (Dekker's
    product of Veltkamp's halves)."""
    p = a * b
    ta, tb = a * _SPLIT, b * _SPLIT
    ah, bh = ta - (ta - a), tb - (tb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma64(a: torch.Tensor, b, c) -> torch.Tensor:
    """float64 a * b + c rounded once, from float64 operations alone:
    Dekker's exact product, a TwoSum with c, the two error terms added with
    rounding to odd and the last sum rounded to nearest (Boldo and
    Melquiond's emulated FMA)."""
    p, pe = _two_prod(a, b)
    th, tl = _two_sum(p, c)
    return th + _round_to_odd_sum(tl, pe)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values to zero of the same sign, as XLA's CPU
    runtime does (flush to zero, denormals are zero)."""
    return torch.where(x.abs() < _MIN_NORMAL, x * 0.0, x)


# ---- log: the Cephes polynomial of XLA's CPU backend (Eigen's plog) ----
_LOG_P = tuple(float(_f32(p)) for p in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = float(_f32(-2.12194440e-4))
_LOG_Q2 = float(_f32(0.693359375))
_SQRTHF = float(_f32(0.707106781186547524))


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive float32 ``x``, bit for bit as XLA's CPU
    backend computes it (finite positive inputs: the mapper's expected hit
    counts, a mapping quality's 1 - 10^x). torch.log and torch.log2 round
    differently in the last bit for about one input in ten."""
    p = _LOG_P
    x = torch.clamp(x, min=_MIN_NORMAL)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)   # mantissa in [0.5, 1)
    small = m < _SQRTHF
    tmp = torch.where(small, m, 0.0)
    m = m - 1.0
    e = e - small.to(torch.float32)
    m = m + tmp
    x2 = m * m
    x3 = x2 * m
    y = fma_f32(fma_f32(m, p[0], p[1]), m, p[2])
    y1 = fma_f32(fma_f32(m, p[3], p[4]), m, p[5])
    y2 = fma_f32(fma_f32(m, p[6], p[7]), m, p[8])
    y = fma_f32(fma_f32(y, x3, y1), x3, y2)
    y = fma_f32(y, x3, _LOG_Q1 * e)
    m = m - x2 * 0.5
    m = m + y
    return m + _LOG_Q2 * e


# jnp.log10(x) under jit is xla_log(x) times the float32 constant 1 / ln(10)
INV_LN10 = float(_f32(1 / np.log(10.0)))


# ---- exp: Cephes expf, as XLA's CPU backend emits it ----
_EXP_LO, _EXP_HI = float(_f32(-87.8)), float(_f32(88.8))
_LOG2E = float(_f32(1.44269504088896341))
_EXP_C1, _EXP_C2 = float(_f32(0.693359375)), float(_f32(-2.12194440e-4))
_EXP_P = tuple(float(_f32(p)) for p in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0e-1))


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` of finite float32 ``x`` under ``jax.jit`` on the CPU: x
    clamped to [-87.8, 88.8], n = floor(x log2(e) + 1/2) clamped to
    [-127, 127], r = x - n ln(2) in two parts, a degree-5 polynomial in r,
    then times 2^n built from bits (2^-127 is 0 there)."""
    x = torch.clamp(_ftz(x), _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma_f32(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma_f32(n, -_EXP_C1, x)
    r = fma_f32(n, -_EXP_C2, r)
    p = fma_f32(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        p = fma_f32(p, r, c)
    y = fma_f32(p, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return _ftz(y * scale)


# ---- log1p: a rational approximation near 0, log(1 + x) elsewhere ----
_LOG1P_SMALL = float(_f32(0.41421356237309503))   # sqrt(2) - 1
_LOG1P_P = tuple(float(_f32(c)) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_Q = tuple(float(_f32(c)) for c in (
    1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of float32 ``x`` > -1 under ``jax.jit`` on the CPU:
    for |x| < sqrt(2) - 1, x - x^2/2 + x^3 P(x) / Q(x) with degree-6
    polynomials evaluated by multiply-adds; elsewhere ``xla_log(1 + x)``."""
    x = _ftz(x)
    big = xla_log(x + 1.0)
    p = torch.full_like(x, _LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        p = fma_f32(p, x, c)
    q = torch.ones_like(x)
    for c in _LOG1P_Q:
        q = fma_f32(q, x, c)
    x2 = x * x
    t = (x * x2) * (p / q)
    small = x + fma_f32(x2, -0.5, t)
    return _ftz(torch.where(x.abs() < _LOG1P_SMALL, small, big))


# ---- pow(10, y): glibc's powf, whose exp2 runs in float64 ----
# log2(10) as powf's log2_inline evaluates it (its table entry 13 and
# degree-5 polynomial at z = 1.25, k = 3): the same float64 for every y
_LOG2_10 = float.fromhex("0x1.a934f0979b22dp+1")
# exp2f's table: 2^(i/32) for i = 0..31, and its degree-3 polynomial
_EXP2_TAB = tuple(float.fromhex(h) for h in (
    "0x1.0000000000000p+0", "0x1.059b0d3158574p+0", "0x1.0b5586cf9890fp+0",
    "0x1.11301d0125b51p+0", "0x1.172b83c7d517bp+0", "0x1.1d4873168b9aap+0",
    "0x1.2387a6e756238p+0", "0x1.29e9df51fdee1p+0", "0x1.306fe0a31b715p+0",
    "0x1.371a7373aa9cbp+0", "0x1.3dea64c123422p+0", "0x1.44e086061892dp+0",
    "0x1.4bfdad5362a27p+0", "0x1.5342b569d4f82p+0", "0x1.5ab07dd485429p+0",
    "0x1.6247eb03a5585p+0", "0x1.6a09e667f3bcdp+0", "0x1.71f75e8ec5f74p+0",
    "0x1.7a11473eb0187p+0", "0x1.82589994cce13p+0", "0x1.8ace5422aa0dbp+0",
    "0x1.93737b0cdc5e5p+0", "0x1.9c49182a3f090p+0", "0x1.a5503b23e255dp+0",
    "0x1.ae89f995ad3adp+0", "0x1.b7f76f2fb5e47p+0", "0x1.c199bdd85529cp+0",
    "0x1.cb720dcef9069p+0", "0x1.d5818dcfba487p+0", "0x1.dfc97337b9b5fp+0",
    "0x1.ea4afa2a490dap+0", "0x1.f50765b6e4540p+0"))
_EXP2_C = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_EXP2_SHIFT = float.fromhex("0x1.8p+47")   # 0x1.8p52 / 32: rounds to k/32
_EXP2_SHIFT_BITS = int(np.float64(_EXP2_SHIFT).view(np.int64))


def pow10(y: torch.Tensor) -> torch.Tensor:
    """``jnp.power(10.0, y)`` of finite float32 ``y`` under ``jax.jit`` on the
    CPU, which calls glibc's ``powf`` (its FMA build on an x86 CPU with FMA):
    x = y log2(10) in float64, k = round(32 x), r = x - k/32,
    2^x = 2^(k/32) (1 + C2 r + (C0 r + C1) r^2) with the multiply-adds
    rounded once, rounded to float32; 0 where x <= -150 and, as XLA's CPU
    runtime flushes it, where the result is subnormal."""
    xd = y.double() * _LOG2_10
    kd = xd + _EXP2_SHIFT
    k = kd.view(torch.int64) - _EXP2_SHIFT_BITS
    r = xd - (kd - _EXP2_SHIFT)
    tab = to_device(np.array(_EXP2_TAB, dtype=np.float64), y.device)
    scale = (((k >> 5) + 1023) << 52).view(torch.float64)   # 2^floor(k / 32)
    s = tab[k & 31] * scale
    z = _fma64(r, _EXP2_C[0], _EXP2_C[1])
    t = _fma64(r, _EXP2_C[2], 1.0)
    out = (_fma64(z, r * r, t) * s).float()
    return _ftz(torch.where(xd <= -150.0, 0.0, out))
