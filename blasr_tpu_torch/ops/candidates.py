"""Candidate-window selection and chain evidence from anchors.

Port of ``blasr_tpu.ops.candidates`` (``Candidates``, ``select_candidates``,
``chain_stats``, ``anchor_weights``): each anchor lies on diagonal
``d = t - q``; the window starting at every anchor's diagonal sums the
weights of the anchors inside ``[d, d + win)``, and the top C windows per
read are picked by argmax with non-maximum suppression. The float sums
go through ``ordered_sum``, which fixes their addition order, so integer
decisions taken from them (argmax ties, the truncated mean diagonal) agree
with the JAX package and between devices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BIG = 2**30
SUM_CHUNK = 32


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Float sum over the last axis in a fixed order: chunks of 32 summed
    left to right, then the chunk sums the same way, recursively. This is
    the order XLA's CPU backend uses for lengths that are multiples of 32
    or at most 32 (checked against ``jnp.sum``), which is what makes the
    float-derived integers of the mapper agree with the JAX package; a
    device reduction (``torch.sum``) would choose its own order."""
    while x.shape[-1] > SUM_CHUNK:
        n = x.shape[-1]
        m = -(-n // SUM_CHUNK) * SUM_CHUNK
        if m != n:
            x = torch.nn.functional.pad(x, (0, m - n))
        x = _sequential_sum(x.reshape(*x.shape[:-1], m // SUM_CHUNK, SUM_CHUNK))
    return _sequential_sum(x)


class Candidates(NamedTuple):
    """Per (read row, candidate) target window; every field (B, C)."""

    d0: torch.Tensor        # int32 representative diagonal (weighted mean)
    q_lo: torch.Tensor      # int32 min read pos among member anchors
    q_hi: torch.Tensor      # int32 max read pos + k among member anchors
    weight: torch.Tensor    # float32 summed anchor weight
    n_anchors: torch.Tensor  # int32 member count
    valid: torch.Tensor     # bool
    dstar: torch.Tensor     # int32 window-start diagonal


def select_candidates(
    t: torch.Tensor,        # (B, A) int32 anchor genome pos
    q: torch.Tensor,        # (B, A) int32 anchor read pos
    weight: torch.Tensor,   # (B, A) float32 per-anchor evidence weight
    valid: torch.Tensor,    # (B, A) bool
    *,
    n_candidates: int,
    win: int,
    k: int,
) -> Candidates:
    i32 = torch.int32
    d = t - q
    ds = torch.where(valid, d, BIG)
    ws = torch.where(valid, weight, 0.0)
    qs = q

    delta = ds[:, None, :] - ds[:, :, None]            # (B, win_i, anchor_j)
    member_m = (delta >= 0) & (delta < win)
    win_w = ordered_sum(torch.where(member_m, ws[:, None, :], 0.0))
    win_w = torch.where(valid, win_w, -1.0)

    score = win_w
    d0s, qlos, qhis, weights, ns, valids, dstars = [], [], [], [], [], [], []
    for _ in range(n_candidates):
        best = torch.argmax(score, dim=1)               # first maximum
        bi = best[:, None]
        wsum = torch.gather(score, 1, bi)[:, 0]
        ok = wsum > 0.0
        dstar_c = torch.gather(ds, 1, bi)[:, 0]
        reld = ds - dstar_c[:, None]
        member = (reld >= 0) & (reld < win) & valid
        nmem = torch.sum(member, dim=1).to(i32)
        rel = ordered_sum(torch.where(member, ws * reld.to(torch.float32), 0.0))
        d0 = torch.where(
            ok,
            dstar_c + (rel / torch.clamp(wsum, min=1e-9)).to(i32),
            0,
        )
        qlo = torch.min(torch.where(member, qs, BIG), dim=1).values
        qhi = torch.max(torch.where(member, qs + k, -1), dim=1).values
        d0s.append(d0.to(i32))
        qlos.append(torch.where(ok, qlo, 0))
        qhis.append(torch.where(ok, qhi, 0))
        weights.append(torch.where(ok, wsum, 0.0))
        ns.append(torch.where(ok, nmem, 0))
        valids.append(ok)
        dstars.append(torch.where(ok, dstar_c, 0))
        # suppress anchors within +-win of the chosen window start
        near = (ds >= dstar_c[:, None] - win) & (ds < dstar_c[:, None] + win)
        score = torch.where(near, -1.0, score)

    def stack(xs):
        return torch.stack(xs, dim=1)

    return Candidates(
        d0=stack(d0s),
        q_lo=stack(qlos),
        q_hi=stack(qhis),
        weight=stack(weights),
        n_anchors=stack(ns),
        valid=stack(valids),
        dstar=stack(dstars),
    )


def chain_stats(
    t: torch.Tensor,        # (B, A) int32 anchor genome pos
    q: torch.Tensor,        # (B, A) int32 anchor read pos
    valid: torch.Tensor,    # (B, A) bool
    dstar: torch.Tensor,    # (B, C) int32 window-start diagonal per candidate
    cvalid: torch.Tensor,   # (B, C) bool
    *,
    k: int,
    win: int,
):
    """(n_chain, chained_any, mass, corners) per candidate window: colinear
    chain evidence, the maxPValue admission gate, the non-overlapping anchor
    base coverage and the chain's (q_lo, q_hi, t_lo, t_hi) corners. See the
    JAX module for the reference semantics of each."""
    i32 = torch.int32
    B, A = t.shape
    d = t - q

    reld = d[:, None, :] - dstar[:, :, None]
    mem = valid[:, None, :] & (reld >= 0) & (reld < win) & cvalid[:, :, None]

    q_i = q[:, None, None, :]                                # (B,1,1,Ai)
    q_j = q[:, None, :, None]                                # (B,1,Aj,1)
    mem_i = mem[:, :, None, :]                               # (B,C,1,Ai)
    prev_mask = mem_i & (q_i <= q_j - k)
    prev_t = torch.amin(torch.where(prev_mask, t[:, None, None, :], BIG), dim=-1)
    has_prev = prev_t <= t[:, None, :] - k
    chained = mem & has_prev
    n_link = torch.sum(chained, dim=-1).to(i32)
    any_mem = torch.any(mem, dim=-1)

    gap = q[:, :, None] - q[:, None, :]                      # (B, Aj, Ai)
    pair_ok = torch.any(
        (d[:, :, None] == d[:, None, :])
        & valid[:, :, None] & valid[:, None, :]
        & (gap >= 3) & (gap <= k - 1),
        dim=-1,
    )
    single_ok = torch.any(mem & pair_ok[:, None, :], dim=-1)

    succ_mask = mem_i & (q_i >= q_j + k)
    succ_t = torch.amax(torch.where(succ_mask, t[:, None, None, :], -BIG), dim=-1)
    has_succ = succ_t >= t[:, None, :] + k
    part = mem & (has_prev | has_succ)
    use = torch.where(torch.any(part, dim=-1, keepdim=True), part, mem)
    qpart = q[:, None, :].expand(mem.shape)
    tpart = t[:, None, :].expand(mem.shape)
    q_lo_ch = torch.amin(torch.where(use, qpart, BIG), dim=-1)
    q_hi_ch = torch.amax(torch.where(use, qpart + k, -BIG), dim=-1)
    t_lo_ch = torch.amin(torch.where(use, tpart, BIG), dim=-1)
    t_hi_ch = torch.amax(torch.where(use, tpart + k, -BIG), dim=-1)
    corners = tuple(
        torch.where(any_mem, x, 0).to(i32)
        for x in (q_lo_ch, q_hi_ch, t_lo_ch, t_hi_ch)
    )

    idx_i = torch.arange(A, dtype=i32, device=t.device)[None, None, None, :]
    idx_j = torch.arange(A, dtype=i32, device=t.device)[None, None, :, None]
    after = (q_i > q_j) | ((q_i == q_j) & (idx_i > idx_j))
    next_q = torch.amin(torch.where(mem_i & after, q_i, BIG), dim=-1)
    contrib = torch.where(mem, torch.clamp(next_q - q[:, None, :], max=k), 0)
    mass = torch.sum(contrib, dim=-1).to(i32)
    return (
        n_link + any_mem.to(i32),
        torch.any(chained, dim=-1) | single_ok,
        mass,
        corners,
    )


# XLA's CPU log of float32, which the JAX mapper runs: the Cephes
# polynomial of XLA's CPU backend (Eigen's plog), with the multiply-adds
# that LLVM fuses into single-rounding multiply-adds. torch.log and
# torch.log2 round differently in the last bit for about one input in ten.
_LOG_P = tuple(float(np.float32(p)) for p in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_SQRTHF = float(np.float32(0.707106781186547524))
_MIN_NORMAL = float(np.float32(2.0**-126))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
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
    p = a * b
    s = p + c
    pb = s - p
    err = (p - (s - pb)) + (c - pb)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive float32 ``x``, bit for bit as XLA's CPU
    backend computes it (finite positive inputs: the mapper's expected hit
    counts). Plain IEEE float32/float64 operations and bit moves, so the
    CPU and the card give the same bits."""
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
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    m = m - x2 * 0.5
    m = m + y
    return m + _LOG_Q2 * e


def anchor_weights(
    nhits: torch.Tensor, valid: torch.Tensor, genome_len: int, win: int, pval_type: int
) -> torch.Tensor:
    """Per-anchor evidence weight: -log2 of the expected random hits inside
    the window (pvaltype 0/1), plain count (2) or 1/nhits (3).

    pvaltype 0/1 follows the JAX function as the mapper runs it, under
    ``jax.jit``: XLA folds ``* win / G`` into one multiply by the float32
    constant ``win * (1 / G)``, and ``log2`` into ``log`` times the float32
    constant ``1 / log(2)``."""
    nh = torch.clamp(nhits, min=1).to(torch.float32)
    if pval_type == 2:
        w = torch.ones_like(nh)
    elif pval_type == 3:
        w = 1.0 / nh
    else:
        f32 = np.float32
        per_hit = float(f32(win) * (f32(1) / f32(max(genome_len, 1))))
        inv_ln2 = float(f32(1) / f32(np.log(2.0)))
        w = torch.clamp(-(xla_log(nh * per_hit) * inv_ln2), min=0.5)
    return torch.where(valid, w, 0.0)
