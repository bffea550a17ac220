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

from blasr_tpu_torch.ops.xla_math import xla_log

BIG = 2**30
SUM_CHUNK = 32


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Float sum over the last axis in XLA's CPU order for ``jnp.sum``: a
    window reduction of size 32 whose zero padding is split over both
    ends, ``(m - n) // 2`` in front and the rest behind (m the length
    rounded up to 32; the compiled HLO's ``reduce-window`` shows
    ``pad=14_14`` at n = 100, ``15_16`` at n = 33), each window summed left
    to right, then the window sums the same way until at most 32 remain,
    and those left to right. That order is what makes the float-derived
    integers of the mapper agree with the JAX package; a device reduction
    (``torch.sum``) would choose its own."""
    while x.shape[-1] > SUM_CHUNK:
        n = x.shape[-1]
        m = -(-n // SUM_CHUNK) * SUM_CHUNK
        if m != n:
            lo = (m - n) // 2
            x = torch.nn.functional.pad(x, (lo, m - n - lo))
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


def global_chain_exact(q: np.ndarray, t: np.ndarray, l: np.ndarray) -> tuple[int, list[int]]:
    """Exact max-weight colinear chain of fragments (q, t, length), the
    reference's GlobalChain semantics (GlobalChain.h:100-210): a fragment's
    weight is its length, and i may precede j when i's end passes neither
    of j's starts. An O(n^2) DP on the host, the oracle of
    ``chain_weight_device``; returns (best weight, the chain's indices into
    the inputs in start-to-end order)."""
    n = len(q)
    if n == 0:
        return 0, []
    order = np.lexsort((t, q))
    qs, ts, ls = q[order], t[order], l[order]
    score = ls.astype(np.int64).copy()
    prev = np.full(n, -1, np.int64)
    for j in range(n):
        ok = (qs[:j] + ls[:j] <= qs[j]) & (ts[:j] + ls[:j] <= ts[j])
        if ok.any():
            cand = np.where(ok, score[:j], -1)
            i = int(cand.argmax())
            if cand[i] > 0:
                score[j] = ls[j] + cand[i]
                prev[j] = i
    jbest = int(score.argmax())
    chain = []
    while jbest >= 0:
        chain.append(int(order[jbest]))
        jbest = int(prev[jbest])
    chain.reverse()
    return int(score.max()), chain


def chain_weight_device(
    t: torch.Tensor,        # (B, A) int32 anchor genome pos
    q: torch.Tensor,        # (B, A) int32 anchor read pos
    valid: torch.Tensor,    # (B, A) bool
    dstar: torch.Tensor,    # (B, C) int32 window-start diagonal per candidate
    cvalid: torch.Tensor,   # (B, C) bool
    *,
    k: int,
    win: int,
) -> torch.Tensor:
    """(B, C) int32: the exact max-weight colinear chain of each candidate
    window's member anchors (fragments of length k), the reference's
    GlobalChain ranking (``exact_chain``); equals ``global_chain_exact``
    on each window's members.

    The anchors are taken in ascending q order (ties by index, as the JAX
    function's pairwise rank orders them): a predecessor has q_i + k <=
    q_j, so it is final before its successor's step, and each step takes
    the best chain ending at one predecessor among the window's members.
    A steps of int32 arithmetic on the device, with no host sync."""
    B, A = t.shape
    d = t - q
    reld = d[:, None, :] - dstar[:, :, None]
    mem = valid[:, None, :] & (reld >= 0) & (reld < win) & cvalid[:, :, None]  # (B, C, A)
    order = torch.argsort(q, dim=1, stable=True)
    q_ord = torch.gather(q, 1, order)
    t_ord = torch.gather(t, 1, order)
    mem_ord = torch.gather(mem, 2, order[:, None, :].expand(mem.shape))
    f = torch.zeros(mem.shape, dtype=torch.int32, device=t.device)  # in q order
    qk = q_ord + k
    tk = t_ord + k
    for s in range(A):
        # the predecessors of anchor s all lie before it in q order
        pred = mem_ord[:, :, :s] & ((qk[:, :s] <= q_ord[:, s : s + 1])
                                     & (tk[:, :s] <= t_ord[:, s : s + 1]))[:, None, :]
        pm = torch.amax(torch.where(pred, f[:, :, :s], 0), dim=-1) if s else 0
        f[:, :, s] = torch.where(mem_ord[:, :, s], k + pm, 0)
    return torch.amax(f, dim=-1) if A else torch.zeros(dstar.shape, dtype=torch.int32,
                                                       device=t.device)
