"""Banded affine-gap local alignment over anti-diagonals: the plain version.

PyTorch counterpart of ``blasr_tpu.ops.banded_align`` (the XLA-scan oracle)
for one shared band schedule ``qoff`` (S,) or a per-item (guided) schedule
(S, I), with or without quality values, with the default scores or a 5x5
substitution matrix. Cell ``(a, w)`` of anti-diagonal ``a`` sits at
``q = qoff[a] + w``, ``t = a - q``; H is the min-score local recurrence
clamped at 0, E and F the affine open/extend pair. Each cell emits one
uint16 arrow word: bits 0-2 H source, bit 3 E-extend, bit 4 F-extend,
bits 5-10 the diagonal run length, bits 11-15 the mismatches inside the
run.

Guided schedules come from per-item knots (``make_qoff_knots``, the role of
the reference's per-read guide, GuidedAlign.h:104): one knot every
``KNOT_SPACING`` steps, expanded by the integer lerp of
``qoff_from_knots``, which the CUDA kernel and the traceback walk evaluate
identically.

Quality values scale two costs per cell (``qv_scaled_costs``): a uint8
(I, L) phred stream scales both the mismatch and the insertion cost; the
dual stream, uint16 phred pairs carried as their bit pattern in an int16
(I, L) tensor, scales the mismatch cost by its low byte (sq) and the
insertion cost by its high byte (iq). Past a read's padded length the
stream reads the neutral phred 15 (unscaled costs).

This module is the reference the CUDA kernel (``csrc/banded_dp.cu``,
wrapped by ``ops/banded_cuda.py``) is held against: one Python loop over
the S steps, each step a handful of whole-band tensor ops over all items.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

INF = 2**30
QV_NEUTRAL = 15                       # phred that leaves a cost unscaled
QV_NEUTRAL_DUAL = 15 | (15 << 8)      # both bytes of the dual stream

# H-source codes stored in the arrow word (priority order on ties)
SRC_DIAG, SRC_UP, SRC_LEFT, SRC_E, SRC_F, SRC_STOP = 0, 1, 2, 3, 4, 5
SRC_DIAG_START = 6  # diagonal move from a fresh (empty) local start

QOFF_SHIFT = 16  # fixed-point denominator bits of the drift-slope schedule
QOFF_NUM_HALF = 1 << (QOFF_SHIFT - 1)  # num for slope 0: centre_q=(a-diag)/2


class AlignScores(NamedTuple):
    match: int = -5
    mismatch: int = 6
    n_score: int = 0        # vs-N column of the SMRT matrix
    insertion: int = 5      # consume query (read insertion)
    deletion: int = 5       # consume target (read deletion)
    affine_open: int = 50
    affine_extend: int = 0
    matrix: tuple | None = None  # -scoreMatrix: 25 ints, row-major query x
                            # target over A C G T N (StringToScoreMatrix.h);
                            # replaces match/mismatch/n_score when set


def matrix_sub(qwin: torch.Tensor, twin: torch.Tensor, mat: tuple) -> torch.Tensor:
    """Per-cell substitution score from the 5x5 matrix: ``mat[5 q + min(t,
    4)]`` for a query code q in 0..4, 0 for any other query code or a
    negative target code (the select chain of the JAX ``matrix_sub``, as
    one table lookup)."""
    lut = torch.tensor([*mat, 0], dtype=torch.int32, device=qwin.device)
    q = qwin.to(torch.int32)
    t = torch.clamp(twin.to(torch.int32), max=4)
    idx = torch.where((q >= 0) & (q <= 4) & (t >= 0), q * 5 + t, 25)
    return lut[idx.long()]


class BandedResult(NamedTuple):
    score: torch.Tensor    # (I,) int32 best local score (<= 0)
    best_a: torch.Tensor   # (I,) int32 anti-diagonal of the alignment end cell
    best_w: torch.Tensor   # (I,) int32 band index of the alignment end cell
    arrows: Optional[torch.Tensor]  # (S, I, W) uint16 arrow words or None


def make_qoff(L: int, T: int, W: int, diag: int, device=None) -> torch.Tensor:
    """Band offsets centred on local diagonal ``diag`` (int32 (S,), per-step
    deltas in {0, 1})."""
    S = L + T - 1
    a = torch.arange(S, dtype=torch.int64, device=device)
    centre_q = torch.div(a - diag, 2, rounding_mode="floor")
    return torch.clamp(centre_q - W // 2, 0, max(0, L - W)).to(torch.int32)


def make_qoff_num(L: int, T: int, W: int, diag: int, num, device=None) -> torch.Tensor:
    """Drift-slope band schedule: the band centre follows
    ``((a - diag) * num) >> QOFF_SHIFT``. ``num`` may be a 0-d int32 tensor
    (estimated per batch on the device); the traceback walk evaluates the
    identical integer formula. ``num = QOFF_NUM_HALF`` reproduces
    ``make_qoff``."""
    if isinstance(num, torch.Tensor):
        device = num.device
        numc = num.to(torch.int32)
    else:
        numc = torch.tensor(int(num), dtype=torch.int32, device=device)
    S = L + T - 1
    a = torch.arange(S, dtype=torch.int32, device=device)
    centre_q = ((a - diag) * numc) >> QOFF_SHIFT
    return torch.clamp(centre_q - W // 2, 0, max(0, L - W)).to(torch.int32)


KNOT_LOG2 = 6                  # knot spacing (steps) of the guided schedule,
KNOT_SPACING = 1 << KNOT_LOG2  # a power of two: the lerp is shift-only


def n_knots(S: int) -> int:
    """Knot count covering steps [0, S): ceil((S-1)/KS) + 1 segment ends."""
    return max(1, -(-(S - 1) // KNOT_SPACING)) + 1


def qoff_from_knots(knots: torch.Tensor, S: int) -> torch.Tensor:
    """Per-item knots (I, NK) -> the per-item band schedule (S, I):
    ``qoff(a) = (k0 (KS - r) + k1 r) >> KNOT_LOG2`` with ``j = a >> 6``,
    ``r = a & 63``, ``k0 = knots[:, j]``, ``k1 = knots[:, min(j+1, NK-1)]``.
    Knots from ``make_qoff_knots`` are nondecreasing with steps <= KS, so
    the per-step deltas are in {0, 1}."""
    a = torch.arange(S, dtype=torch.int32, device=knots.device)
    j = (a >> KNOT_LOG2).long()
    r = (a & (KNOT_SPACING - 1))[:, None]
    kt = knots.to(torch.int32).t()
    k0 = kt[j]
    k1 = kt[torch.clamp(j + 1, max=knots.shape[1] - 1)]
    return ((k0 * (KNOT_SPACING - r) + k1 * r) >> KNOT_LOG2).to(torch.int32)


def make_qoff_knots(
    a_anchor: torch.Tensor,  # (I, A) int32 anchor anti-diagonals (window coords)
    v_anchor: torch.Tensor,  # (I, A) int32 wanted band start at that step
    mask: torch.Tensor,      # (I, A) bool chain-consistent member anchors
    S: int,
    L: int,
    W: int,
    diag: int,               # the shared schedule's diagonal
    num,                     # drift-slope numerator (QOFF_SHIFT fixed point)
) -> torch.Tensor:
    """Per-item guided band knots (I, NK) from each item's member anchors:
    linear between anchors (floor division), along the batch drift line
    before the first and after the last, the shared line for an item with
    no anchor; then clipped to [0, L-W] and made nondecreasing with steps
    <= KNOT_SPACING. Anchors with equal ``a`` keep their input order."""
    i32 = torch.int32
    dev = a_anchor.device
    A = a_anchor.shape[1]
    NK = n_knots(S)
    ak = (torch.arange(NK, dtype=i32, device=dev) * KNOT_SPACING)[None, :]
    numc = torch.as_tensor(num, dtype=i32, device=dev)

    a_m = torch.where(mask, a_anchor.to(i32), 1 << 28)
    order = torch.argsort(a_m, dim=1, stable=True)
    a_s = torch.gather(a_m, 1, order)
    v_s = torch.gather(torch.where(mask, v_anchor.to(i32), 0), 1, order)
    n_valid = mask.sum(dim=1).to(i32)

    # neighbours of every knot step: count anchors with a <= ak
    idx = (a_s[:, None, :] <= ak[:, :, None]).sum(dim=2).to(i32)   # (I, NK)
    lo = torch.clamp(idx - 1, 0, A - 1).long()
    hi = torch.clamp(torch.minimum(idx, n_valid[:, None] - 1), 0, A - 1).long()
    a_lo, a_hi = torch.gather(a_s, 1, lo), torch.gather(a_s, 1, hi)
    v_lo, v_hi = torch.gather(v_s, 1, lo), torch.gather(v_s, 1, hi)

    inside = (idx >= 1) & (idx < n_valid[:, None])
    below = idx < 1
    span = torch.clamp(a_hi - a_lo, min=1)
    v_interp = v_lo + torch.div((ak - a_lo) * (v_hi - v_lo), span, rounding_mode="floor")
    v_ext_lo = v_hi + (((ak - a_hi) * numc) >> QOFF_SHIFT)   # before the first
    v_ext_hi = v_lo + (((ak - a_lo) * numc) >> QOFF_SHIFT)   # after the last
    v = torch.where(inside, v_interp, torch.where(below, v_ext_lo, v_ext_hi))
    v_shared = (((ak - diag) * numc) >> QOFF_SHIFT) - W // 2
    v = torch.where((n_valid > 0)[:, None], v, v_shared)

    v = torch.clamp(v, 0, max(0, L - W))
    v = torch.cummax(v, dim=1).values
    d = torch.clamp(torch.diff(v, dim=1), 0, KNOT_SPACING)
    return torch.cat([v[:, :1], v[:, :1] + torch.cumsum(d, dim=1)], dim=1).to(i32)


def guided_max_dev(W: int) -> int:
    """The reference's bound on a guided knot's distance from the shared
    line: 88 at W=32, 120 at W=64 (the chunked TPU kernel's fetch span,
    mL*W - 8) and W - 8 from W=128 (banded_pallas._guided_geometry). The
    CUDA kernel has no fetch span, but the clamp is part of the result."""
    return {32: 88, 64: 120}.get(W, W - 8)


def clamp_knots_to_shared(
    knots: torch.Tensor, qoff_shared: torch.Tensor, W: int, margin: int = 8,
    max_dev: int | None = None,
) -> torch.Tensor:
    """Clip each knot to within ``max_dev`` (default ``W - margin``) of the
    shared schedule at the knot's step. Monotonicity and the step bound
    survive, so the per-step deltas stay in {0, 1}."""
    S = qoff_shared.shape[0]
    NK = knots.shape[1]
    ak = torch.clamp(
        torch.arange(NK, dtype=torch.int64, device=knots.device) * KNOT_SPACING, max=S - 1
    )
    ks = qoff_shared.to(torch.int32)[ak][None, :]
    c = (W - margin) if max_dev is None else max_dev
    return torch.clamp(knots, ks - c, ks + c).to(torch.int32)


def qv_scaled_costs(base: int, qual: torch.Tensor) -> torch.Tensor:
    """QV-scaled penalty, ``max(1, (base * clip(q, 4, 30) + 7) // 15)``
    (floor division): phred 15 gives ``base``, 30 and above twice it, a
    noisy base a cheap one (QualityValueScoreFunction.h:65,80-84)."""
    qv = torch.clamp(qual.to(torch.int32), 4, 30)
    return torch.clamp(torch.div(base * qv + 7, 15, rounding_mode="floor"), min=1)


def qual_mode(qual: torch.Tensor | None) -> str:
    """'none', 'single' (uint8 stream) or 'dual' (int16 bits of uint16)."""
    if qual is None:
        return "none"
    if qual.dtype == torch.uint8:
        return "single"
    if qual.dtype == torch.int16:
        return "dual"
    raise ValueError(
        f"qual: expected uint8 (single stream) or int16 holding uint16 bits "
        f"(dual stream), got {qual.dtype}"
    )


def _shift(x: torch.Tensor, d, fill: int) -> torch.Tensor:
    """Value at band index w + d; ``fill`` off the band. ``d`` is an int in
    {-1, 0, 1} (shared schedule) or an (I,) tensor of such per-item deltas
    (guided schedule: a 3-way select per item)."""
    if isinstance(d, torch.Tensor):
        dc = d[:, None]
        out = torch.where(dc == -1, _shift(x, -1, fill), x)
        return torch.where(dc == 1, _shift(x, 1, fill), out)
    if d == 0:
        return x
    out = torch.full_like(x, fill)
    if d > 0:
        out[:, :-d] = x[:, d:]
    else:
        out[:, -d:] = x[:, :d]
    return out


def banded_align_plain(
    query: torch.Tensor,    # (I, L) uint8 codes 0..4
    qlen: torch.Tensor,     # (I,) int32
    target: torch.Tensor,   # (I, T) uint8 codes 0..5 (5 = out-of-window)
    tlo: torch.Tensor,      # (I,) int32 valid target range start (local)
    thi: torch.Tensor,      # (I,) int32 valid target range end (local)
    qoff: torch.Tensor,     # (S,) int32 shared band offsets, or (S, I) per item
    qual: torch.Tensor | None = None,  # (I, L) uint8, or int16 (dual)
    *,
    scores: AlignScores = AlignScores(),
    with_traceback: bool = False,
    band_width: int = 128,
    global_q: bool = False,
) -> BandedResult:
    """The banded DP, step by step, on whatever device the inputs live on.
    Bit-identical to ``blasr_tpu.ops.banded_align.banded_align`` for local
    scoring. A per-item schedule (S, I) turns the window reads into
    per-item gathers and the band shifts into per-item selects; its values
    must lie in [0, L - W] with per-step deltas in {0, 1}
    (``qoff_from_knots``)."""
    mode = qual_mode(qual)
    if global_q:
        raise NotImplementedError("global-in-query scoring is not ported yet")
    dev = query.device
    I, L = query.shape
    T = target.shape[1]
    S = int(qoff.shape[0])
    if S != L + T - 1:
        raise ValueError(f"qoff has {S} steps, expected L + T - 1 = {L + T - 1}")
    per_item = qoff.dim() == 2
    if per_item and qoff.shape[1] != I:
        raise ValueError(f"per-item qoff has {qoff.shape[1]} columns for {I} items")
    W = band_width
    i32 = torch.int32

    qext = torch.full((I, L + W), 4, dtype=torch.int8, device=dev)
    qext[:, :L] = query.to(torch.int8)
    Tp = T + 2 * W
    tpad = torch.full((I, Tp), 5, dtype=torch.int8, device=dev)
    tpad[:, W : W + T] = target.to(torch.int8)
    trev = torch.flip(tpad, dims=[1]).contiguous()
    if mode != "none":
        neutral = QV_NEUTRAL_DUAL if mode == "dual" else QV_NEUTRAL
        quext = torch.full((I, L + W), neutral, dtype=torch.int32, device=dev)
        quext[:, :L] = qual.to(torch.int32) & 0xFFFF   # the unsigned value

    if per_item:
        q_all = qoff.to(i32)
        s1_all = torch.diff(q_all, dim=0, prepend=q_all[:1])    # (S, I), row 0 = 0
    else:
        qo_list = [int(v) for v in qoff.tolist()]
    w_ar = torch.arange(W, dtype=i32, device=dev)[None, :]
    qlen_c = qlen.to(i32)[:, None]
    tlo_c = tlo.to(i32)[:, None]
    thi_c = thi.to(i32)[:, None]
    m_sc, x_sc, n_sc = scores.match, scores.mismatch, scores.n_score
    ins_sc, del_sc = scores.insertion, scores.deletion
    go, ge = scores.affine_open, scores.affine_extend

    H1 = torch.full((I, W), INF, dtype=i32, device=dev)
    H2 = H1.clone()
    E1 = H1.clone()
    F1 = H1.clone()
    R1 = torch.zeros((I, W), dtype=i32, device=dev)
    R2 = R1.clone()
    M1 = R1.clone()
    M2 = R1.clone()
    best = torch.zeros(I, dtype=i32, device=dev)
    besta = torch.zeros(I, dtype=i32, device=dev)
    bestw = torch.zeros(I, dtype=i32, device=dev)
    arrows = (
        torch.empty((S, I, W), dtype=torch.int16, device=dev)
        if with_traceback else None
    )

    s1_prev = 0
    for a in range(S):
        if per_item:
            qo = q_all[a]                                 # (I,)
            s1 = s1_all[a]
            s2 = s1_all[a - 1] if a > 0 else torch.zeros_like(s1)
            gidx = (qo[:, None] + w_ar).long()
            qwin = torch.gather(qext, 1, gidx)
            # JAX's per-item take fills an index past the padded target;
            # clamping it instead only touches cells with t < -W or
            # t >= T + W, which are invalid (masked to INF / STOP)
            tidx = torch.clamp((Tp - 1 - W) - (a - qo)[:, None] + w_ar, 0, Tp - 1)
            twin = torch.gather(trev, 1, tidx.long())
            quwin = torch.gather(quext, 1, gidx) if mode != "none" else None
            qo = qo[:, None]
        else:
            qo = qo_list[a]
            s1 = qo - qo_list[a - 1] if a > 0 else 0
            s2 = s1_prev
            s1_prev = s1
            qwin = qext[:, qo : qo + W]
            # t = a - qo - w  ->  trev index (Tp - 1 - W) - (a - qo) + w, with
            # the start clamped like lax.dynamic_slice_in_dim (a clamped
            # start only occurs where every cell of the step is outside the
            # target)
            ts = min(max((Tp - 1 - W) - (a - qo), 0), Tp - W)
            twin = trev[:, ts : ts + W]
            quwin = quext[:, qo : qo + W] if mode != "none" else None
        if mode == "none":
            x_cell, ins_cell = x_sc, ins_sc
        else:
            lo, hi = (quwin & 255, quwin >> 8) if mode == "dual" else (quwin, quwin)
            x_cell = qv_scaled_costs(x_sc, lo)
            ins_cell = qv_scaled_costs(ins_sc, hi)

        q_pos = qo + w_ar
        t_pos = a - q_pos
        valid = (q_pos < qlen_c) & (t_pos >= tlo_c) & (t_pos < thi_c) & (t_pos >= 0)

        eq = (qwin == twin) & (qwin < 4)
        if scores.matrix is not None:
            # the matrix replaces match/mismatch/N (and so the quality-scaled
            # mismatch); the quality-scaled insertion cost stays
            sub = matrix_sub(qwin, twin, scores.matrix)
        else:
            anyn = (qwin >= 4) | (twin >= 4)
            sub = torch.where(
                eq, m_sc, torch.where(anyn, n_sc, x_cell)
            ).to(i32)

        H1_up = _shift(H1, s1 - 1, INF)
        H1_left = _shift(H1, s1, INF)
        E1_left = _shift(E1, s1, INF)
        F1_up = _shift(F1, s1 - 1, INF)
        dd = s1 + s2 - 1
        H2_diag = _shift(H2, dd, INF)
        R2_diag = _shift(R2, dd, 0)
        M2_diag = _shift(M2, dd, 0)

        e_open = H1_left + go
        E_new = torch.minimum(E1_left, e_open) + ge
        ebit = (E1_left <= e_open).to(i32)
        f_open = H1_up + go
        F_new = torch.minimum(F1_up, f_open) + ge
        fbit = (F1_up <= f_open).to(i32)

        diag_fresh = H2_diag > 0  # INF marks out-of-band / masked predecessors
        h = torch.clamp(H2_diag, max=0) + sub
        src = torch.where(diag_fresh, SRC_DIAG_START, SRC_DIAG).to(i32)
        for val, code in (
            (H1_up + ins_cell, SRC_UP),
            (H1_left + del_sc, SRC_LEFT),
            (E_new, SRC_E),
            (F_new, SRC_F),
        ):
            take = val < h
            h = torch.minimum(h, val)
            src = torch.where(take, code, src)
        # the empty alignment wins every tie at 0
        src = torch.where(h >= 0, SRC_STOP, src)
        h = torch.clamp(h, max=0)

        H_new = torch.where(valid, h, INF)
        E_new = torch.where(valid, E_new, INF)
        F_new = torch.where(valid, F_new, INF)
        src = torch.where(valid, src, SRC_STOP)
        is_diag = src == SRC_DIAG
        mm = (~eq).to(i32)
        restart = (R2_diag >= 63) | (M2_diag >= 31)
        R_new = torch.where(
            is_diag, torch.where(restart, 1, R2_diag + 1), 0
        ).to(i32)
        M_new = torch.where(
            is_diag, torch.where(restart, mm, M2_diag + mm), 0
        ).to(i32)
        M_emit = torch.where(src == SRC_DIAG_START, mm, M_new)

        row_min, row_arg = torch.min(H_new, dim=1)
        better = row_min < best
        best = torch.minimum(best, row_min)
        besta = torch.where(better, a, besta)
        bestw = torch.where(better, row_arg.to(i32), bestw)

        if with_traceback:
            word = src | (ebit << 3) | (fbit << 4) | (R_new << 5) | (M_emit << 11)
            arrows[a] = word.to(torch.int16)
        H2, H1, E1, F1 = H1, H_new, E_new, F_new
        R2, R1, M2, M1 = R1, R_new, M1, M_new

    return BandedResult(
        best, besta, bestw,
        arrows.view(torch.uint16) if with_traceback else None,
    )
