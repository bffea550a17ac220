"""Banded affine-gap local alignment over anti-diagonals: the plain version.

PyTorch counterpart of ``blasr_tpu.ops.banded_align`` (the XLA-scan oracle)
for one shared band schedule ``qoff``, with or without quality values. Cell
``(a, w)`` of anti-diagonal ``a`` sits at ``q = qoff[a] + w``,
``t = a - q``; H is the min-score local recurrence clamped at 0, E and F
the affine open/extend pair. Each cell emits one uint16 arrow word:
bits 0-2 H source, bit 3 E-extend, bit 4 F-extend, bits 5-10 the diagonal
run length, bits 11-15 the mismatches inside the run.

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


def _shift(x: torch.Tensor, d: int, fill: int) -> torch.Tensor:
    """Value at band index w + d (d in {-1, 0, 1}); ``fill`` off the band."""
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
    qoff: torch.Tensor,     # (S,) int32 shared band offsets
    qual: torch.Tensor | None = None,  # (I, L) uint8, or int16 (dual)
    *,
    scores: AlignScores = AlignScores(),
    with_traceback: bool = False,
    band_width: int = 128,
    global_q: bool = False,
) -> BandedResult:
    """The unguided banded DP, step by step, on whatever device the inputs
    live on. Bit-identical to ``blasr_tpu.ops.banded_align.banded_align``
    for a shared ``qoff`` and local scoring."""
    mode = qual_mode(qual)
    if qoff.dim() != 1:
        raise NotImplementedError("per-item (guided) band schedules are not ported yet")
    if global_q:
        raise NotImplementedError("global-in-query scoring is not ported yet")
    dev = query.device
    I, L = query.shape
    T = target.shape[1]
    S = int(qoff.shape[0])
    if S != L + T - 1:
        raise ValueError(f"qoff has {S} steps, expected L + T - 1 = {L + T - 1}")
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
        qo = qo_list[a]
        s1 = qo - qo_list[a - 1] if a > 0 else 0
        s2 = s1_prev
        s1_prev = s1
        qwin = qext[:, qo : qo + W]
        # t = a - qo - w  ->  trev index (Tp - 1 - W) - (a - qo) + w, with the
        # start clamped like lax.dynamic_slice_in_dim (a clamped start only
        # occurs where every cell of the step is outside the target)
        ts = min(max((Tp - 1 - W) - (a - qo), 0), Tp - W)
        twin = trev[:, ts : ts + W]
        if mode == "none":
            x_cell, ins_cell = x_sc, ins_sc
        else:
            quwin = quext[:, qo : qo + W]
            lo, hi = (quwin & 255, quwin >> 8) if mode == "dual" else (quwin, quwin)
            x_cell = qv_scaled_costs(x_sc, lo)
            ins_cell = qv_scaled_costs(ins_sc, hi)

        q_pos = qo + w_ar
        t_pos = a - q_pos
        valid = (q_pos < qlen_c) & (t_pos >= tlo_c) & (t_pos < thi_c) & (t_pos >= 0)

        eq = (qwin == twin) & (qwin < 4)
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
