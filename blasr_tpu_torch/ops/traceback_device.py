"""Traceback walk over the stored arrow words.

Port of ``blasr_tpu.ops.traceback_device`` for unpacked arrows (``pack=1``):
the walk chases each alignment's path back from its best cell, jumping
whole diagonal runs in one sub-step and tallying match/mismatch/indel
counts from the arrow words. Each emitted run is written as a boundary
code ``((p + 1) << 2) | op`` at its expanded op position ``p`` (END->START
order); ``pack_codes_rows`` turns selected rows into the 2-bit wire format.

``walk_arrows_device`` is what the mapper calls. On CUDA tensors it
launches the hand-written kernel ``csrc/traceback_walk.cu`` (one thread per
item, one launch a call, no wait for the device) or raises, and counts its
launches in ``walk_arrows_device.launches``. On CPU tensors it runs
``walk_arrows_plain``, which defines the result bit for bit: plain PyTorch,
all items in lockstep, a Python loop of up to ceil((2S+4)/8) iterations of
eight sub-steps that stops as soon as no item is active. That check waits
for the device; ``walk_arrows_device.syncs`` counts the checks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from blasr_tpu_torch.ops import COUNT_LOCK, _build, sync_site
from blasr_tpu_torch.ops.banded_cuda import check_tensor
from blasr_tpu_torch.ops.banded_align import (
    KNOT_LOG2,
    KNOT_SPACING,
    QOFF_NUM_HALF,
    QOFF_SHIFT,
    SRC_DIAG,
    SRC_DIAG_START,
    SRC_E,
    SRC_F,
    SRC_LEFT,
    SRC_STOP,
    SRC_UP,
    n_knots,
)

OP_NONE, OP_M, OP_I, OP_D = 0, 1, 2, 3
WALK_UNROLL = 8  # sub-steps per loop iteration (one activity check each)
# the arrow word's fields past its 3-bit source (ops/banded_align.py)
SRC_MASK = 7
E_SHIFT, F_SHIFT = 3, 4
RUN_SHIFT, RUN_MASK = 5, 63
MIS_SHIFT = 11
BANDS = ("drift", "knots", "table")  # the kernel's band-offset forms, in C order


class DeviceTraceback(NamedTuple):
    moves_codes: torch.Tensor | None  # (I, 4*packed_width(S)+1) int32 or None
    nops: torch.Tensor        # (I,) int32
    q_start: torch.Tensor     # (I,) int32
    q_end: torch.Tensor
    t_start: torch.Tensor
    t_end: torch.Tensor
    n_match: torch.Tensor
    n_mismatch: torch.Tensor
    n_ins: torch.Tensor
    n_del: torch.Tensor


def packed_width(S: int) -> int:
    S2 = S + 3
    return (S2 + 3) // 4


def walk_iterations(S: int) -> int:
    """The plain walk's loop cap: ceil((2S + 4) / WALK_UNROLL) iterations,
    WALK_UNROLL sub-steps each (the kernel's cap of sub-steps is the same)."""
    return -(-(2 * S + 4) // WALK_UNROLL)


def walk_arrows_plain(
    arrows: torch.Tensor,   # (S, I, W) uint16
    qoff: torch.Tensor,     # (S,) int32
    best_a: torch.Tensor,   # (I,) int32
    best_w: torch.Tensor,   # (I,) int32
    scores: torch.Tensor,   # (I,) int32 (< 0 where an alignment exists)
    qoff_params: tuple[int, int, int] | None = None,  # (diag, W_band, L_q)
    qoff_num: torch.Tensor | int | None = None,
    with_moves: bool = True,
    qoff_knots: torch.Tensor | None = None,  # (I, NK) per-item guided knots
) -> DeviceTraceback:
    """Walk the I paths of an (S, I, W) arrow tensor, one per item.

    With ``qoff_knots`` each item's band offsets are its knot lerp, the
    formula of ``banded_align.qoff_from_knots`` evaluated per (item, step)
    (two knot gathers per evaluation). Otherwise, with ``qoff_params`` they
    are evaluated in closed form: the drift-slope schedule of ``qoff_num``
    (slope 0 when it is None); without either they are read from ``qoff``.
    ``with_moves=False`` skips the boundary-code matrix (the -m 4 path
    needs only the stats). Runs on any device; each activity check counts
    in ``walk_arrows_device.syncs``.
    """
    S, I, W = arrows.shape
    dev = arrows.device
    i32 = torch.int32
    ii = torch.arange(I, dtype=torch.int64, device=dev)
    flat = arrows.reshape(-1).view(torch.int16)

    if qoff_knots is not None:
        NK = qoff_knots.shape[1]
        kflat = qoff_knots.to(i32).reshape(-1)
        base = ii * NK

        def qoff_at(a):
            ac_ = torch.clamp(a, 0, S - 1)
            j = (ac_ >> KNOT_LOG2).long()
            r = ac_ & (KNOT_SPACING - 1)
            k0 = kflat[base + j]
            k1 = kflat[base + torch.clamp(j + 1, max=NK - 1)]
            return ((k0 * (KNOT_SPACING - r) + k1 * r) >> KNOT_LOG2).to(i32)

        def s1_at(a):
            return qoff_at(a) - qoff_at(a - 1)

    elif qoff_params is not None:
        diag0, Wb, Lq = qoff_params
        hi = max(0, Lq - Wb)
        numc = torch.as_tensor(
            QOFF_NUM_HALF if qoff_num is None else qoff_num, dtype=i32, device=dev
        )

        def qoff_at(a):
            cq = ((a - diag0) * numc) >> QOFF_SHIFT  # arithmetic shift floors
            return torch.clamp(cq - Wb // 2, 0, hi).to(i32)

        def s1_at(a):
            return qoff_at(a) - qoff_at(a - 1)

    else:
        q32 = qoff.to(i32)
        s1_tab = torch.diff(q32, prepend=q32[:1]).to(i32)

        def qoff_at(a):
            return q32[torch.clamp(a, 0, S - 1).long()]

        def s1_at(a):
            return s1_tab[torch.clamp(a, 0, S - 1).long()]

    NIT = walk_iterations(S)
    OW = packed_width(S)
    S2 = 4 * OW

    a = best_a.to(i32).clone()
    w = best_w.to(i32).clone()
    st = torch.zeros(I, dtype=i32, device=dev)
    active = scores < 0
    zeros = torch.zeros(I, dtype=i32, device=dev)
    nmatch, nmis, nins, ndel = zeros.clone(), zeros.clone(), zeros.clone(), zeros.clone()
    mv = torch.zeros((I, S2 + 1), dtype=i32, device=dev) if with_moves else None
    mp = zeros.clone()

    for _ in range(NIT):
        with COUNT_LOCK:
            walk_arrows_device.syncs += 1
        if not bool(active.any()):
            break
        idxs, vals = [], []
        for _ in range(WALK_UNROLL):
            ac = torch.clamp(a, 0, S - 1)
            wc = torch.clamp(w, 0, W - 1)
            word = flat[(ac.long() * I + ii) * W + wc.long()].to(i32) & 0xFFFF
            src = word & SRC_MASK
            ebit = (word >> E_SHIFT) & 1
            fbit = (word >> F_SHIFT) & 1
            run = (word >> RUN_SHIFT) & RUN_MASK
            mcount = word >> MIS_SHIFT
            cs1 = s1_at(ac)

            is_h = st == 0
            is_e = st == 1
            is_f = st == 2
            diag = is_h & ((src == SRC_DIAG) | (src == SRC_DIAG_START))
            up = is_h & (src == SRC_UP)
            left = is_h & (src == SRC_LEFT)
            to_e = is_h & (src == SRC_E)
            to_f = is_h & (src == SRC_F)
            h_stop = is_h & (src == SRC_STOP)
            is_start = is_h & (src == SRC_DIAG_START)
            r_eff = torch.where(
                diag, torch.where(is_start, 1, torch.clamp(run, min=1)), 0
            ).to(i32)
            ins_op = up | is_f
            del_op = left | is_e
            op = torch.where(
                diag, OP_M,
                torch.where(ins_op, OP_I, torch.where(del_op, OP_D, OP_NONE)),
            ).to(i32)
            cnt = torch.where(diag, r_eff, (op > 0).to(i32))

            da = torch.where(
                diag, -2 * r_eff, torch.where(to_e | to_f | h_stop, 0, -1)
            ).to(i32)
            dw_diag = qoff_at(ac) - qoff_at(ac - 2 * r_eff) - r_eff
            dw = torch.where(
                diag, dw_diag,
                torch.where(ins_op, cs1 - 1, torch.where(del_op, cs1, 0)),
            ).to(i32)
            new_st = torch.where(
                is_h,
                torch.where(to_e, 1, torch.where(to_f, 2, 0)),
                torch.where(
                    is_e, torch.where(ebit == 1, 1, 0),
                    torch.where(fbit == 1, 2, 0),
                ),
            ).to(i32)
            stop = is_start | h_stop

            cnt = torch.where(active, cnt, 0)
            live = active.to(i32)
            nmatch = nmatch + live * torch.where(diag, r_eff - mcount, 0)
            nmis = nmis + live * torch.where(diag, mcount, 0)
            nins = nins + live * ins_op.to(i32)
            ndel = ndel + live * del_op.to(i32)
            a = torch.where(active, a + da, a)
            w = torch.where(active, w + dw, w)
            st = torch.where(active, new_st, st)
            active = active & ~stop & (a >= 0) & (w >= 0) & (w < W)
            if with_moves:
                emit = cnt > 0
                idxs.append(torch.where(emit, torch.clamp(mp, max=S2 - 1), S2))
                vals.append(torch.where(emit, ((mp + 1) << 2) | op, 0))
            mp = mp + cnt
        if with_moves:
            # collisions only on the dump column S2, where every value is 0
            mv.scatter_(
                1, torch.stack(idxs, dim=1).long(), torch.stack(vals, dim=1).to(i32)
            )

    n_mops = nmatch + nmis
    q_end = qoff_at(torch.clamp(best_a.to(i32), 0, S - 1)) + best_w.to(i32) + 1
    t_end = best_a.to(i32) - (q_end - 1) + 1
    q_start = q_end - (n_mops + nins)
    t_start = t_end - (n_mops + ndel)
    return DeviceTraceback(
        moves_codes=mv,
        nops=(n_mops + nins + ndel).to(i32),
        q_start=q_start.to(i32),
        q_end=q_end.to(i32),
        t_start=t_start.to(i32),
        t_end=t_end.to(i32),
        n_match=nmatch.to(i32),
        n_mismatch=nmis.to(i32),
        n_ins=nins.to(i32),
        n_del=ndel.to(i32),
    )


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, dev: torch.device) -> None:
    check_tensor(name, t, dtype, shape)
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the arrows on {dev}")


@sync_site("walk")
def walk_arrows_device(
    arrows: torch.Tensor,   # (S, I, W) uint16
    qoff: torch.Tensor,     # (S,) int32
    best_a: torch.Tensor,   # (I,) int32
    best_w: torch.Tensor,   # (I,) int32
    scores: torch.Tensor,   # (I,) int32 (< 0 where an alignment exists)
    qoff_params: tuple[int, int, int] | None = None,  # (diag, W_band, L_q)
    qoff_num: torch.Tensor | int | None = None,
    with_moves: bool = True,
    qoff_knots: torch.Tensor | None = None,  # (I, NK) per-item guided knots
) -> DeviceTraceback:
    """``walk_arrows_plain``'s result: on CUDA tensors from one launch of
    ``csrc/traceback_walk.cu`` on the arrows' device and its current
    stream, on CPU tensors from ``walk_arrows_plain``.

    The kernel takes int32 contiguous (I,) ``best_a``, ``best_w`` and
    ``scores`` on the arrows' device, and its band in the form the plain
    walk would use: ``qoff_knots`` (I, n_knots(S)) int32; else
    ``qoff_params`` with ``qoff_num`` a Python int, None (slope 0) or a
    one-element int32 tensor, which the kernel reads on the device; else
    ``qoff`` (S,) int32. Nothing here waits for the device.
    """
    if not arrows.is_cuda:
        return walk_arrows_plain(arrows, qoff, best_a, best_w, scores, qoff_params,
                                 qoff_num, with_moves, qoff_knots)
    S, I, W = arrows.shape
    dev = arrows.device
    i32 = torch.int32
    _check("arrows", arrows, torch.uint16, (S, I, W), dev)
    for name, t in (("best_a", best_a), ("best_w", best_w), ("scores", scores)):
        _check(name, t, i32, (I,), dev)
    table = knots = num_ptr = None
    nk = num = diag = half = hi = 0
    if qoff_knots is not None:
        band, nk, knots = "knots", n_knots(S), qoff_knots
        _check("qoff_knots", knots, i32, (I, nk), dev)
    elif qoff_params is not None:
        band = "drift"
        diag, Wb, Lq = qoff_params
        half, hi = Wb // 2, max(0, Lq - Wb)
        if isinstance(qoff_num, torch.Tensor) and qoff_num.is_cuda:
            if qoff_num.dtype != i32 or qoff_num.numel() != 1 or qoff_num.device != dev:
                raise ValueError(
                    f"qoff_num: expected one int32 value on {dev}, got {qoff_num.dtype} "
                    f"of shape {tuple(qoff_num.shape)} on {qoff_num.device}")
            num_ptr = qoff_num
        else:
            num = QOFF_NUM_HALF if qoff_num is None else int(qoff_num)
    else:
        band, table = "table", qoff
        _check("qoff", table, i32, (S,), dev)
    out = torch.empty((9, I), dtype=i32, device=dev)
    mv = torch.zeros((I, 4 * packed_width(S) + 1), dtype=i32, device=dev) if with_moves else None
    err = _build.load_library().traceback_walk_launch(
        arrows.data_ptr(), best_a.data_ptr(), best_w.data_ptr(), scores.data_ptr(),
        BANDS.index(band),
        table.data_ptr() if table is not None else None,
        knots.data_ptr() if knots is not None else None, nk,
        num_ptr.data_ptr() if num_ptr is not None else None, num, diag, half, hi,
        out.data_ptr(), mv.data_ptr() if mv is not None else None,
        mv.shape[1] if mv is not None else 0,
        I, S, W, walk_iterations(S) * WALK_UNROLL,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, f"traceback_walk (W={W}, {band}{', moves' if with_moves else ''})")
    with COUNT_LOCK:
        walk_arrows_device.launches += 1
    return DeviceTraceback(mv, *out)


walk_arrows_device.launches = 0


def pack_codes_rows(codes: torch.Tensor, nops: torch.Tensor, out_width: int) -> torch.Tensor:
    """Expand (I2, >= 4*out_width) boundary-code rows into the 2-bit per-op
    wire format (I2, out_width) uint8: a row-wise cummax fills every run with
    its covering code, positions at or past ``nops`` are zeroed, 4 ops per
    byte."""
    I2 = codes.shape[0]
    S2 = 4 * out_width
    filled = torch.cummax(codes[:, :S2], dim=1).values
    pos = torch.arange(S2, dtype=torch.int32, device=codes.device)[None, :]
    expanded = torch.where(pos < nops[:, None], filled & 3, 0)
    mvp = expanded.reshape(I2, out_width, 4)
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.int32, device=codes.device)
    return torch.sum(mvp << shifts[None, None, :], dim=2).to(torch.uint8)
