"""The banded DP on the card: wrapper over ``csrc/banded_dp.cu``.

``banded_align`` is what the mapper calls. On CUDA tensors it launches the
hand-written kernel (one thread block per item, one thread per band cell,
the S anti-diagonal steps looped inside the block) or raises; on CPU
tensors it runs the plain version, ``ops/banded_align.banded_align_plain``,
which defines the result bit for bit. The quality mode follows ``qual``'s
dtype (``banded_align.qual_mode``): none, single (uint8) or dual (int16
holding the uint16 bits). The band follows either the shared schedule
``qoff`` (S,) or, guided, each item's knots (I, NK) (``knots=``; the kernel
evaluates ``qoff_from_knots`` per step). ``scores.matrix`` switches the
substitution score to the 5x5 matrix.

``launches_by_shape[(W, mode)]`` counts the kernel's launches per band
width and quality mode; ``launches_by_shape[(W, "guided")]`` and
``[(W, "matrix")]`` count, in addition, the launches with knots and with a
matrix. ``max_arrow_bytes`` is the largest (S, I, W) arrow tensor a call
made, on either path: the DP's share of a batch's device memory.
"""

from __future__ import annotations

import ctypes

import torch

from blasr_tpu_torch.ops import COUNT_LOCK, _build
from blasr_tpu_torch.ops.banded_align import (
    AlignScores,
    BandedResult,
    banded_align_plain,
    n_knots,
    qoff_from_knots,
    qual_mode,
)

BAND_WIDTHS = (32, 64, 128, 256)     # the kernel's template instances
QUAL_MODES = ("none", "single", "dual")  # and its quality modes, in C order
SWITCHES = ("guided", "matrix")      # and its band and score switches


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {shape}, got {t.dtype} "
            f"{tuple(t.shape)}{'' if t.is_contiguous() else ' (non-contiguous)'}"
        )


def banded_align(
    query: torch.Tensor,    # (I, L) uint8 codes 0..4
    qlen: torch.Tensor,     # (I,) int32
    target: torch.Tensor,   # (I, T) uint8 codes 0..5
    tlo: torch.Tensor,      # (I,) int32
    thi: torch.Tensor,      # (I,) int32
    qoff: torch.Tensor | None,  # (S,) int32 shared band schedule, or None
    qual: torch.Tensor | None = None,  # (I, L) uint8, or int16 (dual)
    *,
    knots: torch.Tensor | None = None,  # (I, NK) int32 per-item guided knots
    scores: AlignScores = AlignScores(),
    with_traceback: bool = False,
    band_width: int = 128,
) -> BandedResult:
    if (qoff is None) == (knots is None):
        raise ValueError("give exactly one band schedule: qoff (shared) or knots (guided)")
    if qoff is not None and qoff.dim() != 1:
        raise ValueError("qoff is the shared (S,) schedule; a guided band takes knots=")
    if scores.matrix is not None and len(scores.matrix) != 25:
        raise ValueError(f"scores.matrix: expected 25 values, got {len(scores.matrix)}")
    I, L = query.shape
    T = target.shape[1]
    S = L + T - 1
    if not query.is_cuda:
        sched = qoff if knots is None else qoff_from_knots(knots, S)
        res = banded_align_plain(
            query, qlen, target, tlo, thi, sched, qual,
            scores=scores, with_traceback=with_traceback, band_width=band_width,
        )
        _note_arrows(res.arrows)
        return res
    mode = qual_mode(qual)
    W = band_width
    if W not in BAND_WIDTHS:
        raise ValueError(f"band_width {W} not in {BAND_WIDTHS}")
    check_tensor("query", query, torch.uint8, (I, L))
    check_tensor("qlen", qlen, torch.int32, (I,))
    check_tensor("target", target, torch.uint8, (I, T))
    check_tensor("tlo", tlo, torch.int32, (I,))
    check_tensor("thi", thi, torch.int32, (I,))
    tensors = [("qlen", qlen), ("target", target), ("tlo", tlo), ("thi", thi)]
    if knots is None:
        check_tensor("qoff", qoff, torch.int32, (S,))
        tensors.append(("qoff", qoff))
        NK = 0
    else:
        NK = n_knots(S)
        check_tensor("knots", knots, torch.int32, (I, NK))
        tensors.append(("knots", knots))
    if qual is not None:
        check_tensor("qual", qual, qual.dtype, (I, L))
        tensors.append(("qual", qual))
    dev = query.device
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, query on {dev}")
    best = torch.empty((3, I), dtype=torch.int32, device=dev)
    arrows = (
        torch.empty((S, I, W), dtype=torch.uint16, device=dev)
        if with_traceback else None
    )
    _note_arrows(arrows)
    if I == 0:
        return BandedResult(best[0], best[1], best[2], arrows)
    lib = _build.load_library()
    matrix = (ctypes.c_int * 25)(*scores.matrix) if scores.matrix is not None else None
    err = lib.banded_dp_launch(
        query.data_ptr(), qlen.data_ptr(), target.data_ptr(),
        tlo.data_ptr(), thi.data_ptr(),
        qoff.data_ptr() if knots is None else None,
        knots.data_ptr() if knots is not None else None, NK,
        qual.data_ptr() if qual is not None else None, QUAL_MODES.index(mode),
        best.data_ptr(), arrows.data_ptr() if with_traceback else None,
        I, L, T, S, W,
        scores.match, scores.mismatch, scores.n_score,
        scores.insertion, scores.deletion,
        scores.affine_open, scores.affine_extend, matrix,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    what = ", ".join(["quality " + mode]
                     + (["guided"] if knots is not None else [])
                     + (["matrix"] if matrix is not None else []))
    _build.check(err, f"banded_dp (W={W}, {what})")
    with COUNT_LOCK:
        banded_align.launches += 1
        banded_align.launches_by_shape[(W, mode)] += 1
        if knots is not None:
            banded_align.launches_by_shape[(W, "guided")] += 1
        if matrix is not None:
            banded_align.launches_by_shape[(W, "matrix")] += 1
    return BandedResult(best[0], best[1], best[2], arrows)


def _note_arrows(arrows: torch.Tensor | None) -> None:
    if arrows is not None:
        with COUNT_LOCK:
            banded_align.max_arrow_bytes = max(banded_align.max_arrow_bytes,
                                               arrows.numel() * arrows.element_size())


banded_align.launches = 0
banded_align.max_arrow_bytes = 0
banded_align.launches_by_shape = {
    (w, m): 0 for w in BAND_WIDTHS for m in QUAL_MODES + SWITCHES
}
