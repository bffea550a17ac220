"""Per-item span and row gathers: wrappers over ``csrc/gather.cu`` and their
plain versions.

``gather_spans`` fetches each DP item's window of the nibble-packed genome
words, ``gather_rows`` each item's packed query row and its fused anchor
row (``pipeline/mapper.py``). On a CUDA tensor a wrapper launches its
kernel (or raises); on a CPU tensor it runs the plain version.

The wrappers are the launch path of two kernels that each move well under
a megabyte, so they keep the host's work per call small: the launchers
and PyTorch's raw current-stream getter are bound once (``_bind``) and
the output comes from ``new_empty``. ``vector_width`` picks the row
gather's int4 or scalar instance from the base addresses and the row
length.

Out-of-range handling follows the XLA formulation of the JAX mapper:
``gather_spans`` clips every ELEMENT index to ``[0, N-1]`` (never the
start, so a window past the slack reads the pad words instead of a shifted
window), ``gather_rows`` clips the row index to ``[0, R-1]``.
"""

from __future__ import annotations

import torch

from blasr_tpu_torch.ops import COUNT_LOCK, _build


def gather_spans_plain(src: torch.Tensor, starts: torch.Tensor, span: int) -> torch.Tensor:
    N = src.shape[0]
    idx = starts.to(torch.int64)[:, None] + torch.arange(
        span, dtype=torch.int64, device=src.device
    )[None, :]
    return src[torch.clamp(idx, 0, N - 1)]


def gather_rows_plain(src2d: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    R = src2d.shape[0]
    return src2d[torch.clamp(rows.to(torch.int64), 0, R - 1)]


def vector_width(src_ptr: int, out_ptr: int, row_words: int) -> int:
    """The instance of the row gather a call takes: 4 (16-byte loads and
    stores) when both base addresses are 16-byte aligned and the row length
    ``row_words`` is a multiple of 4, else 1 (4-byte accesses)."""
    return 4 if ((src_ptr | out_ptr) & 15) == 0 and row_words % 4 == 0 else 1


def _check_int32(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype != torch.int32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d int32 tensor, got "
            f"{t.dtype} of shape {tuple(t.shape)}"
        )


_bound = None  # (gather_spans_launch, gather_rows_launch, raw stream getter), bound at first use


def _bind() -> tuple:
    global _bound
    lib = _build.load_library()
    _bound = (lib.gather_spans_launch, lib.gather_rows_launch,
              torch._C._cuda_getCurrentRawStream)
    return _bound


def gather_spans(src: torch.Tensor, starts: torch.Tensor, span: int) -> torch.Tensor:
    """out[i, :] = src[clip(starts[i] + j, 0, N-1) for j < span]; (I, span) int32."""
    if not src.is_cuda:
        return gather_spans_plain(src, starts, span)
    _check_int32("src", src, 1)
    _check_int32("starts", starts, 1)
    if starts.device != src.device:
        raise ValueError("src and starts must be on the same device")
    if src.shape[0] == 0:
        raise ValueError("src is empty")
    if span <= 0:
        raise ValueError(f"span must be positive, got {span}")
    I = starts.shape[0]
    out = src.new_empty((I, span))
    if I == 0:
        return out
    launch, _, stream = _bound or _bind()
    err = launch(src.data_ptr(), src.shape[0], starts.data_ptr(), out.data_ptr(), I, span,
                 stream(src.get_device()))
    _build.check(err, "gather_spans")
    with COUNT_LOCK:
        gather_spans.launches += 1
    return out


def gather_rows(src2d: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """out[i, :] = src2d[clip(rows[i], 0, R-1), :]; (I, Lr) int32."""
    if not src2d.is_cuda:
        return gather_rows_plain(src2d, rows)
    _check_int32("src2d", src2d, 2)
    _check_int32("rows", rows, 1)
    if rows.device != src2d.device:
        raise ValueError("src2d and rows must be on the same device")
    R, Lr = src2d.shape
    if R == 0:
        raise ValueError("src2d has no rows")
    I = rows.shape[0]
    out = src2d.new_empty((I, Lr))
    if I == 0 or Lr == 0:
        return out
    _, launch, stream = _bound or _bind()
    sp, op = src2d.data_ptr(), out.data_ptr()
    vec = vector_width(sp, op, Lr)
    err = launch(sp, R, Lr, rows.data_ptr(), op, I, vec, stream(src2d.get_device()))
    _build.check(err, "gather_rows")
    with COUNT_LOCK:
        gather_rows.launches += 1
        gather_rows.launches_by_path[vec] += 1
    return out


# launches in all, and of the row gather by instance: 4 (int4) or 1 (scalar)
gather_spans.launches = 0
gather_rows.launches = 0
gather_rows.launches_by_path = {4: 0, 1: 0}
