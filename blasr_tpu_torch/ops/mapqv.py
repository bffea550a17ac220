"""Mapping quality, decision for decision as the reference StoreMapQVs.

Port of ``blasr_tpu.ops.mapqv.map_qv_reference``: rescore every candidate
with the SMRT log-probability matrix, greedily partition candidates that
overlap on the forward read, take each partition's interval, charge
members for uncovered flanks, sum a running log10 denominator under the
nMatch*1.2 gate, and convert to Phred capped at 254. The per-candidate
loops are unrolled over the small candidate axis, in the JAX order.

The float arithmetic is the JAX function's as XLA compiles it under
``jax.jit`` on the CPU: a division by a constant becomes a multiply by its
float32 reciprocal, ``-10 log10`` one multiply of the log, the log10-sum's
multiply and add one multiply-add, and ``exp``, ``log1p``, ``log`` and
``pow`` XLA's own functions (``ops/xla_math.py``). So a mapping quality
whose float lies within a few ulps of an integer truncates as the JAX
package's does, on the CPU and on the card.

``map_qv_reference`` is what the mapper calls. On CUDA tensors it launches
the hand-written kernel ``csrc/mapqv.cu`` (one thread per read, one launch
a call, no wait for the device) or raises, and counts its launches in
``map_qv_reference.launches``. On CPU tensors it runs ``map_qv_float``,
which defines the result bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from blasr_tpu_torch.ops import COUNT_LOCK, _build
from blasr_tpu_torch.ops.banded_cuda import check_tensor
from blasr_tpu_torch.ops.xla_math import INV_LN10, fma_f32, pow10, xla_exp, xla_log, xla_log1p

LOG10 = 2.302585092994046
_f32 = np.float32
INV_TEN = float(_f32(0.1))                     # x / 10.0
INV_LOG10 = float(_f32(1) / _f32(LOG10))       # x / LOG10
MINUS_TEN_INV_LN10 = float(_f32(-10) * _f32(INV_LN10))   # -10 * log10(x) = log(x) * this
MAX_PHRED = 254
WIGGLE = 5          # MAPQV_END_ALIGN_WIGGLE
MIN_OVERLAP = 0.75  # minFractionToBeConsideredOverlapping


def map_qv_reference(
    scores: torch.Tensor,      # (B, CD) int32 DP scores (minimization)
    valid: torch.Tensor,       # (B, CD) bool
    q_lo: torch.Tensor,        # (B, CD) int32 forward-read aligned start
    q_hi: torch.Tensor,        # (B, CD) int32 forward-read aligned end
    n_match: torch.Tensor,
    n_mismatch: torch.Tensor,
    n_ins: torch.Tensor,
    n_del: torch.Tensor,
    *,
    mismatch_prob: int = 15,
    ins_cost: int = 5,
    del_cost: int = 5,
) -> torch.Tensor:
    """Per-candidate mapQV (B, CD) int32: ``map_qv_float`` clamped to
    [0, 254] and truncated; on CUDA tensors from one launch of
    ``csrc/mapqv.cu`` (``map_qv_kernel``), on CPU tensors from the plain
    version."""
    args = (scores, valid, q_lo, q_hi, n_match, n_mismatch, n_ins, n_del)
    costs = dict(mismatch_prob=mismatch_prob, ins_cost=ins_cost, del_cost=del_cost)
    if scores.is_cuda:
        return map_qv_kernel(*args, **costs)[0]
    return torch.clamp(map_qv_float(*args, **costs), 0, MAX_PHRED).to(torch.int32)


map_qv_reference.launches = 0


def map_qv_kernel(
    scores: torch.Tensor,
    valid: torch.Tensor,
    q_lo: torch.Tensor,
    q_hi: torch.Tensor,
    n_match: torch.Tensor,
    n_mismatch: torch.Tensor,
    n_ins: torch.Tensor,
    n_del: torch.Tensor,
    *,
    mismatch_prob: int = 15,
    ins_cost: int = 5,
    del_cost: int = 5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``map_qv_reference``'s (B, CD) int32 result and ``map_qv_float``'s
    (B, CD) float32 one, from one launch of ``csrc/mapqv.cu`` on the
    scores' device and its current stream.

    Takes contiguous (B, CD) tensors on one CUDA device: ``valid`` bool, the
    others int32; raises on anything else. The kernel's per-candidate
    arrays go to a scratch tensor allocated here. Nothing here waits for
    the device; the launch counts in ``map_qv_reference.launches``.
    """
    if scores.dim() != 2:
        raise ValueError(f"scores: expected (B, CD), got {tuple(scores.shape)}")
    B, CD = scores.shape
    dev = scores.device
    i32 = torch.int32
    ins = (("scores", scores, i32), ("valid", valid, torch.bool), ("q_lo", q_lo, i32),
           ("q_hi", q_hi, i32), ("n_match", n_match, i32), ("n_mismatch", n_mismatch, i32),
           ("n_ins", n_ins, i32), ("n_del", n_del, i32))
    for name, t, dtype in ins:
        check_tensor(name, t, dtype, (B, CD))
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the scores on {dev}")
    lib = _build.load_library()
    out = torch.empty((B, CD), dtype=i32, device=dev)
    q_float = torch.empty((B, CD), dtype=torch.float32, device=dev)
    scratch = torch.empty(lib.mapqv_scratch_words(B, CD), dtype=i32, device=dev)
    err = lib.mapqv_launch(
        *(t.data_ptr() for _, t, _ in ins), mismatch_prob, ins_cost, del_cost,
        out.data_ptr(), q_float.data_ptr(), scratch.data_ptr(),
        B, CD, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, f"mapqv (B={B}, CD={CD})")
    with COUNT_LOCK:
        map_qv_reference.launches += 1
    return out, q_float


def map_qv_float(
    scores: torch.Tensor,
    valid: torch.Tensor,
    q_lo: torch.Tensor,
    q_hi: torch.Tensor,
    n_match: torch.Tensor,
    n_mismatch: torch.Tensor,
    n_ins: torch.Tensor,
    n_del: torch.Tensor,
    *,
    mismatch_prob: int = 15,
    ins_cost: int = 5,
    del_cost: int = 5,
) -> torch.Tensor:
    """Per-candidate mapping quality (B, CD) float32 before the clamp to
    [0, 254] and the truncation to an integer."""
    i32, f32 = torch.int32, torch.float32
    B, CD = scores.shape
    dev = scores.device
    NEG = -1e30

    prob = -(
        mismatch_prob * n_mismatch + ins_cost * n_ins + del_cost * n_del
    ).to(f32) * INV_TEN

    order = torch.argsort(torch.where(valid, scores, 2**30), dim=1, stable=True)

    def take(x):
        return torch.gather(x, 1, order)

    v = take(valid)
    lo = take(q_lo).to(i32)
    hi = take(q_hi).to(i32)
    nm = take(n_match).to(f32)
    pr = take(prob)

    def overlaps(i, j):
        ai, bi = lo[:, i], hi[:, i]
        aj, bj = lo[:, j], hi[:, j]
        contain = ((ai <= aj) & (bi >= bj)) | ((aj <= ai) & (bj >= bi))
        ovp = torch.clamp(torch.minimum(bi, bj) - torch.maximum(ai, aj), min=0).to(f32)
        li = torch.clamp(bi - ai, min=1).to(f32)
        lj = torch.clamp(bj - aj, min=1).to(f32)
        frac = torch.maximum(ovp / li, ovp / lj)
        return contain | (frac > MIN_OVERLAP)

    pid_cols = [torch.zeros(B, dtype=i32, device=dev)]
    for i in range(1, CD):
        best_pid = torch.full((B,), i, dtype=i32, device=dev)
        for j in range(i - 1, -1, -1):
            ov = overlaps(i, j) & v[:, j] & v[:, i]
            best_pid = torch.where(ov, torch.minimum(best_pid, pid_cols[j]), best_pid)
        pid_cols.append(best_pid)
    pid = torch.stack(pid_cols, dim=1)
    pid = torch.where(v, pid, -1)

    pbeg_p, pend_p = [], []
    for p in range(CD):
        member = (pid == p) & v
        cur_b = torch.zeros(B, dtype=i32, device=dev)
        cur_e = torch.zeros(B, dtype=i32, device=dev)
        cur_s = torch.zeros(B, dtype=f32, device=dev)
        started = torch.zeros(B, dtype=torch.bool, device=dev)
        for m in range(CD):
            is_m = member[:, m]
            wider = (hi[:, m] - lo[:, m]) > (cur_e - cur_b)
            gate = nm[:, m] * 1.2 >= cur_s
            repl = is_m & (~started | (wider & gate))
            cur_b = torch.where(repl, lo[:, m], cur_b)
            cur_e = torch.where(repl, hi[:, m], cur_e)
            cur_s = torch.where(repl, nm[:, m], cur_s)
            started = started | is_m
        pbeg_p.append(cur_b)
        pend_p.append(cur_e)
    pbeg = torch.stack(pbeg_p, dim=1)
    pend = torch.stack(pend_p, dim=1)

    pidc = torch.clamp(pid, 0, CD - 1).long()
    my_beg = torch.gather(pbeg, 1, pidc)
    my_end = torch.gather(pend, 1, pidc)

    flank = (lo - my_beg) + (my_end - hi)
    wiggle = ((lo - my_beg) > WIGGLE) | ((my_end - hi) > WIGGLE)
    pr = pr + torch.where(
        wiggle & v, -0.5 * 15.0 * torch.clamp(flank, min=0).to(f32), 0.0
    )

    # the log10-sum denominator of every partition at once: partitions
    # along dim 1, members taken in order
    member = (pid[:, None, :] == torch.arange(CD, device=dev)[None, :, None]) & v[:, None, :]
    denom = torch.full((B, CD), NEG, dtype=f32, device=dev)
    maxnm = torch.zeros((B, CD), dtype=f32, device=dev)
    started = torch.zeros((B, CD), dtype=torch.bool, device=dev)
    for m in range(CD):
        is_m = member[:, :, m]
        nm_m, pr_m = nm[:, m : m + 1], pr[:, m : m + 1]
        first = is_m & ~started
        maxnm = torch.where(is_m, torch.maximum(maxnm, nm_m), maxnm)
        gate = nm_m * 1.2 >= maxnm
        add = first | (is_m & gate)
        mx = torch.maximum(denom, pr_m)
        mn = torch.minimum(denom, pr_m)
        lp = xla_log1p(xla_exp((mn - mx) * LOG10))
        summed = fma_f32(lp, INV_LOG10, mx)
        denom = torch.where(add, torch.where(first, pr_m, summed), denom)
        started = started | is_m
    denom = torch.gather(denom, 1, pidc)
    psize = torch.gather(torch.sum(member, dim=2).to(i32), 1, pidc)

    sub = pr - denom
    expo = pow10(sub)
    one_minus = 1.0 - expo
    q = torch.where(
        one_minus <= 0.0,
        float(MAX_PHRED),
        xla_log(torch.clamp(one_minus, min=1e-30)) * MINUS_TEN_INV_LN10,
    )
    q = torch.where(sub < -20.0, 0.0, q)
    q = torch.where(psize <= 1, float(MAX_PHRED), q)

    inv = torch.argsort(order, dim=1, stable=True)
    return torch.gather(q, 1, inv)
