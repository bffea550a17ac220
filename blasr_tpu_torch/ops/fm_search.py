"""Batched FM-index backward search and locate (the ``-bwt`` anchoring path).

Port of ``blasr_tpu.ops.fm_search`` (role of reference
``common/algorithms/anchoring/BWTSearch.h``:9-92 ``MapReadToGenome`` over
the FM-index: per read position backward-search the suffix, cap hits,
``Locate`` each), plain PyTorch as the JAX package's is plain XLA:

  * rank/occ = one 128-byte row gather from the (NB, 128) BWT, a compare
    and a masked sum, plus the row's checkpoint count
  * backward search runs k fixed steps vectorized over every (read,
    position) query at once
  * locate = an LF-walk of at most SAMPLE_D-1 steps (the sampled-SA
    stride), all queries in lockstep, with popcount-rank into the
    bit-packed sample mask

PyTorch has no unsigned 32-bit shifts on the CPU and no popcount, so the
sample mask is held as int64 words carrying the uint32 values and bits are
counted by a SWAR sequence (``popcount32``). Every result is an integer
and equals the JAX package's bit for bit. The output contract is that of
``ops/anchors.find_anchors``, so the rest of the mapping path is
index-agnostic.
"""

from __future__ import annotations

import torch

from blasr_tpu_torch.index.fm import ROW, SAMPLE_D, SENTINEL
from blasr_tpu_torch.ops.anchors import topk_desc

I32 = torch.int32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 element holding a uint32 value (int64)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def fm_occ(bwt_rows: torch.Tensor, occ_bins: torch.Tensor, c: torch.Tensor,
           i: torch.Tensor) -> torch.Tensor:
    """occ(c, i) = # of char c in bwt[0:i), vectorized over queries.

    c, i: int32 tensors of one shape (i >= 0); returns that shape, int32.
    i may equal n (interval end): when n is a multiple of ROW that lands
    one row past the table, so the row index clamps and the residual
    covers the whole final row (its padding value 6 never matches)."""
    NB = bwt_rows.shape[0]
    b = torch.div(i, ROW, rounding_mode="floor")
    bc = torch.clamp(b, max=NB - 1)
    r = i - bc * ROW                                     # ROW when clamped
    bcl = bc.long()
    rows = bwt_rows[bcl]                                 # (..., ROW) uint8
    lane = torch.arange(ROW, dtype=I32, device=i.device)
    within = torch.sum(
        (rows == c.to(torch.uint8)[..., None]) & (lane < r[..., None]),
        dim=-1, dtype=I32,
    )
    return occ_bins[bcl, c.long()] + within


def fm_count_kmers(
    bwt_rows: torch.Tensor,   # (NB, ROW) uint8
    occ_bins: torch.Tensor,   # (NB, 6) int32
    C: torch.Tensor,          # (7,) int32/int64
    codes: torch.Tensor,      # (B, L) uint8
    lengths: torch.Tensor,    # (B,) int32
    k: int,
    n: int,
    stride: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward-search the k-mer starting at every ``stride``-th read
    position: position i of the output is read position i*stride.

    Returns (lo, hi) int32 (B, ceil(L/stride)): the BWT row interval of
    suffixes prefixed by codes[b, i*stride : +k]; empty (lo == hi) where
    the window holds an N or runs past the read end."""
    B, L = codes.shape
    dev = codes.device
    st = max(1, stride)
    Ls = -(-L // st)
    ext = torch.full((B, L + k + st), 4, dtype=I32, device=dev)
    ext[:, :L] = codes.to(I32)
    lo = torch.zeros((B, Ls), dtype=I32, device=dev)
    hi = torch.full((B, Ls), n, dtype=I32, device=dev)
    Ci = C.to(I32)
    bad = torch.zeros((B, Ls), dtype=torch.bool, device=dev)
    for j in range(k - 1, -1, -1):
        c = ext[:, j::st][:, :Ls] if st > 1 else ext[:, j : j + L]
        bad = bad | (c >= 4)
        cbase = Ci[c.long()]
        lo = cbase + fm_occ(bwt_rows, occ_bins, c, lo)
        hi = cbase + fm_occ(bwt_rows, occ_bins, c, hi)
    pos = torch.arange(Ls, dtype=I32, device=dev)[None, :] * st
    bad = bad | (pos + k > lengths.to(I32)[:, None])
    return lo, torch.where(bad, lo, hi)


def fm_locate(
    bwt_rows: torch.Tensor,
    occ_bins: torch.Tensor,
    C: torch.Tensor,
    ssa_mask: torch.Tensor,   # (W32,) int64 holding the uint32 mask words
    ssa_base: torch.Tensor,   # (W32,) int32
    ssa_vals: torch.Tensor,   # (n_sampled,) int32/int64
    rows: torch.Tensor,       # (...,) int32 BWT rows to locate
) -> torch.Tensor:
    """Text position of each row (vectorized LF-walk, <= SAMPLE_D-1 steps),
    int32."""
    Ci = C.to(I32)
    nv = ssa_vals.shape[0]
    cur = rows.to(I32)
    pos = torch.zeros_like(cur)
    steps = torch.zeros_like(cur)
    done = torch.zeros(cur.shape, dtype=torch.bool, device=cur.device)
    for _ in range(SAMPLE_D):
        w = torch.div(cur, 32, rounding_mode="floor").long()
        b = (cur % 32).long()
        word = ssa_mask[w]
        hit = (((word >> b) & 1) == 1) & ~done
        below = word & ((torch.ones_like(b) << b) - 1)
        rank = ssa_base[w] + popcount32(below).to(I32)
        val = ssa_vals[torch.clamp(rank, 0, nv - 1).long()].to(I32)
        pos = torch.where(hit, val + steps, pos)
        done = done | hit
        # LF step for the queries still walking
        c = bwt_rows[torch.div(cur, ROW, rounding_mode="floor").long(), (cur % ROW).long()].to(I32)
        cc = torch.clamp(c, 0, 5)
        nxt = torch.where(
            c >= SENTINEL, 0, Ci[cc.long()] + fm_occ(bwt_rows, occ_bins, cc, cur)
        )
        cur = torch.where(done, cur, nxt)
        steps = steps + (~done).to(I32)
    return pos


def find_anchors_fm(
    codes: torch.Tensor,      # (B, L) uint8
    lengths: torch.Tensor,    # (B,) int32
    bwt_rows: torch.Tensor,
    occ_bins: torch.Tensor,
    C: torch.Tensor,
    ssa_mask: torch.Tensor,
    ssa_base: torch.Tensor,
    ssa_vals: torch.Tensor,
    pos_ok: torch.Tensor,     # (G,) bool anchor-seed validity (contig bounds)
    *,
    k: int,
    n: int,
    max_hits_per_pos: int = 8,
    max_anchors_per_read: int = 512,
    anchor_stride: int = 1,
):
    """FM-index anchor search with the ``find_anchors`` output contract:
    (t, q, nhits, valid), each (B, A)."""
    B, _ = codes.shape
    KH = max_hits_per_pos
    A = max_anchors_per_read
    G = n - 1
    dev = codes.device
    ST = max(1, anchor_stride)
    lo, hi = fm_count_kmers(bwt_rows, occ_bins, C, codes, lengths, k, n, stride=ST)
    Ls = lo.shape[1]                       # strided positions per read
    nh = hi - lo
    pos_has = (nh > 0) & (nh <= KH)

    offs = torch.arange(KH, dtype=I32, device=dev)
    rows = torch.clamp(lo[..., None] + offs, 0, n - 1)          # (B, Ls, KH)
    hit_ok = pos_has[..., None] & (offs < nh[..., None])
    t = fm_locate(bwt_rows, occ_bins, C, ssa_mask, ssa_base, ssa_vals, rows)
    t = torch.clamp(t, 0, G - 1)
    hit_ok = hit_ok & pos_ok[t.long()]

    # read position of strided slot i is i*ST; the spread bonus runs in
    # slot space, as ops/anchors' priority does
    slot = torch.arange(Ls, dtype=I32, device=dev)[None, :, None]
    stride = max(1, (2 * Ls * KH) // max(A, 1) // 2)
    base = 1 << 20
    prio = base - nh[..., None] * 16 + torch.where(slot % stride == 0, base // 2, 0).to(I32)
    prio = torch.where(hit_ok, prio, -1)

    vals, sel = topk_desc(prio.reshape(B, Ls * KH), A)
    sel_s = torch.div(sel, KH, rounding_mode="floor")           # the slot
    at = torch.gather(t.reshape(B, Ls * KH), 1, sel)
    aq = (sel_s * ST).to(I32)
    anh = torch.gather(nh, 1, sel_s)
    return at, aq, torch.clamp(anh, min=1), vals > 0
