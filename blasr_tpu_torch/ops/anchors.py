"""Batched anchor search over the suffix-array index.

Port of ``blasr_tpu.ops.anchors`` for the three suffix-array index kinds
that ``pipeline/mapper.make_device_index`` builds:

  * the direct 4^k tables (``find_anchors``, ``lut_meta == (0, 0)``, k <=
    14 on genomes of 1 Mb and more): every ``stride``-th read position's
    k-mer indexes ``ctab16`` (clipped total and seed-valid counts in one
    word), positions are ranked by a frequency + spread priority, and the
    top A hits per read are assigned slot by slot over the seed-valid
    compacted suffix array ``sa_valid``;
  * bisection (``find_anchors_bisect``, k <= 15): a prefix lookup table
    jump-starts a fixed number of binary-search rounds over the sorted
    keys ``sa_kmers``; the run length of equal keys gives each interval's
    width (or, without run lengths, a second search its end);
  * wide keys (``find_anchors_wide``, k 16-30): the same search over keys
    split into a top-30-bit and a low half, compared as pairs.

``find_anchors_search`` is the JAX function's call shape without a prefix
table (two full binary searches per position), which no mapper path takes.
The searched kinds expand each interval into hits over the masked suffix array
(-1 marks a position that cannot seed) and keep the top A by priority
(``_expand_and_select``). Each is plain PyTorch, as the JAX package's are
plain XLA; the loops run a static number of rounds, with no host sync.

The direct tables' selection is the sorted form of
``_expand_select_compact``. The JAX package also has a pairwise form of the
same selection (gathers are slow on a TPU); it documents identical anchors,
and the tests hold this port against JAX at sizes that take each form.
"""

from __future__ import annotations

import torch


def pack_query_kmers(
    codes: torch.Tensor, lengths: torch.Tensor, k: int, stride: int = 1
) -> torch.Tensor:
    """(B, ceil(L/stride)) int32 packed k-mers at positions 0, stride, ...;
    -1 where the window holds an N or runs past the read end."""
    B, L = codes.shape
    st = max(1, stride)
    Ls = -(-L // st)
    ext = torch.full((B, L + k + st), 4, dtype=torch.int32, device=codes.device)
    ext[:, :L] = codes.to(torch.int32)
    acc = torch.zeros((B, Ls), dtype=torch.int32, device=codes.device)
    bad = torch.zeros((B, Ls), dtype=torch.bool, device=codes.device)
    for j in range(k):
        w = ext[:, j::st][:, :Ls] if st > 1 else ext[:, j : j + L]
        acc = (acc << 2) | (w & 3)
        bad = bad | (w >= 4)
    pos = torch.arange(Ls, dtype=torch.int32, device=codes.device)[None, :] * st
    bad = bad | (pos + k > lengths.to(torch.int32)[:, None])
    return torch.where(bad, -1, acc)


def topk_desc(x: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: values descending, ties by
    ascending index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx.long())


def _expand_select_compact(
    sa_valid: torch.Tensor, lut_valid: torch.Tensor, qk_lo_key: torch.Tensor,
    nh: torch.Tensor, nh_valid: torch.Tensor, has_key: torch.Tensor,
    B: int, L: int, KH: int, A: int, ST: int,
):
    """Slot-exact hit expansion over the seed-valid compacted SA: the winning
    A anchors are the first A hits in (priority, position, hit) order.
    ``nh_valid`` counts each position's seed-valid hits. Slots past the
    last hit carry ``valid=False`` and an nhits value nothing reads."""
    dev = nh.device
    i32 = torch.int32
    Gv = sa_valid.shape[0]
    NK = lut_valid.shape[0]
    pos_has = has_key & (nh > 0) & (nh <= KH) & (nh_valid > 0)

    stride = max(1, (2 * L * KH) // max(A, 1) // 2)
    base = 1 << 20
    pos_ar = torch.arange(L, dtype=i32, device=dev)
    pos_prio = base - nh * 16 + torch.where((pos_ar % stride) == 0, base // 2, 0).to(i32)
    pos_prio = torch.where(pos_has, pos_prio, -1)                 # (B, L)

    P = min(A, L)
    pvals, psel = topk_desc(pos_prio, P)                          # (B, P)
    psel = psel.to(i32)
    klo_sel = _take(qk_lo_key, psel)
    lov = lut_valid[torch.clamp(klo_sel, 0, NK - 2).long()]
    cnt = torch.where(pvals > 0, _take(nh_valid, psel), 0)        # valid hits
    nh_sel = _take(nh, psel)

    csum = torch.cumsum(cnt, dim=1).to(i32)
    starts = csum - cnt                                           # exclusive
    total = csum[:, -1:]

    # slot s belongs to the last position whose start <= s and cnt > 0
    mark = torch.zeros((B, A + 1), dtype=i32, device=dev)
    mark.scatter_add_(
        1, torch.clamp(starts, 0, A).long(), torch.ones_like(starts)
    )
    prank = torch.clamp(torch.cumsum(mark[:, :A], dim=1).to(i32) - 1, 0, P - 1)

    sar = torch.arange(A, dtype=i32, device=dev)[None, :]
    st_at = _take(starts, prank)
    lo_at = _take(lov, prank)
    pv_ok = _take(pvals, prank) > 0
    psel_at = _take(psel, prank)
    anh = _take(nh_sel, prank)

    within = sar - st_at
    at = sa_valid[torch.clamp(lo_at + within, 0, Gv - 1).long()].to(i32)
    aq = psel_at * ST
    avalid = (sar < total) & pv_ok
    return torch.clamp(at, min=0), aq.to(i32), torch.clamp(anh, min=1).to(i32), avalid


def find_anchors(
    codes: torch.Tensor,         # (B, L) uint8
    lengths: torch.Tensor,       # (B,) int32
    sa_valid: torch.Tensor,      # (Gv,) int32 seed-valid compacted SA
    lut_full: torch.Tensor,      # (4^k + 1,) int32 first SA row per key
    lut_valid: torch.Tensor,     # (4^k + 1,) int32 valid-only counterpart
    ctab16: torch.Tensor,        # (4^k,) int16: uint16 bits (min(total,255)<<8 | min(valid,255))
    *,
    k: int,
    max_hits_per_pos: int = 8,
    max_anchors_per_read: int = 512,
    lut_meta: tuple[int, int] | None = (0, 0),
    anchor_stride: int = 1,
    expand: int = 0,
):
    """Up to A anchors per read: (t, q, nhits, valid), each (B, A)."""
    if lut_meta is None or lut_meta[1] != 0:
        raise ValueError(
            "find_anchors takes the direct 4^k tables (lut_meta (0, 0)); the "
            "bisection index goes through find_anchors_bisect"
        )
    B, _ = codes.shape
    KH = max_hits_per_pos
    A = max_anchors_per_read
    ST = max(1, anchor_stride)
    qk = pack_query_kmers(codes, lengths, k, ST)                  # (B, L/ST)
    L = qk.shape[1]
    e2 = 2 * min(max(expand, 0), k - 1)
    mask = (1 << e2) - 1
    qk_lo_key = qk & ~mask
    qk_hi_key = qk | mask
    if expand == 0:
        # one lookup gives min(total, 255) and min(valid, 255): exact for
        # the nh <= KH filter and the priority
        if KH >= 255:
            raise ValueError("max_hits_per_pos must be < 255 for the count table")
        cv = ctab16[torch.clamp(qk, 0, ctab16.shape[0] - 1).long()].to(torch.int32) & 0xFFFF
        cv = torch.where(qk >= 0, cv, 0)
        nh = cv >> 8
        nh_v = cv & 255
    else:
        key = torch.clamp(qk_lo_key, 0, lut_full.shape[0] - 2).long()
        lo = lut_full[key]
        key_hi = torch.clamp(qk_hi_key + 1, 0, lut_full.shape[0] - 1).long()
        nh = torch.where(qk >= 0, lut_full[key_hi] - lo, 0).to(torch.int32)
        lo_v = lut_valid[torch.clamp(qk_lo_key, 0, lut_valid.shape[0] - 2).long()]
        hi_v = lut_valid[torch.clamp(qk_hi_key + 1, 0, lut_valid.shape[0] - 1).long()]
        nh_v = torch.where(qk >= 0, hi_v - lo_v, 0).to(torch.int32)
    return _expand_select_compact(
        sa_valid, lut_valid, qk_lo_key, nh, nh_v, qk >= 0, B, L, KH, A, ST,
    )


def _bounded_search(
    arr: torch.Tensor, keys: torch.Tensor, lo0: torch.Tensor, hi0: torch.Tensor,
    steps: int,
) -> torch.Tensor:
    """side='left' binary search of keys within per-query ranges [lo0, hi0),
    ``steps`` (static) rounds of int32 arithmetic."""
    lo, hi = lo0, hi0
    G = arr.shape[0]
    for _ in range(steps):
        mid = (lo + hi) >> 1
        v = arr[torch.clamp(mid, 0, G - 1).long()]
        go_right = v < keys
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def _bounded_search_wide(
    hi_arr: torch.Tensor, lo_arr: torch.Tensor, khi: torch.Tensor, klo: torch.Tensor,
    lo0: torch.Tensor, hi0: torch.Tensor, steps: int,
) -> torch.Tensor:
    """side='left' binary search for compound keys (hi, lo): the int64
    k-mer split into top-30-bit / bottom-bit int32 halves."""
    lo, hi = lo0, hi0
    G = hi_arr.shape[0]
    for _ in range(steps):
        mid = (lo + hi) >> 1
        mc = torch.clamp(mid, 0, G - 1).long()
        vh = hi_arr[mc]
        vl = lo_arr[mc]
        go_right = (vh < khi) | ((vh == khi) & (vl < klo))
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def _expand_and_select(
    sa: torch.Tensor, lo: torch.Tensor, nh: torch.Tensor, has_key: torch.Tensor,
    B: int, L: int, KH: int, A: int, ST: int,
):
    """Hit expansion + priority compaction for the searched indexes: prefer
    unique anchors, guarantee read-wide spread via a stride bonus, keep the
    top A per read. Only the top-A positions by priority are expanded into
    their first KH suffix-array rows; ``sa`` holds -1 where a position
    cannot seed."""
    dev = nh.device
    i32 = torch.int32
    G = sa.shape[0]
    pos_has = has_key & (nh > 0) & (nh <= KH)

    stride = max(1, (2 * L * KH) // max(A, 1) // 2)
    base = 1 << 20
    pos_ar = torch.arange(L, dtype=i32, device=dev)
    pos_prio = base - nh * 16 + torch.where((pos_ar % stride) == 0, base // 2, 0).to(i32)
    pos_prio = torch.where(pos_has, pos_prio, -1)                 # (B, L)

    P = min(A, L)
    pvals, psel = topk_desc(pos_prio, P)                          # (B, P)
    psel = psel.to(i32)
    lo_sel = _take(lo.to(i32), psel)
    nh_sel = _take(nh, psel)

    offs = torch.arange(KH, dtype=i32, device=dev)
    idx = torch.clamp(lo_sel[..., None] + offs[None, None, :], 0, G - 1)
    t = sa[idx.long()].to(i32)                                    # (B, P, KH)
    hit_ok = (pvals > 0)[..., None] & (offs[None, None, :] < nh_sel[..., None]) & (t >= 0)
    t = torch.clamp(t, 0, G - 1)

    q = (psel * ST)[..., None].expand(B, P, KH)
    prio = torch.where(hit_ok, pvals[..., None], -1)

    vals, sel = topk_desc(prio.reshape(B, P * KH), A)
    at = _take(t.reshape(B, P * KH), sel)
    aq = _take(q.reshape(B, P * KH), sel)
    anh = _take(nh_sel[..., None].expand(B, P, KH).reshape(B, P * KH), sel)
    avalid = vals > 0
    return at, aq.to(i32), torch.clamp(anh, min=1).to(i32), avalid


def find_anchors_search(
    codes: torch.Tensor,         # (B, L) uint8
    lengths: torch.Tensor,       # (B,) int32
    sa: torch.Tensor,            # (G,) int32 suffix array (-1: cannot seed)
    sa_kmers: torch.Tensor,      # (G,) int32 ascending packed k-mers in SA order
    pos_ok: torch.Tensor | None = None,  # (G,) bool seed validity, or None if folded into sa
    *,
    k: int,
    max_hits_per_pos: int = 8,
    max_anchors_per_read: int = 512,
    anchor_stride: int = 1,
    expand: int = 0,
):
    """Up to A anchors per read, (t, q, nhits, valid) each (B, A), with
    no prefix table: each interval is two full binary searches over the
    sorted keys, and ``pos_ok``, when given, is folded into the suffix
    array here. The JAX package's ``find_anchors`` called without a lookup
    table (its original call shape, which its tests use); no mapper path
    takes it."""
    B, _ = codes.shape
    G = sa.shape[0]
    ST = max(1, anchor_stride)
    qk = pack_query_kmers(codes, lengths, k, ST)                  # (B, L/ST)
    L = qk.shape[1]
    e2 = 2 * min(max(expand, 0), k - 1)
    mask = (1 << e2) - 1
    sk = sa_kmers.to(torch.int32).contiguous()
    lo = torch.searchsorted(sk, (qk & ~mask).contiguous(), side="left").to(torch.int32)
    hi = torch.searchsorted(sk, (qk | mask).contiguous(), side="right").to(torch.int32)
    sa = sa.to(torch.int32)
    if pos_ok is not None:
        sa = torch.where(pos_ok[torch.clamp(sa, 0, G - 1).long()] & (sa >= 0), sa, -1)
    return _expand_and_select(sa, lo, hi - lo, qk >= 0, B, L, max_hits_per_pos,
                              max_anchors_per_read, ST)


def find_anchors_bisect(
    codes: torch.Tensor,         # (B, L) uint8
    lengths: torch.Tensor,       # (B,) int32
    sa_masked: torch.Tensor,     # (G,) int32 suffix array, -1 where a position cannot seed
    sa_kmers: torch.Tensor,      # (G,) int32 ascending packed k-mers in SA order
    lut: torch.Tensor,           # (2^bits + 1,) int32 first SA row per key prefix
    run_len: torch.Tensor | None,  # (G,) int32 number of equal keys from each row
                                 # on; None: a second search finds each end
    *,
    k: int,
    max_hits_per_pos: int = 8,
    max_anchors_per_read: int = 512,
    lut_meta: tuple[int, int],   # (shift, max_steps) of GenomeIndex.lut()
    anchor_stride: int = 1,
    expand: int = 0,
):
    """Up to A anchors per read through the bisection index (k <= 15):
    (t, q, nhits, valid), each (B, A)."""
    B, _ = codes.shape
    G = sa_masked.shape[0]
    KH = max_hits_per_pos
    A = max_anchors_per_read
    ST = max(1, anchor_stride)
    qk = pack_query_kmers(codes, lengths, k, ST)                  # (B, L/ST)
    L = qk.shape[1]
    # expand > 0 widens every lookup to the interval of the (k - expand)-base
    # prefix: keys in [qk & ~mask, qk | mask]
    e2 = 2 * min(max(expand, 0), k - 1)
    mask = (1 << e2) - 1
    qk_lo_key = qk & ~mask
    qk_hi_key = qk | mask
    shift, max_steps = lut_meta
    steps = max_steps + max(0, e2 - shift)  # a widened range spans buckets
    NL = lut.shape[0]
    pref_lo = torch.clamp(qk_lo_key >> shift, 0, NL - 2).long()
    pref_hi = torch.clamp(qk_hi_key >> shift, 0, NL - 2).long()
    blo = lut[pref_lo]
    bhi = lut[pref_hi + 1]
    lo = _bounded_search(sa_kmers, qk_lo_key, blo, bhi, steps)
    if expand == 0 and run_len is not None:
        # lo is side='left': where the key is present, sa_kmers[lo] == key
        # and the run length of equal keys is the interval's width
        loc = torch.clamp(lo, 0, G - 1).long()
        present = (sa_kmers[loc] == qk) & (lo < G)
        nh = torch.where(present, run_len[loc], 0).to(torch.int32)
    else:
        hi = _bounded_search(sa_kmers, qk_hi_key + 1, lo, bhi, steps)
        nh = (hi - lo).to(torch.int32)
    return _expand_and_select(sa_masked, lo, nh, qk >= 0, B, L, KH, A, ST)


def find_anchors_wide(
    codes: torch.Tensor,         # (B, L) uint8
    lengths: torch.Tensor,       # (B,) int32
    sa_masked: torch.Tensor,     # (G,) int32 suffix array, -1 where a position cannot seed
    kmer_hi: torch.Tensor,       # (G,) int32 top 30 key bits (the first 15 bases)
    kmer_lo: torch.Tensor,       # (G,) int32 the low 2(k-15) key bits
    lut: torch.Tensor,           # (2^22 + 1,) int32 prefix table over kmer_hi
    *,
    k: int,                      # 16..30
    max_hits_per_pos: int = 8,
    max_anchors_per_read: int = 512,
    lut_meta: tuple[int, int],   # (shift within hi, max_steps) of GenomeIndex.lut()
    anchor_stride: int = 1,
    expand: int = 0,   # frees low key bits, clamped to the low half (the
                       # effective seed never drops below 15 bases)
):
    """Up to A anchors per read through the wide-key index (k 16-30):
    (t, q, nhits, valid), each (B, A)."""
    if not 16 <= k <= 30:
        raise ValueError(f"k={k}: wide keys take k in [16, 30]")
    B, L = codes.shape
    KH = max_hits_per_pos
    A = max_anchors_per_read

    # both halves are packed at every position, then strided: the low half
    # starts 15 bases later (out of range -> invalid)
    qk_hi = pack_query_kmers(codes, lengths, 15)                  # (B, L)
    klo_full = pack_query_kmers(codes, lengths, k - 15)
    qk_lo = torch.full_like(klo_full, -1)
    qk_lo[:, : max(L - 15, 0)] = klo_full[:, 15:]
    bad = (qk_hi < 0) | (qk_lo < 0)
    qk_hi = torch.where(bad, -1, qk_hi)
    qk_lo = torch.where(bad, 0, qk_lo)

    ST = max(1, anchor_stride)
    if ST > 1:
        qk_hi = qk_hi[:, ::ST]
        qk_lo = qk_lo[:, ::ST]
        L = qk_hi.shape[1]

    shift, max_steps = lut_meta
    e2 = 2 * min(max(expand, 0), k - 15)
    emask = (1 << e2) - 1
    qlo_l = qk_lo & ~emask
    qlo_h = qk_lo | emask
    # the prefix table over the hi half jump-starts the compound search;
    # within a hi bucket further rounds resolve the lo half
    steps = max_steps + max(0, e2.bit_length())
    NL = lut.shape[0]
    pref = torch.clamp(qk_hi >> shift, 0, NL - 2).long()
    blo = torch.where(qk_hi >= 0, lut[pref], 0)
    bhi = torch.where(qk_hi >= 0, lut[pref + 1], 0)
    lo = _bounded_search_wide(kmer_hi, kmer_lo, qk_hi, qlo_l, blo, bhi, steps)
    # the upper key + 1, with the carry into the hi half, bounds the right end
    LO_MASK = (1 << (2 * (k - 15))) - 1
    carry = (qlo_h == LO_MASK).to(torch.int32)
    khi2 = qk_hi + carry
    klo2 = torch.where(carry == 1, 0, qlo_h + 1)
    hi = _bounded_search_wide(kmer_hi, kmer_lo, khi2, klo2, lo, bhi, steps)
    nh = (hi - lo).to(torch.int32)
    return _expand_and_select(sa_masked, lo, nh, qk_hi >= 0, B, L, KH, A, ST)
