"""Per-batch mapping step on the device.

Port of ``blasr_tpu.pipeline.mapper`` for the suffix-array index (the
direct 4^k tables, bisection, or wide keys for k 16-30) and for the
FM-index (``-bwt``), with or without quality
values, with or without guided bands (``-useGuidedAlign``) and a score
matrix (``-scoreMatrix``). One batch of padded reads goes through, in
order:

  1. reverse complements appended -> (2B, L) strand-expanded batch (and
     the quality rows reversed, when the batch carries them)
  2. anchors through the direct count tables, by bisection over the
     sorted keys, or over the wide keys' two halves    (ops/anchors.py)
     or by FM backward search and locate              (ops/fm_search.py)
  3. candidate windows per read-strand                 (ops/candidates.py)
  4. chain evidence, admission, the top CD windows per read across strands
  5. drift-slope band schedule and per-item centring, the per-item guided
     knots (guided bands), then the genome window and query row of every
     DP item (ops/gather.py kernels)
  6. one banded DP with arrows over every item         (ops/banded_cuda.py)
  7. traceback walk on the device                      (ops/traceback_device.py)
  8. containment filters, best_n selection and MAPQ    (ops/mapqv.py)
  9. one uint8 wire buffer that ``unpack_result`` slices on the host

Everything is plain PyTorch on the ``device`` the ``Mapper`` was built for;
the three kernels of the path are CUDA on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from blasr_tpu_torch.index.artifacts import GenomeIndex
from blasr_tpu_torch.ops.anchors import (
    find_anchors,
    find_anchors_bisect,
    find_anchors_wide,
    topk_desc,
)
from blasr_tpu_torch.ops.banded_align import (
    QOFF_NUM_HALF,
    QOFF_SHIFT,
    QV_NEUTRAL,
    QV_NEUTRAL_DUAL,
    AlignScores,
    clamp_knots_to_shared,
    guided_max_dev,
    make_qoff_knots,
    make_qoff_num,
)
from blasr_tpu_torch.ops.banded_cuda import banded_align
from blasr_tpu_torch.ops.candidates import (
    anchor_weights,
    chain_stats,
    chain_weight_device,
    ordered_sum,
    select_candidates,
)
from blasr_tpu_torch.ops.fm_search import find_anchors_fm
from blasr_tpu_torch.ops.gather import gather_rows, gather_spans
from blasr_tpu_torch.ops.mapqv import map_qv_reference
from blasr_tpu_torch.ops.traceback_device import (
    pack_codes_rows,
    packed_width,
    walk_arrows_device,
)
from blasr_tpu_torch.params import MappingParams

I32 = torch.int32
_U32 = 0xFFFFFFFF


class DeviceIndex(NamedTuple):
    """Genome index resident in device memory: one of the three
    suffix-array kinds ("wide", "direct", "bisect"; ``_sa_kind`` chooses)
    or the FM kind ("fm"). ``map_batch_impl`` dispatches on ``kind``."""

    genome_pad: torch.Tensor  # (N,) int32: 8 nibble-packed codes per word
                              # (LSB first), out-of-genome = 5, N % 128 == 0
    arrays: tuple             # all int32 but ctab16:
                              #   "wide": (sa_masked, kmer_hi, kmer_lo,
                              #     lut);
                              #   "direct": (sa_valid, ctab16, lut_full,
                              #     lut_valid);
                              #   "bisect": (sa_masked, sa_kmers, lut,
                              #     run_len);
                              # "fm": (bwt_rows, occ_bins, C, ssa_mask,
                              # ssa_base, ssa_vals, pos_ok)
    starts: torch.Tensor      # (C+1 padded to a multiple of 8,) int32
    pad: int
    k: int
    genome_len: int
    kind: str                 # "wide", "direct", "bisect" or "fm"
    lut_meta: tuple | None = (0, 0)  # (shift, max_steps) of the prefix
                              # table; (0, 0) for the direct tables
    fm_n: int = 0             # FM total rows (G + 1) when kind == "fm"


def _pad_starts(starts: np.ndarray) -> np.ndarray:
    """Contig boundaries padded to a multiple-of-8 length with the total
    length repeated."""
    s = np.asarray(starts, np.int32)
    n = len(s)
    target = -(-n // 8) * 8
    if target == n:
        return s
    return np.concatenate([s, np.full(target - n, s[-1], np.int32)])


def packed_genome_words(idx: GenomeIndex, params: MappingParams) -> tuple[np.ndarray, int]:
    """(words, pad): the padded genome nibble-packed 8 codes per int32 word,
    with all-5 slack so every legal window start reads in range."""
    pad = params.max_read_len + params.target_len
    gp = np.full(idx.genome_length + 2 * pad, 5, dtype=np.uint8)
    gp[pad : pad + idx.genome_length] = idx.genome
    n8 = len(gp) // 8 + 2
    gp8 = np.full(n8 * 8, 5, np.uint8)
    gp8[: len(gp)] = gp
    gnib = np.zeros(n8, np.uint32)
    for j in range(8):
        gnib |= gp8[j::8].astype(np.uint32) << (4 * j)
    nw_max = (params.max_read_len + params.target_pad) // 8 + 2
    slack = (-(-nw_max // 128) + 2) * 128
    n8p = -(-(n8 + slack) // 128) * 128
    gnib_p = np.full(n8p, 0x55555555, np.uint32)
    gnib_p[:n8] = gnib
    return gnib_p.view(np.int32), pad


def _direct_tables(idx: GenomeIndex, sa_masked: np.ndarray, device) -> tuple:
    """(sa_valid, ctab16, lut_full, lut_valid) built on the device: scatter
    counts, int32 prefix sums, the seed-valid compacted SA. ``ctab16``
    holds the uint16 table's bits in an int16 tensor."""
    nk = 1 << (2 * idx.k)
    G = idx.genome_length
    sk = torch.from_numpy(np.ascontiguousarray(idx.sa_kmers)).to(device).long()
    sa_m = torch.from_numpy(sa_masked).to(device)
    valid = sa_m >= 0
    counts = torch.zeros(nk, dtype=I32, device=device)
    counts.scatter_add_(0, sk, torch.ones(G, dtype=I32, device=device))
    lut_full = torch.zeros(nk + 1, dtype=I32, device=device)
    torch.cumsum(counts, 0, dtype=I32, out=lut_full[1:])
    counts_v = torch.zeros(nk, dtype=I32, device=device)
    counts_v.scatter_add_(0, sk, valid.to(I32))
    lut_valid = torch.zeros(nk + 1, dtype=I32, device=device)
    torch.cumsum(counts_v, 0, dtype=I32, out=lut_valid[1:])
    del sk
    dest = torch.cumsum(valid.to(I32), 0, dtype=I32) - 1
    sa_valid = torch.zeros(G, dtype=I32, device=device)
    sa_valid[dest[valid].long()] = sa_m[valid]
    counts.clamp_(max=255)
    counts_v.clamp_(max=255)
    ctab16 = ((counts << 8) | counts_v).to(torch.int16)
    return sa_valid, ctab16, lut_full, lut_valid


def run_lengths(sa_kmers: np.ndarray) -> np.ndarray:
    """(G,) int32: the number of equal keys from each SA row on, so the
    bisection index finds an interval's width in one gather instead of a
    second search."""
    change = np.flatnonzero(np.diff(sa_kmers) != 0) + 1
    bounds = np.concatenate([[0], change, [len(sa_kmers)]])
    next_bound = np.repeat(bounds[1:], np.diff(bounds))
    return (next_bound - np.arange(len(sa_kmers))).astype(np.int32)


def _sa_kind(idx: GenomeIndex, direct_lut: bool | None) -> str:
    """The suffix-array index kind, in the JAX package's order of choice:
    "wide" keys when 2k > 31; else "direct" 4^k tables when ``direct_lut``
    is set (None: when 2k <= 28 and the genome has at least 2^20 bases) and
    2k <= 28; else "bisect"."""
    if 2 * idx.k > 31:
        return "wide"
    direct = direct_lut
    if direct is None:
        direct = 2 * idx.k <= 28 and idx.genome_length >= (1 << 20)
    return "direct" if direct and 2 * idx.k <= 28 else "bisect"


def _sa_arrays(idx: GenomeIndex, kind: str, device) -> tuple:
    """(arrays, lut_meta) of the suffix-array index of ``kind``; the
    suffix array carries -1 where a position cannot seed."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    sa32 = idx.sa.astype(np.int32)
    sa_masked = np.where(idx.pos_ok[sa32], sa32, np.int32(-1))
    if kind == "direct":
        return _direct_tables(idx, sa_masked, device), (0, 0)
    lut, shift, max_steps = idx.lut()
    if kind == "wide":
        full = idx.sa_kmers.astype(np.int64)
        lo_bits = 2 * idx.k - 30
        kmer_hi = (full >> lo_bits).astype(np.int32)
        kmer_lo = (full & ((1 << lo_bits) - 1)).astype(np.int32)
        return (dev(sa_masked), dev(kmer_hi), dev(kmer_lo), dev(lut)), (shift, max_steps)
    arrays = (dev(sa_masked), dev(idx.sa_kmers), dev(lut), dev(run_lengths(idx.sa_kmers)))
    return arrays, (shift, max_steps)


def _fm_arrays(fm, idx: GenomeIndex, device) -> tuple:
    """The seven FM arrays on the device with the JAX package's casts (C
    and the sampled SA values int32); the uint32 sample mask as int64
    words (``ops/fm_search``)."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (
        dev(fm.bwt_rows),
        dev(fm.occ_bins),
        dev(fm.C.astype(np.int32)),
        dev(fm.ssa_mask.astype(np.int64)),
        dev(fm.ssa_base),
        dev(fm.ssa_vals.astype(np.int32)),
        dev(idx.pos_ok),
    )


def make_device_index(
    idx: GenomeIndex, params: MappingParams, device: str | torch.device, fm=None
) -> DeviceIndex:
    """Upload ``idx`` as the suffix-array device index (``_sa_kind`` picks
    its kind from k, ``params.direct_lut`` and the genome length), or with
    ``fm`` (an ``index.fm.FMIndex``) as the FM device index, which needs
    only the genome, its seed-validity mask and contig bounds of ``idx``.
    Cached per index object, padding, device, index kind and fm: the kind
    that ``direct_lut`` resolves to, so settings that build the same
    tables share one copy and settings that build others never alias it.
    The entry pins the fm it was built from, so a recycled ``id()`` never
    aliases a live entry."""
    device = torch.device(device)
    kind = _sa_kind(idx, params.direct_lut) if fm is None else "fm"
    key = (params.max_read_len + params.target_len, str(device), kind,
           id(fm) if fm is not None else None)
    cache = getattr(idx, "_torch_device_index_cache", None)
    if cache is None:
        cache = {}
        idx._torch_device_index_cache = cache
    hit = cache.get(key)
    if hit is not None and hit[0] is fm:
        return hit[1]
    words, pad = packed_genome_words(idx, params)
    common = dict(
        genome_pad=torch.from_numpy(words).to(device),
        starts=torch.from_numpy(_pad_starts(idx.seqdb.starts)).to(device),
        pad=pad,
        k=idx.k,
        genome_len=idx.genome_length,
    )
    if fm is not None:
        di = DeviceIndex(arrays=_fm_arrays(fm, idx, device), lut_meta=None, kind="fm",
                         fm_n=int(fm.n), **common)
    else:
        arrays, lut_meta = _sa_arrays(idx, kind, device)
        di = DeviceIndex(arrays=arrays, lut_meta=lut_meta, kind=kind, **common)
    cache[key] = (fm, di)
    return di


# row order of the selected-alignment block of the wire buffer
SEL_FIELDS = (
    "sel_score", "sel_t0", "sel_strand", "sel_valid", "nops",
    "q_start", "q_end", "t_start", "t_end",
    "n_match", "n_mismatch", "n_ins", "n_del", "mapqv", "sel_cd",
)


class MapBatchResult(NamedTuple):
    sel_ints: torch.Tensor      # (len(SEL_FIELDS), I2) int32
    moves_packed: torch.Tensor  # (I2, P) uint8 packed ops, END->START order
    read_ints: torch.Tensor     # (B, 6*CD + 1) int32


class WireResult(NamedTuple):
    """One uint8 buffer per batch: sel_ints | moves_packed | read_ints."""

    wire: "torch.Tensor | np.ndarray"
    i2: int
    p: int
    b: int
    rcols: int


class HostBatchResult(NamedTuple):
    sel_score: np.ndarray
    sel_t0: np.ndarray
    sel_strand: np.ndarray
    sel_valid: np.ndarray
    nops: np.ndarray
    q_start: np.ndarray
    q_end: np.ndarray
    t_start: np.ndarray
    t_end: np.ndarray
    n_match: np.ndarray
    n_mismatch: np.ndarray
    n_ins: np.ndarray
    n_del: np.ndarray
    mapqv: np.ndarray
    sel_cd: np.ndarray
    moves_packed: np.ndarray
    cand_scores: np.ndarray
    cand_valid: np.ndarray
    cand_qlo: np.ndarray
    cand_qhi: np.ndarray
    cand_tlo: np.ndarray
    cand_thi: np.ndarray
    cand_ambig: np.ndarray


def unpack_result(res: WireResult, dp_candidates: int) -> HostBatchResult:
    wire = res.wire
    if isinstance(wire, torch.Tensor):
        wire = wire.cpu().numpy()
    nsel = len(SEL_FIELDS) * res.i2 * 4
    nmov = res.i2 * res.p
    sel = wire[:nsel].view(np.int32).reshape(len(SEL_FIELDS), res.i2)
    moves = wire[nsel : nsel + nmov].reshape(res.i2, res.p)
    rints = wire[nsel + nmov :].view(np.int32).reshape(res.b, res.rcols)
    CD = dp_candidates
    fields = {name: sel[i] for i, name in enumerate(SEL_FIELDS)}
    fields["sel_valid"] = fields["sel_valid"].astype(bool)
    return HostBatchResult(
        moves_packed=moves,
        cand_scores=rints[:, :CD],
        cand_valid=rints[:, CD : 2 * CD].astype(bool),
        cand_qlo=rints[:, 2 * CD : 3 * CD],
        cand_qhi=rints[:, 3 * CD : 4 * CD],
        cand_tlo=rints[:, 4 * CD : 5 * CD],
        cand_thi=rints[:, 5 * CD : 6 * CD],
        cand_ambig=rints[:, 6 * CD].astype(bool),
        **fields,
    )


def _unpack_nibbles(words: torch.Tensor, n: int) -> torch.Tensor:
    """(R, NW) int64 words holding uint32 values -> (R, n) uint8 codes."""
    nsh = torch.arange(8, dtype=torch.int64, device=words.device) * 4
    b = (words[:, :, None] >> nsh[None, None, :]) & 15
    return b.reshape(words.shape[0], -1)[:, :n].to(torch.uint8)


def _phase_align(wu: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """Shift each row of uint32 words (int64 storage) right by ``phase``
    nibbles, pulling the low nibbles of the next word in."""
    wnext = torch.cat([wu[:, 1:], wu[:, -1:]], dim=1)
    aligned = wu
    for ph in range(1, 8):
        cand = (wu >> (4 * ph)) | ((wnext << (32 - 4 * ph)) & _U32)
        aligned = torch.where((phase == ph)[:, None], cand, aligned)
    return aligned


def _pack_rows(codes: torch.Tensor) -> torch.Tensor:
    """(R, L) codes -> (R, L/8) int32 nibble words (LSB first)."""
    R, L = codes.shape
    sh = torch.arange(8, dtype=I32, device=codes.device) * 4
    return (codes.to(I32).reshape(R, L // 8, 8) << sh).sum(dim=2).to(I32)


def _revcomp_rows(codes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-row reverse complement keeping reads left-aligned in the padding."""
    B, L = codes.shape
    dev = codes.device
    c32 = codes.to(I32)
    comp = torch.where(c32 < 4, 3 - c32, c32)
    lengths = lengths.to(I32)
    if L % 8 != 0:
        idx = lengths[:, None] - 1 - torch.arange(L, dtype=I32, device=dev)[None, :]
        g = torch.gather(comp, 1, torch.clamp(idx, 0, L - 1).long())
        return torch.where(idx >= 0, g, 4).to(torch.uint8)
    w = _pack_rows(torch.flip(comp, dims=[1]))                 # (B, L/8)
    s = L - lengths
    NW = L // 8 + 1
    widx = (s >> 3)[:, None] + torch.arange(NW, dtype=I32, device=dev)[None, :]
    wpad = torch.cat([w, torch.zeros((B, 1), dtype=I32, device=dev)], dim=1)
    wv = torch.gather(wpad, 1, torch.clamp(widx, 0, L // 8).long())
    aligned = _phase_align(wv.to(torch.int64) & _U32, s & 7)
    out = _unpack_nibbles(aligned, L)
    ar = torch.arange(L, dtype=I32, device=dev)[None, :]
    return torch.where(ar < lengths[:, None], out, torch.tensor(4, dtype=torch.uint8, device=dev))


def _reverse_qual_rows(qual: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Quality rows of the reverse-complement strand: each read's values
    reversed (not complemented), left-aligned, the neutral value in the
    pad columns."""
    L = qual.shape[1]
    idx = lengths.to(I32)[:, None] - 1 - torch.arange(L, dtype=I32, device=qual.device)[None, :]
    rev = torch.gather(qual, 1, torch.clamp(idx, 0, L - 1).long())
    neutral = QV_NEUTRAL_DUAL if qual.dtype == torch.int16 else QV_NEUTRAL
    return torch.where(idx >= 0, rev, torch.full_like(rev, neutral))


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-d float32 tensor: the midpoint of the two
    middle non-NaN values (``torch.nanmedian`` returns the lower one);
    NaN when every value is NaN."""
    v, _ = torch.sort(x)                                       # NaN sorts last
    n = torch.sum(~torch.isnan(x))
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, x.shape[0] - 1)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, x.shape[0] - 1)
    return (v[lo] + v[hi]) * 0.5


class StageClock:
    """Device-synchronised host clock per pipeline stage, for measurement
    runs only: each ``mark`` waits for the device, so it removes the
    overlap it measures."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict[str, float] = {}
        self._t = None

    def start(self) -> None:
        self._sync()
        self._t = time.perf_counter()

    def mark(self, stage: str) -> None:
        self._sync()
        now = time.perf_counter()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + now - self._t
        self._t = now

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def map_batch_impl(
    codes: torch.Tensor,          # (B, L) uint8
    lengths: torch.Tensor,        # (B,) int32
    di: DeviceIndex,
    params: MappingParams,
    qual: torch.Tensor | None = None,  # (B, L) uint8, or int16 (dual)
    clock: StageClock | None = None,
) -> MapBatchResult:
    dev = codes.device
    B, L = codes.shape
    C = params.n_candidates
    T = L + params.target_pad
    W = params.band_width_for(L)
    CW = params.candidate_win
    G = di.genome_len
    k = di.k
    pad = di.pad
    lengths = lengths.to(I32)
    mark = clock.mark if clock is not None else (lambda stage: None)
    if clock is not None:
        clock.start()

    # ---- strands ----
    rc = _revcomp_rows(codes, lengths)
    reads2 = torch.cat([codes, rc], dim=0)                    # (2B, L)
    lens2 = torch.cat([lengths, lengths], dim=0)
    qual2 = None
    if qual is not None:
        qual2 = torch.cat([qual, _reverse_qual_rows(qual, lengths)], dim=0)

    # ---- anchoring ----
    if di.kind == "fm":
        at, aq, anh, avalid = find_anchors_fm(
            reads2, lens2, *di.arrays,
            k=k, n=di.fm_n,
            max_hits_per_pos=params.max_anchors_per_position,
            max_anchors_per_read=params.max_anchors_per_read,
            anchor_stride=params.anchor_stride,
        )
    else:
        kw = dict(k=k, max_hits_per_pos=params.max_anchors_per_position,
                  max_anchors_per_read=params.max_anchors_per_read, lut_meta=di.lut_meta,
                  anchor_stride=params.anchor_stride, expand=params.min_expand)
        if di.kind == "wide":
            at, aq, anh, avalid = find_anchors_wide(reads2, lens2, *di.arrays, **kw)
        elif di.kind == "direct":
            sa_valid, ctab16, lut_full, lut_valid = di.arrays
            at, aq, anh, avalid = find_anchors(
                reads2, lens2, sa_valid, lut_full, lut_valid, ctab16, **kw)
        else:
            at, aq, anh, avalid = find_anchors_bisect(reads2, lens2, *di.arrays, **kw)

    mark("anchors")

    # ---- candidate windows ----
    aw = anchor_weights(anh, avalid, G, CW, params.pval_type)
    cand = select_candidates(at, aq, aw, avalid, n_candidates=C, win=CW, k=k)

    # ---- cross-strand selection of the CD best windows per read ----
    CD = params.n_dp_candidates or C

    def to2(x):
        return x.reshape(2, B, C).permute(1, 0, 2).reshape(B, 2 * C)

    vld2 = to2(cand.valid)
    if params.forward_only:
        vld2 = vld2 & (torch.arange(2 * C, device=dev)[None, :] < C)
    b_ar = torch.arange(B, dtype=I32, device=dev)[:, None]
    if params.pval_type in (0, 1):
        # the reference's chain p-value: rank by colinear-chain size (or,
        # with exact_chain, its exact max weight), ties by interval start,
        # and admit only windows with a chain (or a long exact match) and
        # an anchor coverage above min_interval
        n_chain, chained_any, cmass, ch_corners = chain_stats(
            at, aq, avalid, cand.dstar, cand.valid, k=k, win=CW,
        )
        if params.exact_chain:
            mark("candidates")
            n_chain = chain_weight_device(
                at, aq, avalid, cand.dstar, cand.valid, k=k, win=CW,
            )
            mark("exact_chain")
        nch2 = to2(n_chain)
        vld2 = vld2 & to2(chained_any) & (to2(cmass) > params.min_interval)
        gst2 = to2(cand.d0 + cand.q_lo)
        grank = torch.argsort(
            torch.argsort(torch.where(vld2, gst2, 2**30), dim=1, stable=True),
            dim=1, stable=True,
        ).to(I32)
        key = torch.where(vld2, (torch.clamp(nch2, max=1 << 14) << 15) - grank, -1)
        top_sorted, top_idx = topk_desc(key, max(CD, 2))
        cvalid = (top_sorted[:, :CD] > 0).reshape(-1)
        ambig = top_sorted[:, 1] > 0
    else:
        # -pvaltype 2/3: the summed anchor weight ranks the windows, with
        # no admission gate; the corners are the windows' member spans
        wneg = torch.where(vld2, to2(cand.weight), -1.0)
        top_sorted, top_idx = topk_desc(wneg, max(CD, 2))
        cvalid = (top_sorted[:, :CD] > 0.0).reshape(-1)
        ambig = top_sorted[:, 1] > 0.0
        ch_corners = (cand.q_lo, cand.q_hi, cand.d0 + cand.q_lo, cand.d0 + cand.q_hi + k)
    topj = top_idx[:, :CD].to(I32)
    dp_strand = torch.div(topj, C, rounding_mode="floor").to(I32)
    dp_c = (topj % C).to(I32)
    cand_flat = ((dp_strand * B + b_ar) * C + dp_c).reshape(-1).long()

    d0 = torch.clamp(cand.d0.reshape(-1)[cand_flat], -L, G - 1)
    row = (dp_strand * B + b_ar).reshape(-1)                  # (I,) int32

    scores_cfg = AlignScores(
        match=params.match_score,
        mismatch=params.mismatch_score,
        insertion=params.insertion_score,
        deletion=params.deletion_score,
        affine_open=params.affine_open,
        affine_extend=params.affine_extend,
        matrix=params.score_matrix,
    )

    mark("candidates")

    # ---- drift-slope band schedule and per-item window centring ----
    pad2 = params.target_pad // 2
    guided = params.guided_band and L >= W
    if W < 128 or guided:
        # the item's anchor rows serve the slope fit and the knots alike
        aqv_pack = (aq << 1) | avalid.to(I32)
        A_ = at.shape[1]
        fused = gather_rows(torch.cat([at, aqv_pack], dim=1).contiguous(), row)
        atr = fused[:, :A_]
        aqr = fused[:, A_:] >> 1
        avr = (fused[:, A_:] & 1).bool()
    if W < 128:
        din = atr - aqr - d0[:, None]
        m = avr & (torch.abs(din) <= CW)
        mf = m.to(torch.float32)
        qf = aqr.to(torch.float32) * mf
        df = din.to(torch.float32) * mf
        n_a = ordered_sum(mf)
        sq = ordered_sum(qf)
        sd = ordered_sum(df)
        sqq = ordered_sum(qf * qf * m.to(torch.float32))
        sqd = ordered_sum(qf * df)
        denom = n_a * sqq - sq * sq
        ok = (n_a >= 3) & (denom > 1e3)
        slope_i = torch.where(
            ok, (n_a * sqd - sq * sd) / torch.clamp(denom, min=1.0), float("nan")
        )
        slope_med = torch.nan_to_num(
            _nanmedian(torch.where(cvalid, slope_i, float("nan"))), nan=0.0
        )
        slope_med = torch.clamp(slope_med, -0.15, 0.15)
        two = torch.full_like(slope_med, 2.0)
        qoff_num = torch.round(
            torch.full_like(slope_med, float(1 << QOFF_SHIFT)) / (two + slope_med)
        ).to(I32)
        dev_ = (((2 * aqr + din) * qoff_num) >> QOFF_SHIFT) - aqr
        dev_max = torch.amax(torch.where(m, dev_, -(1 << 30)), dim=1)
        dev_min = torch.amin(torch.where(m, dev_, 1 << 30), dim=1)
        have = torch.any(m, dim=1) & cvalid
        dt = torch.div(
            (dev_max + dev_min) << (QOFF_SHIFT - 1),
            torch.clamp(qoff_num, min=1),
            rounding_mode="floor",
        )
        dt = torch.clamp(dt, -pad2 // 2, pad2 // 2)
        d0 = torch.where(have, d0 + dt, d0)
    else:
        qoff_num = torch.tensor(QOFF_NUM_HALF, dtype=I32, device=dev)
    qoff = make_qoff_num(L, T, W, pad2, qoff_num)

    # ---- per-item guided band (the reference's per-read guide,
    # GuidedAlign.h:104): each item's band follows knots lerped through its
    # own member anchors, clamped to the reference's distance from the
    # shared line ----
    knots = None
    if guided:
        din_g = atr - aqr - d0[:, None]
        m_g = avr & (torch.abs(din_g) <= CW) & cvalid[:, None]
        # an anchor (q, t_loc = din + q + pad2) sits on anti-diagonal
        # a = 2q + din + pad2 of its window
        knots = make_qoff_knots(
            2 * aqr + din_g + pad2, aqr - W // 2, m_g, L + T - 1, L, W,
            diag=pad2, num=qoff_num,
        )
        knots = clamp_knots_to_shared(knots, qoff, W, max_dev=guided_max_dev(W))

    t0f = (d0 - pad2).to(I32)                                  # (I,) global

    # ---- target windows from the nibble-packed genome ----
    gpos = t0f + pad
    NW8 = T // 8 + 2
    wv = gather_spans(di.genome_pad, (gpos >> 3).contiguous(), NW8)
    aligned = _phase_align(wv.to(torch.int64) & _U32, gpos & 7)
    tcodes = _unpack_nibbles(aligned, T)

    # contig bounds for boundary masking
    starts = di.starts
    mid = torch.clamp(t0f + T // 2, 0, G - 1)
    ci = torch.searchsorted(starts, mid, right=True).to(I32) - 1
    ci = torch.clamp(ci, 0, starts.shape[0] - 2).long()
    tlo = torch.clamp(starts[ci] - t0f, min=0).to(I32)
    thi = torch.clamp(starts[ci + 1] - t0f, max=T).to(I32)

    # ---- query rows, nibble-packed, one row gather per item ----
    if L % 8 == 0:
        qw = gather_rows(_pack_rows(reads2), row)
        nshq = torch.arange(8, dtype=I32, device=dev) * 4
        qitems = ((qw[:, :, None] >> nshq[None, None, :]) & 15).to(torch.uint8).reshape(-1, L)
    else:
        qitems = reads2[row.long()]
    qlens = lens2[row.long()].contiguous()
    quitems = qual2[row.long()].contiguous() if qual2 is not None else None

    mark("setup")

    # ---- one DP pass with arrows over every candidate ----
    res1 = banded_align(
        qitems.contiguous(), qlens, tcodes.contiguous(), tlo, thi,
        qoff if knots is None else None, quitems,
        knots=knots, scores=scores_cfg, with_traceback=True, band_width=W,
    )
    cscore = torch.where(cvalid, res1.score, 0)
    mark("dp")

    emit_moves = params.emit_moves or params.best_n > 1
    tb = walk_arrows_device(
        res1.arrows, qoff, res1.best_a, res1.best_w, cscore,
        qoff_params=(pad2, W, L), qoff_num=qoff_num, with_moves=emit_moves,
        qoff_knots=knots,
    )

    mark("walk")

    sc = cscore.reshape(B, CD)
    sv = cvalid.reshape(B, CD) & (sc < 0)

    # ---- genomic containment (RemoveOverlappingAlignments) ----
    gt_lo = (t0f + tb.t_start).reshape(B, CD)
    gt_hi = (t0f + tb.t_end).reshape(B, CD)

    def d_(x):
        return x[:, :, None]                                   # container axis

    def c_(x):
        return x[:, None, :]                                   # containee axis

    idx_cd = torch.arange(CD, dtype=I32, device=dev)[None, :]
    not_self = idx_cd[:, :, None] != idx_cd[:, None, :]
    contains = (
        (d_(gt_lo) <= c_(gt_lo))
        & (d_(gt_hi) >= c_(gt_hi))
        & (d_(dp_strand) == c_(dp_strand))
        & d_(sv) & c_(sv)
        & not_self
    )
    better = (d_(sc) < c_(sc)) | (
        (d_(sc) == c_(sc)) & (idx_cd[:, :, None] < idx_cd[:, None, :])
    )
    rlen = lengths[:, None]
    is_rc = dp_strand == 1
    wq_lo0 = tb.q_start.reshape(B, CD)
    wq_hi0 = tb.q_end.reshape(B, CD)
    rq_lo = torch.where(is_rc, rlen - wq_hi0, wq_lo0)
    rq_hi = torch.where(is_rc, rlen - wq_lo0, wq_hi0)
    contains_read = (
        (d_(rq_lo) <= c_(rq_lo))
        & (d_(rq_hi) >= c_(rq_hi))
        & d_(sv) & c_(sv)
        & not_self
    )
    removed = torch.any(contains & better, dim=1)
    sv = sv & ~removed
    if params.remove_contained:
        removed_read = torch.any(contains_read & better & sv[:, :, None], dim=1)
        sv_emit = sv & ~removed_read
    else:
        sv_emit = sv

    # ---- best_n per read: score ascending, ties by strand-space start ----
    BIG = 2**30
    tie_pos = torch.where(is_rc, G - gt_hi, gt_lo)
    o1 = torch.argsort(torch.where(sv_emit, tie_pos, BIG), dim=1, stable=True)
    sc_o1 = torch.gather(torch.where(sv_emit, sc, BIG), 1, o1)
    o2 = torch.argsort(sc_o1, dim=1, stable=True)
    order_cd = torch.gather(o1, 1, o2)
    topi = order_cd[:, : params.best_n]
    topv = -torch.gather(torch.where(sv_emit, sc, BIG), 1, topi)
    sel_item = (b_ar.long() * CD + topi).reshape(-1)
    sel_strand = torch.gather(dp_strand, 1, topi)
    sel_valid = (topv > -BIG).reshape(-1) & (topv.reshape(-1) > 0)

    # ---- MAPQ over all candidates ----
    mapq_all = map_qv_reference(
        sc, sv & (sc < 0), rq_lo, rq_hi,
        tb.n_match.reshape(B, CD), tb.n_mismatch.reshape(B, CD),
        tb.n_ins.reshape(B, CD), tb.n_del.reshape(B, CD),
        ins_cost=params.insertion_score, del_cost=params.deletion_score,
    )
    sel_mapq = torch.gather(mapq_all, 1, topi).reshape(-1)

    sel_ints = torch.stack(
        [
            res1.score[sel_item],
            t0f[sel_item],
            sel_strand.reshape(-1),
            sel_valid.to(I32),
            tb.nops[sel_item],
            tb.q_start[sel_item],
            tb.q_end[sel_item],
            tb.t_start[sel_item],
            tb.t_end[sel_item],
            tb.n_match[sel_item],
            tb.n_mismatch[sel_item],
            tb.n_ins[sel_item],
            tb.n_del[sel_item],
            sel_mapq,
            topi.reshape(-1).to(I32),
        ]
    ).to(I32)
    qlo_c, qhi_c, tlo_c, thi_c = ch_corners
    topj_l = topj.long()
    read_ints = torch.cat(
        [
            sc, sv.to(I32),
            torch.gather(to2(qlo_c), 1, topj_l),
            torch.gather(to2(qhi_c), 1, topj_l),
            torch.gather(to2(tlo_c), 1, topj_l),
            torch.gather(to2(thi_c), 1, topj_l),
            ambig.to(I32)[:, None],
        ],
        dim=1,
    ).to(I32)

    if emit_moves:
        moves_packed = pack_codes_rows(
            tb.moves_codes[sel_item], tb.nops[sel_item], packed_width(L + T - 1)
        )
    else:
        moves_packed = torch.zeros((sel_item.shape[0], 0), dtype=torch.uint8, device=dev)
    mark("select")
    return MapBatchResult(sel_ints, moves_packed, read_ints)


def map_batch_wire(
    codes: torch.Tensor, lengths: torch.Tensor, di: DeviceIndex,
    params: MappingParams, qual: torch.Tensor | None = None,
    clock: StageClock | None = None,
) -> torch.Tensor:
    """``map_batch_impl`` flattened to one uint8 buffer on the device."""
    res = map_batch_impl(codes, lengths, di, params, qual, clock)
    return torch.cat([
        res.sel_ints.contiguous().view(torch.uint8).reshape(-1),
        res.moves_packed.reshape(-1),
        res.read_ints.contiguous().view(torch.uint8).reshape(-1),
    ])


@dataclasses.dataclass
class Mapper:
    """Holds the device index and maps padded batches on ``device``."""

    index: GenomeIndex
    params: MappingParams
    _: dataclasses.KW_ONLY
    device: str | torch.device
    clock: StageClock | None = None  # per-stage timing (measurement runs)
    fm: object = None                # an index.fm.FMIndex: the -bwt anchoring path

    def __post_init__(self):
        self.params.validate()
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Mapper(device='cuda'): torch.cuda.is_available() is False"
            )
        if self.params.ndevices != 1:
            raise NotImplementedError("multi-device mapping is not ported yet")
        self.device_index = make_device_index(self.index, self.params, self.device, fm=self.fm)

    def map_batch(
        self, codes: np.ndarray, lengths: np.ndarray, qual: np.ndarray | None = None
    ) -> WireResult:
        """Map one padded batch. ``qual`` is the batch's phred rows: uint8,
        or uint16 for the dual stream (``io.batching.batch_reads``); it is
        dropped when the params ignore qualities."""
        p = self.params
        codes_d = torch.from_numpy(np.ascontiguousarray(codes)).to(self.device)
        lengths_d = torch.from_numpy(np.ascontiguousarray(lengths, np.int32)).to(self.device)
        qual_d = None
        if qual is not None and not p.ignore_qualities:
            if qual.dtype == np.uint16:
                qual = qual.view(np.int16)         # the dual stream's bits
            elif qual.dtype != np.uint8:
                raise ValueError(f"qual: expected uint8 or uint16, got {qual.dtype}")
            qual_d = torch.from_numpy(np.ascontiguousarray(qual)).to(self.device)
        wire = map_batch_wire(codes_d, lengths_d, self.device_index, p, qual_d, self.clock)
        B, L = codes.shape
        S = L + p.target_pad + L - 1
        return WireResult(
            wire=wire,
            i2=B * p.best_n,
            p=packed_width(S) if (p.emit_moves or p.best_n > 1) else 0,
            b=B,
            rcols=6 * p.dp_candidates + 1,
        )
