"""The -bestn secondary tail of a batch: which rank >= 1 records the
reference emits, and the refinement of those that take the SDP chain's
span.

``admit_and_refine`` takes a batch's valid records and returns those that
stay. Each secondary passes the reference's host admission
(``_admit_secondary``: SDPAlign over the candidate's chain, the
``min_interval`` anchor gate, ``-maxScore`` on the SDP score; the SDP passes
and the anchor list are ``native``'s, in C++ when the host library is
built). Where the SDP chain's span and the DP's disagree, the secondary is
refined along the chain (the reference's RefineAlignment,
``_refine_secondaries``: one guided DP call and one walk a batch) and
``-maxScore`` cuts the refined score. Each event is counted in
``ops.counters()["secondary"]`` and, for checked, gated and replaced
records, in the run's ``MappingMetrics``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from blasr_tpu_torch import native
from blasr_tpu_torch.io.batching import ReadBatch
from blasr_tpu_torch.ops import count_secondary
from blasr_tpu_torch.ops.banded_align import (
    KNOT_SPACING,
    QOFF_NUM_HALF,
    QV_NEUTRAL,
    QV_NEUTRAL_DUAL,
    make_qoff_knots,
)
from blasr_tpu_torch.ops.traceback_device import (
    pack_codes_rows,
    packed_width,
    walk_arrows_device,
)
from blasr_tpu_torch.ops.transfer import to_device, to_host
from blasr_tpu_torch.pipeline import mapper as mapper_mod
from blasr_tpu_torch.pipeline import trace
from blasr_tpu_torch.pipeline.mapper import Mapper, align_scores, host_qual
from blasr_tpu_torch.pipeline.secondary_refine import revcomp_codes, sum_anchors_window
from blasr_tpu_torch.pipeline.traceback import AlignmentPath

# RefineAlignment's band (GuidedAlign, 16 cells each side of the guide,
# Blasr.cpp:833-916)
REFINE_BAND = 32


class _Guide(NamedTuple):
    """A secondary that took the SDP chain's span, as its refinement takes
    it: its batch row and strand, the chain's span of the oriented read,
    the genome window around the chain's span (global, inside its contig),
    the chain's blocks as (oriented read, global genome, length), and the
    DP item's window start, the origin of the record's target coordinates."""

    row: int
    strand: int
    q_lo: int
    q_hi: int
    g_lo: int
    g_hi: int
    blocks: list
    t0: int


class _BatchState:
    """What the secondaries of one batch share, made once a batch: the SDP
    keywords, whether the C++ helpers run (``native`` counts the checked
    records then), the index's key-prefix table (none on an FM-only index),
    and per (row, strand) the oriented read and its reference anchor list,
    each made at its first use."""

    def __init__(self, mapper: Mapper, batch: ReadBatch, res):
        self.mapper, self.batch, self.res = mapper, batch, res
        p = mapper.params
        self.sdp_kw = dict(
            word=p.sdp_tuple_size, match=p.match_score, mismatch=p.mismatch_score,
            ins=p.insertion_score, dele=p.deletion_score, indel_rate=p.indel_rate * 3,
            affine_open=p.affine_open, affine_extend=p.affine_extend,
        )
        self.native = native.available()
        index = mapper.index
        self.lut = index.lut()[0] if len(index.sa) else None
        self._reads: dict = {}
        self._anchors: dict = {}

    def read(self, b: int, strand: int) -> np.ndarray:
        """Row ``b``'s read on ``strand`` (reverse complemented on 1)."""
        q = self._reads.get((b, strand))
        if q is None:
            q = self.batch.codes[b, : int(self.batch.lengths[b])]
            if strand:
                q = revcomp_codes(q)
            self._reads[b, strand] = q
        return q

    def anchors(self, b: int, strand: int) -> tuple:
        """The reference's anchor list of ``read(b, strand)`` from the host's
        suffix array, its searches started from the index's key-prefix
        table."""
        got = self._anchors.get((b, strand))
        if got is None:
            index = self.mapper.index
            got = self._anchors[b, strand] = native.reference_anchor_list(
                self.read(b, strand), index.genome, index.sa, index.sa_kmers, index.k,
                min_match=self.mapper.params.min_match_length, lut=self.lut)
        return got


def admit_and_refine(
    mapper: Mapper, batch: ReadBatch, res, records: Sequence, met,
) -> list[tuple[int, AlignmentPath, int, bool]]:
    """The records of a batch that the reference emits, from its valid
    records ``records``, (i2, path, score) in order, as (i2, path, score,
    refined). A rank 0 record, and every record at ``best_n == 1``, passes
    through. A secondary passes ``_admit_secondary`` in a ``secondary`` span
    of ``mapper.clock``; those that took the SDP chain's span are refined
    together in one ``refine`` span, and -maxScore cuts the refined score
    (RemoveLowQuality after RefineAlignments, Blasr.cpp:2615-2618).
    ``met.secondary_seconds`` sums the spans."""
    params = mapper.params
    if params.best_n == 1:
        return [(i2, path, score, False) for i2, path, score in records]
    state = _BatchState(mapper, batch, res)
    kept: list = []
    guides: dict[int, _Guide] = {}      # kept's index -> guide
    for i2, path, score in records:
        if i2 % params.best_n:
            t_adm = trace.begin(mapper.clock, "secondary")
            admitted = _admit_secondary(state, i2 // params.best_n, i2, path, met)
            met.secondary_seconds += (trace.end(mapper.clock) - t_adm) * 1e-9
            if admitted is None:
                continue
            path, score, guide = admitted
            if guide is not None:
                guides[len(kept)] = guide
        kept.append((i2, path, score, False))
    if not guides:
        return kept
    t_ref = trace.begin(mapper.clock, "refine")
    refined = _refine_secondaries(state, list(guides.values()))
    met.secondary_seconds += (trace.end(mapper.clock) - t_ref) * 1e-9
    for k, path in zip(guides, refined):
        ok = path is not None and path.score <= params.max_score
        count_secondary("refined" if ok else "cut_refined")
        kept[k] = (kept[k][0], path, path.score, True) if ok else None
    return [r for r in kept if r is not None]


def _admit_secondary(
    state: _BatchState, b: int, i2: int, path: AlignmentPath, met,
) -> Optional[tuple[Optional[AlignmentPath], int, Optional[_Guide]]]:
    """The -bestn secondary admission of rank >= 1 record ``i2`` (row ``b``
    of the batch), reference semantics: each candidate interval's reported
    alignment is its SDPAlign (Local, detailed) result and the -maxScore cut
    acts on THAT score (AlignIntervals Blasr.cpp:1716-1724 ->
    RemoveLowQualityAlignments :2618 truncation). Returns None when the
    reference never emits the record: no chain, an anchor sum over the
    interval window at or below ``min_interval``, or an SDP score above
    ``max_score``. Else (path, score, None) with the DP's path and score
    when the SDP chain covers the same span (0.9 overlap on both axes), or
    (None, SDP score, guide) when the record takes the chain's span: the
    batch's refinement aligns it along the chain (``_refine_secondaries``)."""
    params = state.mapper.params
    index = state.mapper.index
    res = state.res
    seqdb = index.seqdb
    genome = index.genome
    count_secondary("checked")
    met.secondary_checked += 1
    if state.native:
        count_secondary("native")
    st = int(res.sel_strand[i2])
    n_b = int(state.batch.lengths[b])
    qc = state.read(b, st)
    t0_i = int(res.sel_t0[i2])
    # PASS 1, chain discovery: SDP Local on an unstretched window around
    # the device chain corners with end matching off (prefix_len=0, so
    # window-edge junk cannot seed the chain); its span reproduces the
    # reference's interval corners
    cd_i = int(res.sel_cd[i2])
    g_lo_ch = int(res.cand_tlo[b, cd_i])
    g_hi_ch = int(res.cand_thi[b, cd_i])
    g_mid = (g_lo_ch + g_hi_ch) // 2
    ci_w = int(seqdb.contig_of(min(max(g_mid, 0), seqdb.total_length - 1)))
    c_lo, c_hi = int(seqdb.starts[ci_w]), int(seqdb.starts[ci_w + 1])
    w0_lo = max(g_lo_ch - 64, c_lo)
    w0_hi = min(g_hi_ch + 64, c_hi)
    _, b0 = native.sdp_interval_align(qc, genome[w0_lo:w0_hi], prefix_len=0, **state.sdp_kw)
    if not b0:
        count_secondary("cut_sdp")
        return None
    q_lo0 = b0[0][0]
    q_hi0 = b0[-1][0] + b0[-1][2]
    t_lo0 = w0_lo + b0[0][1]
    t_hi0 = w0_lo + b0[-1][1] + b0[-1][2]
    # interval-formation gate (StoreLargestIntervals minSize: SumAnchors
    # over a readLen*(1+indelRate) window holding the cluster must EXCEED
    # minInterval, FindMaxInterval.h:479). FM-only indexes (-bwt) hold no
    # suffix array and skip the gate, as the JAX runner does
    if len(index.sa):
        L_int = int(n_b * (1 + params.indel_rate))
        ws_lo = max(min(t_lo0, t_hi0 - L_int), c_lo)
        ws_hi = min(max(t_hi0, t_lo0 + L_int), c_hi)
        _aq, at_r, al_r = state.anchors(b, st)
        if sum_anchors_window(at_r, al_r, ws_lo, ws_hi) <= params.min_interval:
            count_secondary("gated")
            met.secondary_gated += 1
            return None
    # PASS 2, the reference's aligned interval: chain corners stretched by
    # approximateMaxInsertionRate=1.3 times the unaligned read prefix and
    # suffix (Blasr.cpp:1247-1263), full SDPAlign (Local, detailed,
    # sdpPrefix=50)
    w_lo = max(int(t_lo0 - q_lo0 * 1.3), c_lo)
    w_hi = min(int(t_hi0 + (n_b - q_hi0) * 1.3), c_hi)
    sdp_sc, sdp_blocks = native.sdp_interval_align(qc, genome[w_lo:w_hi], **state.sdp_kw)
    if not sdp_blocks or sdp_sc > params.max_score:
        count_secondary("cut_sdp")
        return None
    q_s2 = sdp_blocks[0][0]
    q_e2 = sdp_blocks[-1][0] + sdp_blocks[-1][2]
    t_s2 = w_lo + sdp_blocks[0][1] - t0_i
    t_e2 = w_lo + sdp_blocks[-1][1] + sdp_blocks[-1][2] - t0_i

    def _agree(lo1, hi1, lo2, hi2):
        ov = min(hi1, hi2) - max(lo1, lo2)
        return ov / max(hi1 - lo1, hi2 - lo2, 1) >= 0.9

    if _agree(path.q_start, path.q_end, q_s2, q_e2) and _agree(
            path.t_start, path.t_end, t_s2, t_e2):
        return path, int(res.sel_score[i2]), None
    count_secondary("replaced")
    met.secondary_replaced += 1
    # the genome window: the chain's span, widened by the band after it and
    # by a knot spacing before it, so that the chain's first cell sits on a
    # knot (query 0, target KNOT_SPACING) and the band's clip at query 0
    # bends the knots' lerp only before it
    guide = _Guide(
        row=b, strand=st, q_lo=q_s2, q_hi=q_e2,
        g_lo=max(t0_i + t_s2 - KNOT_SPACING, c_lo),
        g_hi=min(t0_i + t_e2 + REFINE_BAND // 2, c_hi),
        blocks=[(bq, w_lo + bt, bl) for bq, bt, bl in sdp_blocks], t0=t0_i,
    )
    return None, sdp_sc, guide


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _chain_knots(guides: Sequence[_Guide], S: int, L: int, W: int) -> np.ndarray:
    """(I, NK) guide knots of the refinement's band, the role of the guide
    that RefineAlignment's GuidedAlign builds from the alignment's blocks
    (Blasr.cpp:833-916): the guided DP's knots (``make_qoff_knots``) with
    each block's first and last cell as anchors in the item's frame (query
    from ``q_lo``, target from ``g_lo``), so the band of ``W`` cells is
    centred on them, lerped between them and along the diagonal (slope
    1/2, ``QOFF_NUM_HALF``) before the first and after the last."""
    A = 2 * max(len(g.blocks) for g in guides)
    a = np.zeros((len(guides), A), np.int32)
    v = np.zeros((len(guides), A), np.int32)
    mask = np.zeros((len(guides), A), bool)
    for i, g in enumerate(guides):
        bl = np.asarray(g.blocks, np.int64)
        q, t, last = bl[:, 0] - g.q_lo, bl[:, 1] - g.g_lo, bl[:, 2] - 1
        n = 2 * len(bl)
        a[i, :n] = np.stack([q + t, q + t + 2 * last], axis=1).ravel()
        v[i, :n] = np.stack([q, q + last], axis=1).ravel() - W // 2
        mask[i, :n] = True
    return make_qoff_knots(torch.from_numpy(a), torch.from_numpy(v), torch.from_numpy(mask),
                           S, L, W, diag=0, num=QOFF_NUM_HALF).numpy()


def _refine_secondaries(state: _BatchState,
                        guides: list[_Guide]) -> list[Optional[AlignmentPath]]:
    """RefineAlignment (Blasr.cpp:799; its default guided mode, :833-916)
    of a batch's secondaries that took the SDP chain's span: each chain's
    query span against its genome window, with the read's phred stream,
    in one guided DP call with arrows whose band of ``REFINE_BAND`` cells
    follows the chain's blocks (``_chain_knots``), then
    one walk with moves; one copy in, one fetch. Returns each guide's
    path (its score the DP's), None where the DP found no alignment. The
    DP is looked up on ``pipeline.mapper`` at the call, as the batch's is."""
    mapper, batch = state.mapper, state.batch
    params = mapper.params
    genome = mapper.index.genome
    W = REFINE_BAND
    I = len(guides)
    # room for half a band past the longest span, so the band's clip at
    # L - W leaves the chain's last cells inside it
    L = _round8(max(g.q_hi - g.q_lo for g in guides) + W // 2)
    T = _round8(max(g.g_hi - g.g_lo for g in guides))
    S = L + T - 1
    knots = _chain_knots(guides, S, L, W)
    NK = knots.shape[1]
    qual_rows = host_qual(batch.qual, params)
    query = np.full((I, L), 4, np.uint8)
    target = np.full((I, T), 5, np.uint8)
    bounds = np.zeros((3, I), np.int32)         # qlen, tlo, thi
    qual = None
    if qual_rows is not None:
        neutral = QV_NEUTRAL_DUAL if qual_rows.dtype == np.int16 else QV_NEUTRAL
        qual = np.full((I, L), neutral, qual_rows.dtype)
    for i, g in enumerate(guides):
        n_q = g.q_hi - g.q_lo
        query[i, :n_q] = state.read(g.row, g.strand)[g.q_lo : g.q_hi]
        if qual is not None:
            row = qual_rows[g.row, : int(batch.lengths[g.row])]
            qual[i, :n_q] = (row[::-1] if g.strand else row)[g.q_lo : g.q_hi]
        target[i, : g.g_hi - g.g_lo] = genome[g.g_lo : g.g_hi]
        bounds[0, i] = n_q
        bounds[2, i] = g.g_hi - g.g_lo
    # every input in one copy: the int32 parts first, so each part's byte
    # offset is a multiple of its item size (L and T are multiples of 8)
    parts = [bounds.reshape(-1).view(np.uint8), knots.reshape(-1).view(np.uint8),
             query.reshape(-1), target.reshape(-1)]
    if qual is not None:
        parts.append(qual.reshape(-1).view(np.uint8))
    buf = to_device(np.concatenate(parts), mapper.device, mapper.clock)
    n_int = 4 * (3 + NK) * I
    head = buf[:n_int].view(torch.int32)
    query_t = buf[n_int : n_int + I * L].view(I, L)
    target_t = buf[n_int + I * L : n_int + I * (L + T)].view(I, T)
    qual_t = None
    if qual is not None:
        qual_t = buf[n_int + I * (L + T) :].view(torch.int16 if qual.dtype == np.int16
                                               else torch.uint8).view(I, L)
    knots_t = head[3 * I :].view(I, NK)
    res = mapper_mod.banded_align(
        query_t, head[:I], target_t, head[I : 2 * I], head[2 * I : 3 * I], None, qual_t,
        knots=knots_t, scores=align_scores(params), with_traceback=True, band_width=W,
    )
    tb = walk_arrows_device(res.arrows, None, res.best_a, res.best_w, res.score,
                            with_moves=True, qoff_knots=knots_t)
    P = packed_width(S)
    moves = pack_codes_rows(tb.moves_codes, tb.nops, P)
    fields = torch.stack([res.score, tb.nops, tb.q_start, tb.q_end, tb.t_start, tb.t_end,
                          tb.n_match, tb.n_mismatch, tb.n_ins, tb.n_del]).to(torch.int32)
    host = to_host(torch.cat([fields.reshape(-1).view(torch.uint8), moves.reshape(-1)]),
                   mapper.clock)
    score, nops, qs, qe, ts, te, nm, nx, ni, nd = host[: 40 * I].view(np.int32).reshape(10, I)
    mv = host[40 * I :].reshape(I, P)
    count_secondary("refine_calls")
    out: list[Optional[AlignmentPath]] = []
    for i, g in enumerate(guides):
        if score[i] >= 0 or nops[i] == 0:
            out.append(None)
            continue
        shift = g.g_lo - g.t0
        out.append(AlignmentPath(
            q_start=g.q_lo + int(qs[i]), q_end=g.q_lo + int(qe[i]),
            t_start=shift + int(ts[i]), t_end=shift + int(te[i]),
            ops=None, packed=mv[i], packed_nops=int(nops[i]), score=int(score[i]),
            n_match=int(nm[i]), n_mismatch=int(nx[i]), n_ins=int(ni[i]), n_del=int(nd[i]),
        ))
    return out
