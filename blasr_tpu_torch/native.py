"""The C++ host helpers of the port and their plain numpy versions.

The port's copy of the entry points of ``blasr_tpu/native`` that it calls:
the SA-IS suffix-array builder, the FASTA body encoder, the move-string
unpacker, the SAM record fields, ``xeq_cigar`` and ``sam_fields``, and the
dense global aligner ``global_align`` (``csrc/host_native.cpp``, built by
``g++`` through ``ops/_build.py`` at first use). Each function runs the C++ code when the library is built and
its plain version, which gives the same result, when no ``g++`` is
present; each returns its result, never None.

The port's own additions: the -bestn secondary admission's
``sdp_interval_align`` and ``reference_anchor_list``, whose plain versions
are ``pipeline/secondary_refine.py``'s functions of those names
(``sdp_interval_align_plain``, ``reference_anchor_list_plain`` here).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from blasr_tpu_torch.core.encode import seq_to_codes
from blasr_tpu_torch.ops import _build
from blasr_tpu_torch.pipeline.secondary_refine import (
    reference_anchor_list as reference_anchor_list_plain,
    sdp_interval_align as sdp_interval_align_plain,
)


def available() -> bool:
    """True when the C++ helpers are built (else the plain versions run)."""
    return _build.load_host_library() is not None


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def sais(codes: np.ndarray) -> np.ndarray:
    """int64 suffix array of ``codes`` (past-the-end suffix smallest)."""
    lib = _build.load_host_library()
    if lib is None:
        from blasr_tpu_torch.index.suffix_array import build_suffix_array_plain

        return build_suffix_array_plain(codes)
    n = int(len(codes))
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if n < 2**31:
        sa = np.empty(n, np.int32)
        lib.bn_sais_i32(_ptr(codes), n, _ptr(sa))
        return sa.astype(np.int64)
    sa = np.empty(n, np.int64)
    lib.bn_sais_i64(_ptr(codes), n, _ptr(sa))
    return sa


def encode_strip_plain(data: bytes) -> np.ndarray:
    return seq_to_codes(b"".join(data.split()))


def encode_strip(data: bytes) -> np.ndarray:
    """ASCII sequence bytes -> uint8 codes, whitespace skipped."""
    lib = _build.load_host_library()
    if lib is None:
        return encode_strip_plain(data)
    out = np.empty(len(data), np.uint8)
    m = lib.bn_encode_strip(data, len(data), _ptr(out))
    return out[:m].copy()


def unpack_moves_plain(packed_row: np.ndarray, nops: int) -> np.ndarray:
    b = packed_row[:, None] >> np.array([0, 2, 4, 6], np.uint8)[None, :]
    ops_rev = (b & 3).reshape(-1)[:nops]
    return ops_rev[::-1].copy()


def unpack_moves(packed_row: np.ndarray, nops: int) -> np.ndarray:
    """One 2-bit packed move string (END->START) -> START->END ops (uint8)."""
    lib = _build.load_host_library()
    if lib is None:
        return unpack_moves_plain(packed_row, nops)
    packed_row = np.ascontiguousarray(packed_row, dtype=np.uint8)
    out = np.empty(max(nops, 1), np.uint8)
    lib.bn_unpack_moves(_ptr(packed_row), nops, _ptr(out))
    return out[:nops]


_EMPTY_U8 = np.zeros(1, np.uint8)
_FIELD_BUFS = threading.local()
_B2A = np.frombuffer(b"ACGTNN", np.uint8)


def _field_buf(cap: int):
    """Reusable output buffer (per thread): a new string buffer per record
    costs more than the record's fields."""
    buf = getattr(_FIELD_BUFS, "buf", None)
    if buf is None or len(buf) < cap:
        buf = ctypes.create_string_buffer(max(cap, 1 << 15))
        _FIELD_BUFS.buf = buf
    return buf


def _cigar(ops, q_aln: np.ndarray, t_aln: np.ndarray, q_start: int, t_start: int,
           pre_clip: int, post_clip: int, clip_op: str) -> str:
    """The CIGAR string of ``ops``: I (2) and D (3) as such, every other op
    = where ``q_aln[qpos]`` equals ``t_aln[tpos]`` inside the window and X
    elsewhere, run-length encoded between the clips that are positive."""
    ops = np.asarray(ops, np.uint8)
    qstep = (ops != 3).astype(np.int64)
    tstep = (ops != 2).astype(np.int64)
    qpos = q_start + np.cumsum(qstep) - qstep
    tpos = t_start + np.cumsum(tstep) - tstep
    sym = np.where(ops == 2, 0, np.where(ops == 3, 1, 3))
    inside = (ops != 2) & (ops != 3) & (tpos < len(t_aln))
    eq = np.zeros(ops.size, bool)
    eq[inside] = q_aln[qpos[inside]] == t_aln[tpos[inside]]
    sym[eq] = 2
    ends = np.flatnonzero(np.diff(sym)) + 1
    bounds = np.concatenate(([0], ends, [sym.size])) if sym.size else np.zeros(1, np.int64)
    runs = "".join(f"{int(bounds[i + 1] - bounds[i])}{'ID=X'[int(sym[bounds[i]])]}"
                   for i in range(len(bounds) - 1))
    pre = f"{pre_clip}{clip_op}" if pre_clip > 0 else ""
    post = f"{post_clip}{clip_op}" if post_clip > 0 else ""
    return pre + runs + post


def xeq_cigar_plain(ops, q_aln, t_aln, q_start, t_start, pre_clip, post_clip, clip_op):
    return _cigar(ops, np.asarray(q_aln, np.uint8), np.asarray(t_aln, np.uint8), q_start,
                  t_start, pre_clip, post_clip, clip_op)


def xeq_cigar(
    ops: np.ndarray, q_aln: np.ndarray, t_aln: np.ndarray,
    q_start: int, t_start: int, pre_clip: int, post_clip: int, clip_op: str,
) -> str:
    """Full SAM CIGAR string of an op array (1 M, 2 I, 3 D; START->END)
    with M split into = and X by comparing ``q_aln`` (aligned orientation)
    with ``t_aln`` from the path-local span starts, and ``pre_clip`` /
    ``post_clip`` runs of ``clip_op`` at the ends when positive."""
    lib = _build.load_host_library()
    if lib is None:
        return xeq_cigar_plain(ops, q_aln, t_aln, q_start, t_start, pre_clip, post_clip,
                               clip_op)
    ops = np.ascontiguousarray(ops, dtype=np.uint8)
    q_aln = np.ascontiguousarray(q_aln, dtype=np.uint8)
    t_aln = np.ascontiguousarray(t_aln, dtype=np.uint8)
    # worst case: every op alternates -> len(str(n)) + 1 per op, plus clips
    cap = 12 * (len(ops) + 2) + 48
    buf = ctypes.create_string_buffer(cap)
    n = lib.bn_xeq_cigar(
        _ptr(ops), len(ops), _ptr(q_aln), _ptr(t_aln), q_start, t_start,
        pre_clip, post_clip, clip_op.encode()[:1] or b"S", ctypes.addressof(buf), cap,
    )
    if n < 0:
        raise RuntimeError(f"bn_xeq_cigar overflowed its {cap}-byte buffer")
    return buf.raw[:n].decode()


def sam_fields_plain(packed_moves, nops, q_start, t_start, fwd_codes, qual, t_aln,
                     strand, clip_mode, clip_op):
    fwd = np.asarray(fwd_codes, np.uint8)
    n = len(fwd)
    aligned = np.where(fwd < 4, 3 - fwd, fwd)[::-1] if strand else fwd
    ops = unpack_moves_plain(np.asarray(packed_moves, np.uint8), nops)
    q_end = q_start + int((ops != 3).sum())
    clipped = clip_mode != 0
    cigar = _cigar(ops, aligned, np.asarray(t_aln, np.uint8), q_start, t_start,
                   q_start if clipped else 0, n - q_end if clipped else 0, clip_op)
    lo, hi = (q_start, q_end) if clip_mode == 2 else (0, n)
    seq = _B2A[np.minimum(aligned[lo:hi], 5)].tobytes().decode()
    if qual is None:
        return cigar, seq, "*"
    q = np.asarray(qual, np.uint8)
    q = q[::-1] if strand else q
    return cigar, seq, (q[lo:hi] + np.uint8(33)).tobytes().decode()


def sam_fields(
    packed_moves: np.ndarray, nops: int, q_start: int, t_start: int,
    fwd_codes: np.ndarray, qual: np.ndarray | None,
    t_aln: np.ndarray, strand: int, clip_mode: int, clip_op: str,
) -> tuple[str, str, str]:
    """(CIGAR, SEQ, QUAL) of a SAM record in one pass over the walk's packed
    move string (END->START): the read's forward codes and quality
    reverse-complemented and reversed on strand 1, matches split into = and
    X against ``t_aln``, clipped by ``clip_mode`` (0 none, 1 soft or
    subread, 2 hard) with ``clip_op`` runs."""
    lib = _build.load_host_library()
    if lib is None:
        return sam_fields_plain(packed_moves, nops, q_start, t_start, fwd_codes, qual, t_aln,
                                strand, clip_mode, clip_op)
    packed_moves = np.ascontiguousarray(packed_moves, dtype=np.uint8)
    fwd_codes = np.ascontiguousarray(fwd_codes, dtype=np.uint8)
    has_q = 0
    qarr = _EMPTY_U8
    if qual is not None:
        qarr = np.ascontiguousarray(qual, dtype=np.uint8)
        has_q = 1
    t_aln = np.ascontiguousarray(t_aln, dtype=np.uint8)
    n = len(fwd_codes)
    cap = 12 * (nops + 2) + 2 * n + 64
    buf = _field_buf(cap)
    lens = np.zeros(3, np.int64)
    total = lib.bn_sam_fields(
        _ptr(packed_moves), nops, q_start, t_start, _ptr(fwd_codes), n, _ptr(qarr), has_q,
        _ptr(t_aln), len(t_aln), strand, clip_mode, clip_op.encode()[:1] or b"S",
        ctypes.addressof(buf), cap, _ptr(lens),
    )
    if total < 0:
        raise RuntimeError(f"bn_sam_fields overflowed its {cap}-byte buffer")
    # slice the buffer itself (buf.raw would copy the whole reusable buffer)
    c0 = int(lens[0])
    s0 = c0 + 1 + int(lens[1])
    return (
        buf[:c0].decode(),
        buf[c0 + 1 : s0].decode(),
        buf[s0 + 1 : s0 + 1 + int(lens[2])].decode(),
    )


def global_align_plain(q, t, match, mismatch, nscore, ins, dele):
    """The numpy row sweep: the whole H matrix, each row's left dependency
    resolved by a scan, then the same traceback as the C++."""
    qn, tn = len(q), len(t)
    H = np.empty((qn + 1, tn + 1), np.int32)
    H[0, :] = np.arange(tn + 1, dtype=np.int32) * dele
    H[:, 0] = np.arange(qn + 1, dtype=np.int32) * ins
    t_arr = np.asarray(t).astype(np.int16)
    for i in range(1, qn + 1):
        qc = int(q[i - 1])
        sub = np.where(
            (t_arr == qc) & (qc < 4), match,
            np.where((t_arr >= 4) | (qc >= 4), nscore, mismatch),
        ).astype(np.int32)
        best = np.minimum(H[i - 1, :-1] + sub, H[i - 1, 1:] + ins)
        row = H[i]
        acc = row[0]
        for j in range(1, tn + 1):
            acc = min(best[j - 1], acc + dele)
            row[j] = acc
    ops_rev = []
    i, j = qn, tn
    while i > 0 or j > 0:
        if i > 0 and j > 0:
            qc, tc = int(q[i - 1]), int(t[j - 1])
            sub = (match if (qc == tc and qc < 4)
                   else nscore if (qc >= 4 or tc >= 4) else mismatch)
            if H[i, j] == H[i - 1, j - 1] + sub:
                ops_rev.append(1)
                i -= 1
                j -= 1
                continue
        if i > 0 and H[i, j] == H[i - 1, j] + ins:
            ops_rev.append(2)
            i -= 1
            continue
        ops_rev.append(3)
        j -= 1
    return np.asarray(ops_rev[::-1], np.uint8), int(H[qn, tn])


def global_align(
    q: np.ndarray, t: np.ndarray,
    match: int, mismatch: int, nscore: int, ins: int, dele: int,
) -> tuple[np.ndarray, int]:
    """Dense global alignment of codes ``q`` against ``t``, both ends pinned,
    linear gap costs, minimising: (ops uint8 START->END, 1 M 2 I 3 D;
    score). Ties go diagonal, then insertion, then deletion. The caller
    bounds the (len(q) + 1) x (len(t) + 1) matrix."""
    lib = _build.load_host_library()
    if lib is None:
        return global_align_plain(q, t, match, mismatch, nscore, ins, dele)
    q = np.ascontiguousarray(q, dtype=np.uint8)
    t = np.ascontiguousarray(t, dtype=np.uint8)
    ops = np.empty(len(q) + len(t) + 1, np.uint8)
    score = np.zeros(1, np.int32)
    n = lib.bn_global_align(_ptr(q), len(q), _ptr(t), len(t), match, mismatch, nscore, ins,
                            dele, _ptr(ops), _ptr(score))
    return ops[:n].copy(), int(score[0])


def sdp_interval_align(
    q_codes: np.ndarray, t_codes: np.ndarray, *,
    word: int = 11, sdp_ins: int = 5, sdp_del: int = 10, match: int = -5,
    mismatch: int = 6, n_score: int = 0, ins: int = 5, dele: int = 5,
    indel_rate: float = 0.9, prefix_len: int = 50, recurse: int = 2,
    no_recurse_under: int = 1000, cap: int = 0, affine: bool = True,
    affine_open: int = 50, affine_extend: int = 0, _align_type: str = "local",
) -> tuple[int, list]:
    """SDPAlign (Local, detailed) of ``q_codes`` against the window
    ``t_codes``: (score, blocks [[q, t, len], ...]), (0, []) when no
    fragment chains; ``sdp_interval_align_plain`` with the same keywords."""
    lib = _build.load_host_library()
    if lib is None:
        return sdp_interval_align_plain(
            q_codes, t_codes, word=word, sdp_ins=sdp_ins, sdp_del=sdp_del, match=match,
            mismatch=mismatch, n_score=n_score, ins=ins, dele=dele, indel_rate=indel_rate,
            prefix_len=prefix_len, recurse=recurse, no_recurse_under=no_recurse_under,
            cap=cap, affine=affine, affine_open=affine_open, affine_extend=affine_extend,
            _align_type=_align_type)
    q = np.ascontiguousarray(q_codes, dtype=np.uint8)
    t = np.ascontiguousarray(t_codes, dtype=np.uint8)
    score = np.zeros(1, np.int64)
    args = (_ptr(q), len(q), _ptr(t), len(t), word, sdp_ins, sdp_del, match, mismatch,
            n_score, ins, dele, float(indel_rate), prefix_len, recurse, no_recurse_under,
            cap, int(bool(affine)), affine_open, affine_extend, int(_align_type == "local"))
    blocks = np.empty((len(q) + 64, 3), np.int64)
    n = lib.bn_sdp_interval_align(*args, _ptr(blocks), len(blocks), _ptr(score))
    if n < 0:                                   # more blocks than the buffer holds
        blocks = np.empty((-n, 3), np.int64)
        n = lib.bn_sdp_interval_align(*args, _ptr(blocks), len(blocks), _ptr(score))
    return int(score[0]), blocks[:n].tolist()


def reference_anchor_list(
    q_codes: np.ndarray, genome: np.ndarray, sa: np.ndarray, sa_kmers: np.ndarray, k: int, *,
    min_match: int = 14, trim: int | None = None, max_ext: int = 256,
    max_range: int = 10_000, max_anchors_per_position: int = 1000, length_deficit: int = 5,
    lut: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's anchor list of one read orientation, (q, t, len)
    int64 arrays; ``reference_anchor_list_plain`` with the same keywords.
    ``lut``, the table of ``GenomeIndex.lut()`` of the index that ``sa`` and
    ``sa_kmers`` belong to, narrows each search to its key prefix's rows
    and leaves the result as it is."""
    lib = _build.load_host_library()
    if lib is None:
        return reference_anchor_list_plain(
            q_codes, genome, sa, sa_kmers, k, min_match=min_match, trim=trim,
            max_ext=max_ext, max_range=max_range,
            max_anchors_per_position=max_anchors_per_position, length_deficit=length_deficit)
    q = np.ascontiguousarray(q_codes, dtype=np.uint8)
    genome = np.ascontiguousarray(genome, dtype=np.uint8)
    # the index's own int32 or int64 arrays, read in place
    sa, sa_kmers = (np.ascontiguousarray(a, a.dtype if a.dtype in (np.int32, np.int64)
                                         else np.int64) for a in (sa, sa_kmers))
    if len(sa) < len(sa_kmers):
        raise ValueError(f"a suffix array of {len(sa)} rows for {len(sa_kmers)} k-mers")
    if trim is None:
        trim = min_match + 1
    lut_bits = 0
    if lut is not None:
        lut = np.ascontiguousarray(lut, np.int32)
        lut_bits = (len(lut) - 1).bit_length() - 1
        if len(lut) != (1 << lut_bits) + 1 or lut_bits > 2 * k:
            raise ValueError(f"a key-prefix table of {len(lut)} entries for k = {k}")
    args = (_ptr(q), len(q), _ptr(genome), len(genome), _ptr(sa), int(sa.dtype == np.int64),
            _ptr(sa_kmers), int(sa_kmers.dtype == np.int64), len(sa_kmers), k, min_match,
            trim, max_ext, max_range, max_anchors_per_position, length_deficit,
            None if lut is None else _ptr(lut), lut_bits)
    cap = 4 * len(q) + 64
    while True:
        out = np.empty((3, cap), np.int64)
        n = lib.bn_reference_anchor_list(*args, _ptr(out[0]), _ptr(out[1]), _ptr(out[2]), cap)
        if n >= 0:
            return out[0, :n].copy(), out[1, :n].copy(), out[2, :n].copy()
        cap = -n
