"""The plain host references of the -bestn secondary admission; the
port's copy of ``blasr_tpu/pipeline/secondary_refine.py``, host numpy.

The port calls four of its functions. ``sdp_interval_align`` (SDPAlign,
Local and detailed, over a candidate interval) and
``reference_anchor_list`` (the reference's anchor list of one read
orientation) are the plain versions of the C++ helpers of those names:
``native`` runs these when no ``g++`` built the host library, and the
tests hold the C++ to them. ``sum_anchors_window`` (the ``min_interval``
gate's anchor sum) and ``revcomp_codes`` are called as they are, by
``pipeline/secondary.py``.

The rest is kept whole as a copy of the JAX module, which the tests hold
equal line for line: ``sdp_block_score`` among it, a scoring of a DP
path's exact blocks that the port never runs, and ``stats_from_blocks``
and ``blocks_to_ops``, which the JAX runner uses for a record that takes
the SDP chain's blocks (the port refines such a record instead).
"""

from __future__ import annotations

import numpy as np

OP_M, OP_I, OP_D = 1, 2, 3


def sdp_block_score(
    q_codes: np.ndarray,   # (Lq,) uint8 query codes in WALKED orientation
    t_codes: np.ndarray,   # (Lt,) uint8 target codes (forward genome slice)
    ops: np.ndarray,       # path ops (OP_M/I/D) start->end, walked coords
    q_start: int,          # path start within q_codes
    t_start: int,          # path start within t_codes
    *,
    match: int = -5,
    mismatch: int = 6,
    n_score: int = 0,
    ins: int = 5,          # query-gap (insertion) cost, -indel
    dele: int = 5,         # target-gap (deletion) cost, -deletion
    min_run: int = 11,     # sdpTupleSize (MappingParameters.h default 11)
) -> int:
    """Block-chain score of a DP path under the reference's SDP-stats
    semantics. Returns 0 (empty) when the path carries no exact match run
    of at least ``min_run`` bases."""
    ops = np.asarray(ops)
    if ops.size == 0:
        return 0
    is_q = (ops == OP_M) | (ops == OP_I)
    is_t = (ops == OP_M) | (ops == OP_D)
    qi = q_start + np.cumsum(is_q) - is_q
    ti = t_start + np.cumsum(is_t) - is_t
    m_cols = ops == OP_M
    qm = q_codes[qi[m_cols]]
    tm = t_codes[ti[m_cols]]
    exact = (qm == tm) & (qm < 4)

    # maximal exact runs along the path: a run breaks on a mismatch column
    # or any indel column between M columns
    col_of_m = np.flatnonzero(m_cols)
    # break before an M column if the previous path column is not an
    # adjacent exact M column
    prev_adj = np.zeros(exact.shape, bool)
    if exact.size > 1:
        prev_adj[1:] = exact[:-1] & (np.diff(col_of_m) == 1)
    run_start = exact & ~prev_adj
    run_id = np.cumsum(run_start) - 1
    run_len = np.zeros(int(run_id[-1]) + 1 if exact.any() else 0, np.int64)
    if exact.any():
        np.add.at(run_len, run_id[exact], 1)
    keep = np.flatnonzero(run_len >= min_run)
    if keep.size == 0:
        return 0
    starts_m = np.flatnonzero(run_start)          # index into M columns
    bq = qi[col_of_m[starts_m[keep]]]             # block q starts
    bt = ti[col_of_m[starts_m[keep]]]
    bl = run_len[keep]

    score = int(match) * int(bl.sum())
    for j in range(len(keep) - 1):
        qgap = int(bq[j + 1] - (bq[j] + bl[j]))
        tgap = int(bt[j + 1] - (bt[j] + bl[j]))
        common = min(qgap, tgap)
        # the two gap directions carry their own costs (reference
        # ComputeAlignmentStats scores -indel and -deletion separately)
        score += ins * (qgap - common) + dele * (tgap - common)
        if common > 0:
            qc = q_codes[bq[j + 1] - common : bq[j + 1]]
            tc = t_codes[bt[j + 1] - common : bt[j + 1]]
            eq = (qc == tc) & (qc < 4)
            anyn = (qc >= 4) | (tc >= 4)
            score += int(
                np.where(eq, match, np.where(anyn, n_score, mismatch)).sum()
            )
    return score


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of 0..4 codes (4 = N maps to itself)."""
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    return comp[codes[::-1]]


# ---------------------------------------------------------------------------
# Reference-faithful SDP interval alignment (the -bestn secondary scorer).
#
# Role of SDPAlign(..., Local, detailed) as called from AlignIntervals
# (Blasr.cpp:1716-1724) — the alignment whose ComputeAlignmentStats score
# feeds RemoveLowQualityAlignments' -maxScore truncation (Blasr.cpp:2618,
# 2022-2090). A secondary interval whose seed chain supports only part of
# the read scores far above -maxScore THERE (the chain-global replay pays
# for every gap), even though its best LOCAL subpath — our DP score —
# passes; this is the round-4-identified -bestn tail mechanism. The
# pipeline emits the primary from its own (better-scoring) local DP and
# runs this aligner for rank >= 1 candidates only.
# ---------------------------------------------------------------------------


def _kmer_match_positions(q, t, k, q_off=0, t_off=0):
    """Exact k-mer matches (StoreMatchingPositions, TupleMatching.h:37-61):
    every (query pos, target pos) pair with identical N-free k-mers."""
    if len(q) < k or len(t) < k:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    base = np.int64(5)

    def keys(s):
        s = s.astype(np.int64)
        ok = np.ones(len(s) - k + 1, bool)
        key = np.zeros(len(s) - k + 1, np.int64)
        mul = np.int64(1)
        for j in range(k):
            w = s[j : j + len(key)]
            key += w * mul
            ok &= w < 4
            mul *= base
        return key, ok

    tk, tok = keys(t)
    qk, qok = keys(q)
    order = np.argsort(tk[tok], kind="stable")
    t_pos = np.flatnonzero(tok)[order]
    t_sorted = tk[tok][order]
    # one vectorized searchsorted pair over every query position, interval
    # expansion by repeat arithmetic (the per-position Python loop was the
    # -bestn>1 host hot spot: ~250k tiny searchsorted calls per batch)
    qidx = np.flatnonzero(qok)
    lo = np.searchsorted(t_sorted, qk[qidx], side="left")
    hi = np.searchsorted(t_sorted, qk[qidx], side="right")
    cnt = hi - lo
    nz = cnt > 0
    if not nz.any():
        return np.empty(0, np.int64), np.empty(0, np.int64)
    starts = lo[nz]
    lens = cnt[nz]
    total = int(lens.sum())
    base_off = np.repeat(
        starts - (np.cumsum(lens) - lens), lens
    ) + np.arange(total)
    xs = np.repeat(qidx[nz], lens) + q_off
    ys = t_pos[base_off] + t_off
    return xs, ys


class _Frag:
    __slots__ = ("x", "y", "length", "weight", "cost", "chain_prev",
                 "chain_len", "above", "index")

    def __init__(self, x, y, length, weight):
        self.x = x
        self.y = y
        self.length = length
        self.weight = weight
        self.cost = 0
        self.chain_prev = -1
        self.chain_len = 0
        self.above = -1
        self.index = -1


def _sdp_chain_local(frags, k, sdp_ins, sdp_del, match):
    """SDPLongestCommonSubsequence (SparseDynamicProgramming.h:71-322),
    Local variant: Baker–Giancarlo sweep with the reference's exact
    transition structure — colSet (retired fragments, per-column minima
    with the suffix invariant), sweepSet (fragments within the last k
    rows, ordered by DIAGONAL y-x then x; SDPFragment.h:78-90), and the
    precomputed 'above' neighbour (StoreAbove). Returns the min-cost chain
    as a list of fragment indices (start -> end)."""
    import bisect

    if not frags:
        return []
    INF = 1 << 60
    frags.sort(key=lambda f: (f.x, f.y))
    for i, f in enumerate(frags):
        f.index = i
    # StoreAbove: in (y, x) order, mark the immediate predecessor that
    # overlaps in x and has smaller y
    by_y = sorted(frags, key=lambda f: (f.y, f.x))
    for i in range(1, len(by_y)):
        p, c = by_y[i - 1], by_y[i]
        if p.x <= c.x < p.x + p.length and p.y < c.y:
            c.above = p.index

    sweep_keys = []   # sorted (diag, x) keys
    sweep_vals = []   # fragment refs, parallel
    col_keys = []     # sorted column values
    col_vals = []     # optFragment index, parallel

    min_cost, min_idx = INF, -1
    f_sweep = 0
    f_trail = 0
    n = len(frags)
    row0 = frags[0].x
    qlen_rows = max(f.x for f in frags) + k + 1
    for row in range(row0, qlen_rows + 1):
        start_f = f_sweep
        while f_sweep < n and frags[f_sweep].x == row:
            cur = frags[f_sweep]
            cp = cl = ca = INF
            found = False
            # colSet predecessor: greatest col < cur.y
            j = bisect.bisect_left(col_keys, cur.y) - 1
            if j >= 0:
                pf = frags[col_vals[j]]
                cp = (
                    pf.cost
                    + int(np.sqrt(abs((cur.x + cur.y) - (pf.x + pf.y))))
                    - k
                )
                cp_prev = col_vals[j]
                found = True
            # sweepSet predecessor: greatest (diag, x) < (cur diag, cur x)
            j = bisect.bisect_left(sweep_keys, (cur.y - cur.x, cur.x)) - 1
            if j >= 0:
                pf = sweep_vals[j]
                drift = (cur.x - cur.y) - (pf.x - pf.y)
                pen = drift * sdp_ins if drift > 0 else -drift * sdp_del
                cl = (
                    pf.cost
                    + min((k - (cur.y - pf.y)) * match, 0)
                    + pen
                )
                cl_prev = pf.index
                found = True
            if cur.above >= 0:
                pf = frags[cur.above]
                drift = (cur.x - cur.y) - (pf.x - pf.y)
                pen = drift * sdp_ins if drift > 0 else -drift * sdp_del
                ca = (
                    pf.cost
                    + (k - (cur.y - pf.y)) * match
                    + pen
                )
                found = True
            mc = min(cp, cl, ca)
            if found and mc < 0:          # Local: extend only paying chains
                cur.cost = mc - cur.weight
                if mc == cp:
                    cur.chain_prev = cp_prev
                elif mc == cl:
                    cur.chain_prev = cl_prev
                else:
                    cur.chain_prev = cur.above
                cur.chain_len = frags[cur.chain_prev].chain_len + 1
            else:
                cur.chain_prev = -1
                cur.cost = k * match - cur.weight
                cur.chain_len = 1
            if cur.cost < min_cost:
                min_cost, min_idx = cur.cost, cur.index
            f_sweep += 1
        # insert the row's fragments into the sweep set
        for fi in range(start_f, f_sweep):
            key = (frags[fi].y - frags[fi].x, frags[fi].x)
            j = bisect.bisect_left(sweep_keys, key)
            if j < len(sweep_keys) and sweep_keys[j] == key:
                sweep_vals[j] = frags[fi]
            else:
                sweep_keys.insert(j, key)
                sweep_vals.insert(j, frags[fi])
        # retire fragments older than k rows into the column set
        if row >= k + 1:
            trail_row = row - k - 1
            while f_trail < n and frags[f_trail].x < trail_row:
                f_trail += 1
            while f_trail < n and frags[f_trail].x == trail_row:
                tf = frags[f_trail]
                j = bisect.bisect_left(col_keys, tf.y)
                member = j < len(col_keys) and col_keys[j] == tf.y
                # NOTE the reference's replacement condition reads
                # existing.cost < trail.cost (SparseDynamicProgramming.h:
                # 259-267) — it replaces a column entry when the EXISTING
                # one scores better, and keeps the old entry otherwise.
                # Inverted or not, the golden output is defined by this
                # exact behavior, so it is replicated verbatim.
                store = (not member) or frags[col_vals[j]].cost < tf.cost
                if store:
                    if j < len(col_keys) and col_keys[j] == tf.y:
                        col_vals[j] = tf.index
                    else:
                        col_keys.insert(j, tf.y)
                        col_vals.insert(j, tf.index)
                        j = bisect.bisect_left(col_keys, tf.y)
                    # suffix invariant: drop later columns with worse cost
                    jj = j + 1
                    while (
                        jj < len(col_keys)
                        and frags[col_vals[jj]].cost > tf.cost
                    ):
                        del col_keys[jj]
                        del col_vals[jj]
                key = (tf.y - tf.x, tf.x)
                j = bisect.bisect_left(sweep_keys, key)
                if j < len(sweep_keys) and sweep_keys[j] == key:
                    del sweep_keys[j]
                    del sweep_vals[j]
                f_trail += 1
    if min_idx < 0:
        return []
    chain = []
    i = min_idx
    while i != -1:
        chain.append(i)
        i = frags[i].chain_prev
    chain.reverse()
    return chain


def _chain_to_blocks(frags, chain, indel_rate):
    """Chain fragments -> gapless blocks (SDPAlign.h:298-414): condense
    contiguous (x+1, y+1) runs, trim overlaps against the next block, drop
    zero-length blocks and off-diagonal outliers (3-sigma random-walk
    heuristic with indelRate)."""
    blocks = []
    f = 0
    while f < len(chain):
        start_f = f
        while (
            f < len(chain) - 1
            and frags[chain[f]].x == frags[chain[f + 1]].x - 1
            and frags[chain[f]].y == frags[chain[f + 1]].y - 1
        ):
            f += 1
        qpos = frags[chain[start_f]].x
        tpos = frags[chain[start_f]].y
        length = frags[chain[f]].x + frags[chain[f]].length - qpos
        blocks.append([qpos, tpos, length])
        f += 1
    for b in range(len(blocks) - 1):
        if blocks[b][0] + blocks[b][2] > blocks[b + 1][0]:
            blocks[b][2] = blocks[b + 1][0] - blocks[b][0]
        if blocks[b][1] + blocks[b][2] > blocks[b + 1][1]:
            blocks[b][2] = blocks[b + 1][1] - blocks[b][1]
    good = [blk[2] > 0 for blk in blocks]
    for b in range(1, len(blocks) - 1):
        prev_diag = abs(
            (blocks[b][1] - blocks[b][0])
            - (blocks[b - 1][1] - blocks[b - 1][0])
        )
        prev_dist = min(
            blocks[b][1] - blocks[b - 1][1], blocks[b][0] - blocks[b - 1][0]
        )
        next_diag = abs(
            (blocks[b + 1][1] - blocks[b + 1][0])
            - (blocks[b][1] - blocks[b][0])
        )
        next_dist = min(
            blocks[b + 1][1] - blocks[b][1], blocks[b + 1][0] - blocks[b][0]
        )
        if prev_dist * indel_rate < prev_diag and next_dist * indel_rate < next_diag:
            good[b] = False
    return [blocks[b] for b in range(len(blocks)) if good[b]]


def _sub_cost(qc, tc, match, mismatch, n_score):
    if qc >= 4 or tc >= 4:
        return n_score
    return match if qc == tc else mismatch


def _sw_global(q, t, match, mismatch, n_score, ins, dele):
    """Global alignment (SWAlign.h Global type), linear gaps; returns
    gapless blocks [[q, t, len], ...]. Vectorized rows; traceback favors
    diagonal on ties (block boundaries only — the SCORE is tie-free)."""
    nq, nt = len(q), len(t)
    if nq == 0 or nt == 0:
        return []
    qv = q.astype(np.int16)
    tv = t.astype(np.int16)
    sub = np.where(
        (qv[:, None] >= 4) | (tv[None, :] >= 4),
        np.int32(n_score),
        np.where(qv[:, None] == tv[None, :], np.int32(match), np.int32(mismatch)),
    )
    H = np.zeros((nq + 1, nt + 1), np.int32)
    H[0, :] = np.arange(nt + 1, dtype=np.int32) * dele
    H[:, 0] = np.arange(nq + 1, dtype=np.int32) * ins
    for i in range(1, nq + 1):
        row_prev = H[i - 1]
        diag = row_prev[:-1] + sub[i - 1]
        up = row_prev[1:] + ins
        row = np.minimum(diag, up)
        # left dependency is sequential: running min scan
        r = H[i]
        r[0] = H[i, 0]
        acc = r[0]
        for j in range(1, nt + 1):
            acc = min(row[j - 1], acc + dele)
            r[j] = acc
    # traceback
    blocks = []
    i, j = nq, nt
    cur_len = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and H[i, j] == H[i - 1, j - 1] + sub[i - 1, j - 1]:
            i -= 1
            j -= 1
            cur_len += 1
        else:
            if cur_len:
                blocks.append([i, j, cur_len])
                cur_len = 0
            if i > 0 and H[i, j] == H[i - 1, j] + ins:
                i -= 1
            elif j > 0:
                j -= 1
            else:
                i -= 1
    if cur_len:
        blocks.append([0, 0, cur_len])
    blocks.reverse()
    return blocks


def _gather_fragments(q, t, word, prefix_len, cap):
    """SDPAlign.h:140-266 fragment collection: whole-sequence word-k
    matches plus small-word (5) matches in the first/last prefix_len bases
    of query AND target, deduped by (x, y). weight is the big word size
    for every fragment; length is each fragment's own word size."""
    small = min(word, 5)
    frags = []

    def add(matches, length):
        xs, ys = matches
        if len(xs) == 0:
            return
        # xs is ascending (vectorized expansion order); drop whole
        # positions over the cap (StoreMatchingPositions semantics)
        if cap:
            ux, starts_u, cnts = np.unique(
                xs, return_index=True, return_counts=True
            )
            bad = cnts > cap
            if bad.any():
                keep = np.ones(len(xs), bool)
                for s, c in zip(starts_u[bad], cnts[bad]):
                    keep[s : s + c] = False
                xs, ys = xs[keep], ys[keep]
        for x, y in zip(xs.tolist(), ys.tolist()):
            frags.append(_Frag(x, y, length, word))

    pl_t = min(len(t), prefix_len)
    sl_t = min(len(t) - pl_t, prefix_len)
    pl_q = min(len(q), prefix_len)
    sl_q = min(len(q) - pl_q, prefix_len)
    add(_kmer_match_positions(q[:pl_q], t[:pl_t], small), small)
    if sl_q > 0 and sl_t > 0:
        add(
            _kmer_match_positions(
                q[len(q) - sl_q :], t[len(t) - sl_t :], small,
                q_off=len(q) - sl_q, t_off=len(t) - sl_t,
            ),
            small,
        )
    add(_kmer_match_positions(q, t, word), word)
    frags.sort(key=lambda f: (f.x, f.y))
    out = []
    for f in frags:
        if out and out[-1].x == f.x and out[-1].y == f.y:
            continue
        out.append(f)
    return out


def sdp_interval_align(
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    *,
    word: int = 11,
    sdp_ins: int = 5,
    sdp_del: int = 10,
    match: int = -5,
    mismatch: int = 6,
    n_score: int = 0,
    ins: int = 5,
    dele: int = 5,
    indel_rate: float = 0.9,      # params.indelRate * 3 (Blasr.cpp:1716)
    prefix_len: int = 50,
    recurse: int = 2,             # params.recurse (MappingParameters.h:329)
    no_recurse_under: int = 1000,  # params.recurseOver (:330)
    cap: int = 0,
    affine: bool = True,          # params.affineAlign (defaults TRUE,
    affine_open: int = 50,        # MappingParameters.h:338-340) — the
    affine_extend: int = 0,       # stats-score gap-run semantics
    _align_type: str = "local",
) -> tuple[int, list]:
    """Reference-faithful SDPAlign (Local, detailed): fragment chain ->
    blocks -> detailed gap alignment (global SW under noRecurseUnder cells,
    recursive SDP above) -> stats-replay score. Returns (score, blocks in
    input coordinates); (0, []) when no fragment chains (SDPAlign.h:277).

    This is the score RemoveLowQualityAlignments' -maxScore truncation
    gates on (Blasr.cpp:2618) — the -bestn secondary admission semantics.
    """
    q = np.asarray(q_codes, np.uint8)
    t = np.asarray(t_codes, np.uint8)
    frags = _gather_fragments(q, t, word, prefix_len, cap)
    if not frags:
        return 0, []
    if _align_type == "local":
        chain = _sdp_chain_local(frags, word, sdp_ins, sdp_del, match)
    else:
        chain = _sdp_chain_global(frags, word, sdp_ins, sdp_del, match)
    if not chain:
        return 0, []
    blocks = _chain_to_blocks(frags, chain, indel_rate)
    if not blocks:
        return 0, []

    full: list = []
    if _align_type == "global" and blocks[0][0] > 0 and blocks[0][1] > 0:
        # front global alignment of the pre-chain region (SDPAlign.h:
        # 416-478): dense SW only when recursion is exhausted AND the
        # region is small; recursive SDP otherwise; nothing when recursion
        # is exhausted on a large region — the reference's exact branch
        fq = q[: blocks[0][0]]
        ft = t[: blocks[0][1]]
        if recurse == 0 and len(fq) * len(ft) < no_recurse_under:
            full.extend(
                _sw_global(fq, ft, match, mismatch, n_score, ins, dele)
            )
        elif recurse != 0:
            _, b2 = sdp_interval_align(
                fq, ft,
                word=max(word - 4, 5), sdp_ins=sdp_ins, sdp_del=sdp_del,
                match=match, mismatch=mismatch, n_score=n_score,
                ins=ins, dele=dele, indel_rate=indel_rate,
                prefix_len=prefix_len, recurse=recurse - 1,
                no_recurse_under=no_recurse_under, cap=cap,
                _align_type="global",
            )
            full.extend(b2)
    for b in range(len(blocks) - 1):
        full.append(blocks[b])
        q0 = blocks[b][0] + blocks[b][2]
        t0 = blocks[b][1] + blocks[b][2]
        ql = blocks[b + 1][0] - q0
        tl = blocks[b + 1][1] - t0
        if ql > 0 and tl > 0:
            if ql * tl < no_recurse_under:
                gb = _sw_global(
                    q[q0 : q0 + ql], t[t0 : t0 + tl],
                    match, mismatch, n_score, ins, dele,
                )
            elif recurse != 0:
                _, gb = sdp_interval_align(
                    q[q0 : q0 + ql], t[t0 : t0 + tl],
                    word=max(word - 4, 5), sdp_ins=sdp_ins, sdp_del=sdp_del,
                    match=match, mismatch=mismatch, n_score=n_score,
                    ins=ins, dele=dele, indel_rate=indel_rate,
                    prefix_len=0, recurse=recurse - 1,
                    no_recurse_under=no_recurse_under, cap=cap,
                    _align_type="global",
                )
            else:
                gb = []
            for blk in gb:
                full.append([blk[0] + q0, blk[1] + t0, blk[2]])
    full.append(blocks[-1])
    score = _blocks_stats_score(
        full, q, t, match=match, mismatch=mismatch, n_score=n_score,
        ins=ins, dele=dele, affine=affine, affine_open=affine_open,
        affine_extend=affine_extend,
    )
    return score, full


def _sdp_chain_global(frags, k, sdp_ins, sdp_del, match):
    """Global variant of the sweep (chains always extend; start cost pays
    the full corner deletion, SparseDynamicProgramming.h:210-214; answer =
    longest chain). Only reached through gap recursion."""
    import bisect

    if not frags:
        return []
    INF = 1 << 60
    frags.sort(key=lambda f: (f.x, f.y))
    for i, f in enumerate(frags):
        f.index = i
    by_y = sorted(frags, key=lambda f: (f.y, f.x))
    for i in range(1, len(by_y)):
        p, c = by_y[i - 1], by_y[i]
        if p.x <= c.x < p.x + p.length and p.y < c.y:
            c.above = p.index
    sweep_keys, sweep_vals = [], []
    col_keys, col_vals = [], []
    max_len, max_idx = 0, -1
    f_sweep = f_trail = 0
    n = len(frags)
    row0 = frags[0].x
    rows_hi = max(f.x for f in frags) + k + 1
    for row in range(row0, rows_hi + 1):
        start_f = f_sweep
        while f_sweep < n and frags[f_sweep].x == row:
            cur = frags[f_sweep]
            cp = cl = ca = INF
            found = False
            j = bisect.bisect_left(col_keys, cur.y) - 1
            if j >= 0:
                pf = frags[col_vals[j]]
                cp = (
                    pf.cost
                    + int(np.sqrt(abs((cur.x + cur.y) - (pf.x + pf.y))))
                    - k
                )
                cp_prev = col_vals[j]
                found = True
            j = bisect.bisect_left(sweep_keys, (cur.y - cur.x, cur.x)) - 1
            if j >= 0:
                pf = sweep_vals[j]
                drift = (cur.x - cur.y) - (pf.x - pf.y)
                pen = drift * sdp_ins if drift > 0 else -drift * sdp_del
                cl = pf.cost + min((k - (cur.y - pf.y)) * match, 0) + pen
                cl_prev = pf.index
                found = True
            if cur.above >= 0:
                pf = frags[cur.above]
                drift = (cur.x - cur.y) - (pf.x - pf.y)
                pen = drift * sdp_ins if drift > 0 else -drift * sdp_del
                ca = pf.cost + (k - (cur.y - pf.y)) * match + pen
                found = True
            mc = min(cp, cl, ca)
            if found:
                cur.cost = mc - cur.weight
                if mc == cp:
                    cur.chain_prev = cp_prev
                elif mc == cl:
                    cur.chain_prev = cl_prev
                else:
                    cur.chain_prev = cur.above
                cur.chain_len = frags[cur.chain_prev].chain_len + 1
            else:
                cur.chain_prev = -1
                cur.cost = (cur.x + cur.y) * sdp_del + k * match - cur.weight
                cur.chain_len = 1
            if cur.chain_len > max_len:
                max_len, max_idx = cur.chain_len, cur.index
            f_sweep += 1
        for fi in range(start_f, f_sweep):
            key = (frags[fi].y - frags[fi].x, frags[fi].x)
            j = bisect.bisect_left(sweep_keys, key)
            if j < len(sweep_keys) and sweep_keys[j] == key:
                sweep_vals[j] = frags[fi]
            else:
                sweep_keys.insert(j, key)
                sweep_vals.insert(j, frags[fi])
        if row >= k + 1:
            trail_row = row - k - 1
            while f_trail < n and frags[f_trail].x < trail_row:
                f_trail += 1
            while f_trail < n and frags[f_trail].x == trail_row:
                tf = frags[f_trail]
                j = bisect.bisect_left(col_keys, tf.y)
                member = j < len(col_keys) and col_keys[j] == tf.y
                store = (not member) or frags[col_vals[j]].cost < tf.cost
                if store:
                    if member:
                        col_vals[j] = tf.index
                    else:
                        col_keys.insert(j, tf.y)
                        col_vals.insert(j, tf.index)
                    jj = j + 1
                    while (
                        jj < len(col_keys)
                        and frags[col_vals[jj]].cost > tf.cost
                    ):
                        del col_keys[jj]
                        del col_vals[jj]
                key = (tf.y - tf.x, tf.x)
                j = bisect.bisect_left(sweep_keys, key)
                if j < len(sweep_keys) and sweep_keys[j] == key:
                    del sweep_keys[j]
                    del sweep_vals[j]
                f_trail += 1
    if max_idx < 0:
        return []
    chain = []
    i = max_idx
    while i != -1:
        chain.append(i)
        i = frags[i].chain_prev
    chain.reverse()
    return chain


def _blocks_stats_score(
    blocks, q, t, *, match, mismatch, n_score, ins, dele,
    affine: bool = True, affine_open: int = 50, affine_extend: int = 0,
) -> int:
    """ComputeAlignmentStats score over a block list (AlignmentUtils.h:
    466-533 rendering + the string ComputeAlignmentScore :61-124):
    per-column scores inside blocks; between blocks the COMMON part of
    the (qgap, tgap) pair renders as aligned columns over the LAST common
    bases, the remainder as indel columns. With ``affine`` (blasrmc's
    params.affineAlign defaults TRUE, MappingParameters.h:338), each
    contiguous gap-column RUN costs min(len * linear-of-last-column,
    affineOpen + len * affineExtend) — the remainder columns of one gap
    pair are adjacent, so they form ONE run; this is what lets the
    reference score a 300-base unsupported gap at 50 instead of 1500 and
    is the admission-score semantics at RemoveLowQualityAlignments."""
    score = 0
    for bq, bt, bl in blocks:
        qc = q[bq : bq + bl].astype(np.int16)
        tc = t[bt : bt + bl].astype(np.int16)
        anyn = (qc >= 4) | (tc >= 4)
        score += int(
            np.where(
                anyn, n_score, np.where(qc == tc, match, mismatch)
            ).sum()
        )
    for b in range(len(blocks) - 1):
        q0 = blocks[b][0] + blocks[b][2]
        t0 = blocks[b][1] + blocks[b][2]
        qgap = blocks[b + 1][0] - q0
        tgap = blocks[b + 1][1] - t0
        common = min(qgap, tgap)
        q_rem = qgap - common
        t_rem = tgap - common
        run = q_rem + t_rem
        if run > 0:
            if affine:
                # render order: q-remainder (ins cols) then t-remainder
                # (del cols) — one contiguous run; the affine branch rates
                # the WHOLE run at the LAST column's linear cost
                # (AlignmentUtils.h:86-100, a reference quirk kept as-is)
                linear = run * (dele if t_rem > 0 else ins)
                score += min(linear, affine_open + run * affine_extend)
            else:
                score += q_rem * ins + t_rem * dele
        if common > 0:
            qc = q[blocks[b + 1][0] - common : blocks[b + 1][0]].astype(np.int16)
            tc = t[blocks[b + 1][1] - common : blocks[b + 1][1]].astype(np.int16)
            anyn = (qc >= 4) | (tc >= 4)
            score += int(
                np.where(
                    anyn, n_score, np.where(qc == tc, match, mismatch)
                ).sum()
            )
    return score


def stats_from_blocks(blocks, q, t) -> tuple[int, int, int, int]:
    """(n_match, n_mismatch, n_ins, n_del) under the same rendering as
    _blocks_stats_score."""
    nm = nx = ni = nd = 0
    for b, (bq, bt, bl) in enumerate(blocks):
        if b > 0:
            q0 = blocks[b - 1][0] + blocks[b - 1][2]
            t0 = blocks[b - 1][1] + blocks[b - 1][2]
            qgap = bq - q0
            tgap = bt - t0
            common = min(qgap, tgap)
            ni += qgap - common
            nd += tgap - common
            if common > 0:
                qc = q[bq - common : bq].astype(np.int16)
                tc = t[bt - common : bt].astype(np.int16)
                eq = (qc == tc) & (qc < 4) & (tc < 4)
                nm += int(eq.sum())
                nx += common - int(eq.sum())
        qc = q[bq : bq + bl].astype(np.int16)
        tc = t[bt : bt + bl].astype(np.int16)
        eq = (qc == tc) & (qc < 4) & (tc < 4)
        nm += int(eq.sum())
        nx += bl - int(eq.sum())
    return nm, nx, ni, nd


def reference_anchor_list(
    q_codes: np.ndarray,
    genome: np.ndarray,
    sa: np.ndarray,        # suffix array (lexicographic order)
    sa_kmers: np.ndarray,  # ascending packed k-mers per SA row
    k: int,
    *,
    min_match: int = 14,
    trim: int | None = None,
    max_ext: int = 256,
    max_range: int = 10_000,
    max_anchors_per_position: int = 1000,
    length_deficit: int = 5,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's anchor list for one read orientation: per position
    the SA hits achieving the position's MAXIMAL match length
    (MapBySuffixArray.h:100-212 LCP narrowing + unique-match heuristics —
    a unique k-match that cannot extend backs off below minMatch and
    yields nothing), then RemoveOverlappingAnchors
    (FindMaxInterval.h:279-312, called Blasr.cpp:2381): an anchor
    diagonal-encompassed by an anchor at the previous target position is
    dropped, leaving ~one anchor per maximal run. Returns (q, t, len)
    arrays — the list SumAnchors clusters over.

    The maximal-match DOMINANCE plus the encompass removal are what keep
    repeat-copy windows sparse (their SumAnchors fall under minInterval,
    so the reference never forms candidate intervals there), while
    fixed-k anchoring covers the same windows densely.

    ``length_deficit``: blasrmc run with a sawriter-built ``.sa`` (13-base
    lookup table, SAWriter.cpp default) reports every anchor 5 bases
    SHORT: MapReadToGenome receives params.lookupTableLength = 8 as the
    base prefix length while StoreLCPBounds starts its bounds list at the
    file's 13-mer lookup level, so matchLength = 8 + searchLen - 1
    undercounts by 13 - 8 (verified: anchors at q777/824/884 of the
    golden corpus read sim/1050 report 20/15/18 with -sa vs their true
    25/20/23 without). Anchors whose deficit length falls below minMatch
    vanish entirely — a large part of the reference's anchor sparsity on
    ~15-18-base repeat matches. The golden protocol maps with a
    precomputed .sa, so the deficit defaults on; pass 0 to model an
    in-memory (prefix-8) index run."""
    from blasr_tpu_torch.core.encode import pack_kmers

    q = np.asarray(q_codes, np.uint8)
    n = len(q)
    if trim is None:
        trim = min_match + 1
    keys, kvalid = pack_kmers(q, k)
    G = len(genome)
    end_p = max(0, n - trim)
    lo_all = np.searchsorted(sa_kmers, keys[:end_p], side="left")
    hi_all = np.searchsorted(sa_kmers, keys[:end_p], side="right")
    counts = hi_all - lo_all
    pos_ok = kvalid[:end_p] & (counts > 0) & (counts <= max_range)
    valid_p = np.flatnonzero(pos_ok)
    if len(valid_p) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    # flatten all hits, grouped by position (vectorized — the python
    # per-position loop cost ~100 ms/position on repeat-heavy reads)
    hit_p = np.repeat(valid_p, counts[valid_p]).astype(np.int64)
    hit_sa = np.concatenate(
        [np.arange(lo_all[p], hi_all[p]) for p in valid_p]
    )
    hit_t = sa[hit_sa].astype(np.int64)
    H = len(hit_t)
    # extension past the k-mer for every hit at once, alive-set compaction
    ext = np.zeros(H, np.int64)
    idx = np.arange(H)
    step = 0
    qi = hit_p + k
    ti = hit_t + k
    while len(idx) and step < max_ext:
        pi = qi[idx] + step
        gi = ti[idx] + step
        ok = (pi < n) & (gi < G)
        eq = np.zeros(len(idx), bool)
        eq[ok] = (q[pi[ok]] == genome[gi[ok]]) & (q[pi[ok]] < 4)
        ext[idx[eq]] += 1
        idx = idx[eq]
        step += 1
    # per-position maximal-match narrowing: segment max over hit groups
    bounds = np.flatnonzero(np.diff(hit_p, prepend=-1))
    seg_max = np.maximum.reduceat(ext, bounds)
    pmax = np.repeat(seg_max, np.diff(np.append(bounds, H)))
    sel = ext == pmax
    n_sel_seg = np.add.reduceat(sel.astype(np.int64), bounds)
    n_sel = np.repeat(n_sel_seg, np.diff(np.append(bounds, H)))
    length = k + pmax - length_deficit
    keep_h = sel & (length >= min_match) & (
        n_sel <= max_anchors_per_position
    ) & ~((n_sel == 1) & (pmax == 0))
    # (unique match ending at an error backs off one step — the widened
    # interval's length k-1 falls below minMatch)
    aqv = hit_p[keep_h]
    atv = hit_t[keep_h]
    alv = length[keep_h]
    if len(aqv) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    # RemoveOverlappingAnchors: drop an anchor encompassed in BOTH
    # coordinates by an anchor at the previous target position (the
    # diagonal-run sparsifier)
    amap = {}
    for i in range(len(aqv)):
        amap.setdefault(int(atv[i]), []).append(i)
    keep = np.ones(len(aqv), bool)
    for i in range(len(aqv)):
        prev = amap.get(int(atv[i]) - 1)
        if not prev:
            continue
        for j in prev:
            if (
                aqv[j] < aqv[i]
                and alv[j] + aqv[j] >= alv[i] + aqv[i]
                and alv[j] + atv[j] >= alv[i] + atv[i]
            ):
                keep[i] = False
                break
    return aqv[keep], atv[keep], alv[keep]


def sum_anchors_window(
    at: np.ndarray, al: np.ndarray, w_lo: int, w_hi: int
) -> int:
    """SumAnchors over a genomic window (FindMaxInterval.h:314-321) — the
    cluster-admission currency gated > minInterval."""
    m = (at >= w_lo) & (at < w_hi)
    return int(al[m].sum())


def blocks_to_ops(blocks) -> np.ndarray:
    """Render a block list to OP_M/OP_I/OP_D columns (start->end), using
    the same between-block gap rendering as _blocks_stats_score."""
    ops: list = []
    for b, (bq, bt, bl) in enumerate(blocks):
        if b > 0:
            q0 = blocks[b - 1][0] + blocks[b - 1][2]
            t0 = blocks[b - 1][1] + blocks[b - 1][2]
            qgap = bq - q0
            tgap = bt - t0
            common = min(qgap, tgap)
            ops.extend([OP_I] * (qgap - common))
            ops.extend([OP_D] * (tgap - common))
            ops.extend([OP_M] * common)
        ops.extend([OP_M] * bl)
    return np.asarray(ops, np.uint8)
