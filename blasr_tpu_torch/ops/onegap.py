"""One-gap (structural-variant) alignment: whole query vs left+right target
windows separated by one long free gap.

Role of reference ``OneGapAlign`` (common/algorithms/alignment/
OneGapAlignment.h:18): align the ENTIRE query to ``leftTarget`` ++
<long gap of known length ``distance``> ++ ``rightTarget``, where the long
gap is a free affine deletion — open and extension cost nothing, the close
must consume a query base as a (mis)match (OneGapAlignment.h:200-217).
Used by the `oneGapAlign` satellite CLI (alignment/OneGapAlign.cpp) to place
a deletion SV breakpoint optimally.

A redesign instead of the reference's fused two-layer matrix pair:
the free gap makes the problem separable —

    best = min_i  [ Fmin(i) + cross(i) ]

where ``Fmin(i) = min_j HL[i][j]`` is the best global alignment of query
prefix ``i`` against ANY left-target prefix (the reference's affine layer
value at the boundary column, OneGapAlignment.h:143-152 propagates exactly
this running row-min), and the right side is a second DP seeded by Fmin.
Two plain row-sweep DPs replace the interleaved four-matrix walk; each is
the same vectorized numpy kernel used elsewhere in ops/sdp.py.

Deviation noted: the reference's first right-target column computes its
insertion move as the bare insertion cost without the accumulated cell
above (OneGapAlignment.h:173 drops the ``scoreMat[i][targetCol+1] +``
term — an apparent bug); we use the standard recurrence.

Scores are min-is-better, matching the rest of the framework.

The port's copy of ``blasr_tpu/ops/onegap.py``, whole.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from blasr_tpu_torch.ops.banded_align import AlignScores
from blasr_tpu_torch.pipeline.traceback import OP_D, OP_I, OP_M, AlignmentPath

BIG = np.int32(1 << 29)


def _sub_row(qc: int, t: np.ndarray, sc: AlignScores) -> np.ndarray:
    """Substitution score of query code ``qc`` vs every target code."""
    if sc.matrix is not None:
        mat = np.asarray(sc.matrix, np.int32).reshape(5, 5)
        return mat[min(qc, 4), np.minimum(t, 4)]
    return np.where(
        (t == qc) & (qc < 4), sc.match,
        np.where((t >= 4) | (qc >= 4), sc.n_score, sc.mismatch),
    ).astype(np.int32)


def _global_dp(q: np.ndarray, t: np.ndarray, sc: AlignScores) -> np.ndarray:
    """Full (|q|+1, |t|+1) global min-score DP matrix, linear gap costs."""
    qn, tn = len(q), len(t)
    H = np.empty((qn + 1, tn + 1), np.int32)
    H[0, :] = np.arange(tn + 1, dtype=np.int32) * sc.deletion
    H[:, 0] = np.arange(qn + 1, dtype=np.int32) * sc.insertion
    for i in range(1, qn + 1):
        sub = _sub_row(int(q[i - 1]), t, sc)
        best = np.minimum(H[i - 1, :-1] + sub, H[i - 1, 1:] + sc.insertion)
        acc = H[i, 0]
        row = H[i]
        for j in range(1, tn + 1):
            acc = min(best[j - 1], acc + sc.deletion)
            row[j] = acc
    return H


@dataclass
class OneGapResult:
    """Alignment of the full query across one long target gap.

    ``path`` coordinates are over the CONCATENATED target
    left ++ gap(distance) ++ right, i.e. t in [0, len(left)+distance+
    len(right)); the long gap appears as one OP_D run of ``gap_len`` at
    target position ``gap_t_start``. ``split_q`` is the query row where the
    gap closes (0 when the optimal path never uses the long gap).
    """

    score: int
    path: AlignmentPath
    gap_t_start: int
    gap_len: int
    split_q: int


def onegap_align(
    q: np.ndarray,
    left: np.ndarray,
    right: np.ndarray,
    distance: int,
    scores: AlignScores = AlignScores(),
) -> OneGapResult:
    """Align all of ``q`` to left ++ gap(distance) ++ right (min score)."""
    q = np.asarray(q, np.uint8)
    left = np.asarray(left, np.uint8)
    right = np.asarray(right, np.uint8)
    qn, ln, rn = len(q), len(left), len(right)
    sc = scores

    HL = _global_dp(q, left, sc)
    fmin = HL.min(axis=1)  # best left score per query prefix (affine layer)
    jstar = HL.argmin(axis=1)

    # right-side DP; column j = right prefix j (j>=1), row 0 = the
    # deletion strip crossing both regions without the long gap
    HR = np.empty((qn + 1, rn + 1), np.int32)
    ARROW = np.zeros((qn + 1, rn + 1), np.uint8)  # 0 diag 1 up 2 left 3 close
    HR[0, :] = (np.arange(rn + 1, dtype=np.int32) + ln) * sc.deletion
    ARROW[0, :] = 2
    HR[:, 0] = BIG  # no "right prefix 0" column mid-row (boundary is affine-only)
    HR[0, 0] = ln * sc.deletion
    for i in range(1, qn + 1):
        sub = _sub_row(int(q[i - 1]), right, sc)
        close = fmin[i - 1] + sub  # long-gap close consumes q[i-1] as (mis)match
        diag = np.concatenate(([BIG], HR[i - 1, 1:-1])) + sub if rn else sub[:0]
        up = HR[i - 1, 1:] + sc.insertion
        best = np.minimum(np.minimum(diag, up), close)
        row = HR[i]
        arow = ARROW[i]
        acc = BIG
        for j in range(1, rn + 1):
            v = best[j - 1]
            d = acc + sc.deletion if j >= 2 else BIG
            cell = min(v, d)
            row[j] = cell
            # reference move preference: diag, up, left, gap-close
            # (OneGapAlignment.h:205-218)
            if cell == diag[j - 1]:
                arow[j] = 0
            elif cell == up[j - 1]:
                arow[j] = 1
            elif cell == d:
                arow[j] = 2
            else:
                arow[j] = 3
            acc = cell

    if rn == 0:
        # degenerate: gap runs to the end of the target
        i = int(np.argmin(fmin + (qn - np.arange(qn + 1)) * sc.insertion))
        score = int(fmin[i] + (qn - i) * sc.insertion)
        jl = int(jstar[i])
        ops_left = _trace_global(HL, q, left, i, jl, sc)
        gap = ln - jl + distance
        ops = np.concatenate([
            ops_left,
            np.full(gap, OP_D, np.uint8),
            np.full(qn - i, OP_I, np.uint8),
        ])
        return _finish(q, left, right, distance, ops, score, jl + 0, gap, i)

    score = int(HR[qn, rn])
    # walk the right matrix
    i, j = qn, rn
    ops_right_rev: list[int] = []
    closed_at = None
    while True:
        if i == 0:
            # row-0 deletion strip: crossed without the long gap
            ops = np.concatenate([
                np.full(ln + distance + j, OP_D, np.uint8),
                np.asarray(ops_right_rev[::-1], np.uint8),
            ])
            return _finish(q, left, right, distance, ops, score, 0, 0, 0)
        a = ARROW[i, j]
        if a == 0:
            ops_right_rev.append(OP_M)
            i -= 1
            j -= 1
        elif a == 1:
            ops_right_rev.append(OP_I)
            i -= 1
        elif a == 2:
            ops_right_rev.append(OP_D)
            j -= 1
        else:  # close: gap spans left[jl:] + distance + right[:j-1]
            ops_right_rev.append(OP_M)
            i -= 1
            j -= 1
            closed_at = (i, j)
            break
    si, sj = closed_at
    jl = int(jstar[si])
    gap = (ln - jl) + distance + sj
    ops_left = _trace_global(HL, q, left, si, jl, sc)
    ops = np.concatenate([
        ops_left,
        np.full(gap, OP_D, np.uint8),
        np.asarray(ops_right_rev[::-1], np.uint8),
    ])
    return _finish(q, left, right, distance, ops, score, jl, gap, si)


def _trace_global(
    H: np.ndarray, q: np.ndarray, t: np.ndarray, i: int, j: int,
    sc: AlignScores,
) -> np.ndarray:
    """Trace the plain global DP back from (i, j) to (0, 0)."""
    ops_rev: list[int] = []
    while i > 0 or j > 0:
        if i > 0 and j > 0:
            sub = int(_sub_row(int(q[i - 1]), t[j - 1 : j], sc)[0])
            if H[i, j] == H[i - 1, j - 1] + sub:
                ops_rev.append(OP_M)
                i -= 1
                j -= 1
                continue
        if i > 0 and H[i, j] == H[i - 1, j] + sc.insertion:
            ops_rev.append(OP_I)
            i -= 1
            continue
        ops_rev.append(OP_D)
        j -= 1
    return np.asarray(ops_rev[::-1], np.uint8)


def _finish(
    q: np.ndarray, left: np.ndarray, right: np.ndarray, distance: int,
    ops: np.ndarray, score: int, gap_t_start: int, gap_len: int, split_q: int,
) -> OneGapResult:
    full_t = np.concatenate([
        left, np.full(distance, 4, np.uint8), right
    ]).astype(np.uint8)
    qstep = (ops != OP_D).astype(np.int64)
    tstep = (ops != OP_I).astype(np.int64)
    qpos = np.cumsum(qstep) - qstep
    tpos = np.cumsum(tstep) - tstep
    ism = ops == OP_M
    nm = 0
    if ism.any():
        qc = q[qpos[ism]]
        tc = full_t[tpos[ism]]
        nm = int(np.count_nonzero((qc == tc) & (qc < 4)))
    nmop = int(np.count_nonzero(ism))
    path = AlignmentPath(
        q_start=0, q_end=len(q),
        t_start=0, t_end=int(tstep.sum()),
        ops=ops, score=score,
        n_match=nm, n_mismatch=nmop - nm,
        n_ins=int(np.count_nonzero(ops == OP_I)),
        n_del=int(np.count_nonzero(ops == OP_D)),
    )
    return OneGapResult(score, path, gap_t_start, gap_len, split_q)
