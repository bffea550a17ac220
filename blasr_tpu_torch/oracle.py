"""Gold-standard exhaustive alignment oracle (L8).

Role of reference ``gold_standard/ExhaustiveAlign.cpp`` (exhalign): compute
brute-force optimal local affine alignments to score mapper output against.
Pure numpy, O(L*T) per pair — deliberately simple and obviously correct;
also the unit-test oracle for the banded device kernels.

The port's copy of ``blasr_tpu/oracle.py``, whole.
"""

from __future__ import annotations

import numpy as np

from blasr_tpu_torch.ops.banded_align import AlignScores

BIG = 10**9


def local_affine_score(q: np.ndarray, t: np.ndarray, sc: AlignScores) -> int:
    """Unbanded local min-score affine DP (identical cell semantics to the
    device kernel; see ops/banded_align.py recurrence)."""
    L, T = len(q), len(t)
    H = np.zeros((L + 1, T + 1), np.int64)
    E = np.full((L + 1, T + 1), BIG, np.int64)
    F = np.full((L + 1, T + 1), BIG, np.int64)
    best = 0
    for i in range(1, L + 1):
        qc = q[i - 1]
        for j in range(1, T + 1):
            E[i][j] = min(E[i][j - 1], H[i][j - 1] + sc.affine_open) + sc.affine_extend
            F[i][j] = min(F[i - 1][j], H[i - 1][j] + sc.affine_open) + sc.affine_extend
            tc = t[j - 1]
            if qc == tc and qc < 4:
                sub = sc.match
            elif qc >= 4 or tc >= 4:
                sub = sc.n_score
            else:
                sub = sc.mismatch
            h = min(
                H[i - 1][j - 1] + sub,
                H[i - 1][j] + sc.insertion,
                H[i][j - 1] + sc.deletion,
                E[i][j],
                F[i][j],
                0,
            )
            H[i][j] = h
            if h < best:
                best = h
    return int(best)
