"""Full-QV forward-probability alignment (L4 satellite).

Role of reference ``FullQVAlign`` (common/algorithms/alignment/
FullQVAlign.h:9-126): the probability of an alignment between two reads
under their quality-value error model, computed with the Forward algorithm
(sum over all alignments, not the Viterbi best) — an experimental
read-vs-read comparator (only #included by Blasr.cpp, never called in the
mapping flow).

A redesign of the reference's doubly-sequential cell loop: per
query row, the in-row dependency
``P[t] = A_t + c_t * P[t-1]`` is LINEAR in probability space, so a whole
row solves in closed form:

    P[t] = sum_k<=t A_k * prod_{j=k+1..t} c_j
    logP = lc_t + logaddexp-scan(logA_k - lc_k),   lc = cumsum(log c)

turning the row into two vectorized scans (numpy ``logaddexp.accumulate``)
— no per-cell Python; host numpy in both packages.

Model per the reference: match emission (FullQVAlign.h:56-62)
    q==t: (1-ps_q)(1-ps_t);  else: (ps_q/3)(1-ps_t) + (1-ps_q)(ps_t/3)
insertion-in-query (:71-101 else-branch): (pi_q + pd_t)
insertion-in-target (:106-121 else-branch): (pi_t + pd_q)
with ps/pi/pd the substitution/insertion/deletion error probabilities from
the sq/iq/dq tracks (phred): p = 10^(-qv/10). The reference's
preBaseDeletionQV branch needs the HDF5-only pb track (dead in this fork's
inputs, SURVEY fork note) and is not modeled; dt/st tags only gate that
branch, so the else-branch is the live contract.

The port's copy of ``blasr_tpu/ops/fullqv.py``, whole.
"""

from __future__ import annotations

import numpy as np


def _phred_prob(track: np.ndarray | None, n: int, default_qv: float) -> np.ndarray:
    if track is None:
        return np.full(n, 10.0 ** (-default_qv / 10.0))
    return 10.0 ** (-np.asarray(track, np.float64) / 10.0)


def _tracks(read, n):
    qvs = getattr(read, "qvs", None) or {}
    qual = getattr(read, "qual", None)
    ps = _phred_prob(qvs.get("sq", qual), n, 15.0)
    pi = _phred_prob(qvs.get("iq", qual), n, 12.0)
    pd = _phred_prob(qvs.get("dq"), n, 12.0)
    return ps, pi, pd


def fullqv_align(query, target) -> float:
    """log-probability of aligning ``query`` to ``target`` (both Read-like:
    .codes plus optional .qual/.qvs tracks). Forward algorithm over the
    full DP matrix."""
    q = np.asarray(query.codes, np.int16)
    t = np.asarray(target.codes, np.int16)
    Lq, Lt = len(q), len(t)
    if Lq == 0 or Lt == 0:
        return 0.0
    ps_q, pi_q, pd_q = _tracks(query, Lq)
    ps_t, pi_t, pd_t = _tracks(target, Lt)

    # row 0: all-insertions-in-target boundary (FullQVAlign.h:25-28)
    prev = np.concatenate([[0.0], np.cumsum(np.log(pi_t))])  # (Lt+1,)
    for i in range(Lq):
        match_p = np.where(
            t == q[i],
            (1.0 - ps_q[i]) * (1.0 - ps_t),
            (ps_q[i] / 3.0) * (1.0 - ps_t) + (1.0 - ps_q[i]) * (ps_t / 3.0),
        )  # (Lt,)
        ins_p = pi_q[i] + pd_t  # insertion in query at row i vs target pos
        # A_t (prob mass reaching cell (i+1, t+1) from the previous row):
        #   match from prev[t] + query-insertion from prev[t+1]
        logA = np.logaddexp(
            prev[:-1] + np.log(match_p),
            prev[1:] + np.log(ins_p),
        )  # (Lt,)
        # boundary cell (i+1, 0): all insertions in query
        p0 = prev[0] + np.log(pi_q[i])
        # in-row linear recursion P[t] = A_t + c_t * P[t-1],
        # c_t = pi_t + pd_q[i]  (insertion in target / deletion in query)
        c = np.log(pi_t + pd_q[i])
        lc = np.cumsum(c)                       # lc[k-1] = sum_{j<=k} log c_j
        x = np.concatenate([[p0], logA - lc])   # x[k] = logA_k - lc_k
        acc = np.logaddexp.accumulate(x)
        row = np.empty(Lt + 1)
        row[0] = p0
        row[1:] = lc + acc[1:]                  # logP[t] = lc_t + scan_t
        prev = row
    return float(prev[-1])
