"""The plain reference: BLASR's alignment score, worked out again.

Scores are minimised (SMRT defaults: match -5, mismatch +6, against N 0,
insertion and deletion 5 a base, or an affine gap of open 50 and extend
0), and a phred value scales the mismatch and insertion cost of its
query base: ``max(1, (cost * clip(q, 4, 30) + 7) // 15)`` (phred 15
leaves a cost as it is; BLASR's QualityValueScoreFunction). The
configuration states these numbers; they reach this module as a dict.

``span_optimum`` is the best score of any alignment of a query span
against a genome span, both ends fixed: a Gotoh recurrence over the
anti-diagonals of the whole span (no band), in int32 PyTorch, a batch of
spans at a time. A reported local alignment is optimal on its own span
exactly when its score equals this. ``cigar_score`` is the score of one
given alignment: each diagonal base by its pair, each gap run by the
cheaper of its bases' costs and the affine gap.

Plain PyTorch and NumPy only: nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

INF = 1 << 29


def qv_costs(base: int, qual) -> np.ndarray:
    """Per-base cost of ``base`` scaled by the phred values ``qual``."""
    q = np.clip(np.asarray(qual, dtype=np.int64), 4, 30)
    return np.maximum(1, (base * q + 7) // 15)


def base_costs(scoring: dict, n: int, qual) -> tuple[np.ndarray, np.ndarray]:
    """(mismatch, insertion) cost of each of ``n`` query bases."""
    if qual is None or not scoring.get("qv_scaled", True):
        return (np.full(n, scoring["mismatch"], np.int64),
                np.full(n, scoring["insertion"], np.int64))
    return qv_costs(scoring["mismatch"], qual), qv_costs(scoring["insertion"], qual)


def span_optimum(items, scoring: dict, device="cpu", block: int = 256) -> list[int]:
    """Best global score of each (query codes, target codes, query phred or
    None) in ``items``; blocks of ``block`` spans, the longest first."""
    order = sorted(range(len(items)), key=lambda i: -(len(items[i][0]) + len(items[i][1])))
    out = [0] * len(items)
    for b in range(0, len(order), block):
        idx = order[b : b + block]
        got = _span_block([items[i] for i in idx], scoring, torch.device(device))
        for i, s in zip(idx, got):
            out[i] = s
    return out


def _span_block(items, scoring: dict, dev) -> list[int]:
    i32 = torch.int32
    n = len(items)
    m = np.array([len(q) for q, _, _ in items])
    t_len = np.array([len(t) for _, t, _ in items])
    M, N = int(m.max()), int(t_len.max())
    Q = np.full((n, M + 1), 4, np.int64)         # Q[:, i] = query base i - 1
    X = np.zeros((n, M + 1), np.int64)           # its mismatch cost
    IC = np.zeros((n, M + 1), np.int64)          # its insertion cost
    TT = np.full((n, N + 1), 4, np.int64)        # TT[:, j] = target base j - 1
    for k, (q, t, qual) in enumerate(items):
        Q[k, 1 : len(q) + 1] = q
        x, ic = base_costs(scoring, len(q), qual)
        X[k, 1 : len(q) + 1] = x
        IC[k, 1 : len(q) + 1] = ic
        TT[k, 1 : len(t) + 1] = t
    Q, X, IC, TT = (torch.from_numpy(a).to(dev, i32) for a in (Q, X, IC, TT))
    mt = torch.from_numpy(m).to(dev, torch.int64)
    nt = torch.from_numpy(t_len).to(dev, torch.int64)
    match, n_sc = scoring["match"], scoring["n_score"]
    dele = scoring["deletion"]
    go, ge = scoring["affine_open"], scoring["affine_extend"]

    ii = torch.arange(M + 1, device=dev)[None, :]                  # query prefix i
    inf = torch.full((n, M + 1), INF, dtype=i32, device=dev)
    H2 = inf.clone()                                               # diagonal d - 2
    H1 = inf.clone()                                               # diagonal d - 1
    E1 = inf.clone()
    F1 = inf.clone()
    H1[:, 0] = 0                                                   # cell (0, 0)
    res = torch.full((n,), INF, dtype=i32, device=dev)
    end_d = mt + nt
    done0 = end_d == 0
    res = torch.where(done0, 0, res)

    def shift(x, fill=INF):        # value at i - 1
        return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)

    for d in range(1, int(end_d.max()) + 1):
        j = d - ii                                                 # target prefix
        inside = (j >= 0) & (j <= nt[:, None]) & (ii <= mt[:, None])
        tj = torch.gather(TT, 1, torch.clamp(j, 0, N).expand(n, -1))
        eq = (Q == tj) & (Q < 4)
        anyn = (Q >= 4) | (tj >= 4)
        sub = torch.where(eq, match, torch.where(anyn, n_sc, X))
        h_diag = shift(H2) + sub
        h_up = shift(H1) + IC                                      # insertion of base i
        h_left = H1 + dele
        E = torch.minimum(E1, H1 + go) + ge                        # from (i, j - 1)
        F = torch.minimum(shift(F1), shift(H1) + go) + ge          # from (i - 1, j)
        first = ii >= 1
        h_diag = torch.where(first & (j >= 1), h_diag, INF)
        h_up = torch.where(first, h_up, INF)
        F = torch.where(first, F, INF)
        h_left = torch.where(j >= 1, h_left, INF)
        E = torch.where(j >= 1, E, INF)
        H = torch.minimum(torch.minimum(h_diag, h_up), torch.minimum(h_left, torch.minimum(E, F)))
        H = torch.clamp(torch.where(inside, H, INF), max=INF)
        E = torch.clamp(torch.where(inside, E, INF), max=INF)
        F = torch.clamp(torch.where(inside, F, INF), max=INF)
        at_end = end_d == d
        if bool(at_end.any()):
            val = torch.gather(H, 1, mt[:, None]).squeeze(1)
            res = torch.where(at_end, val, res)
        H2, H1, E1, F1 = H1, H, E, F
    return [int(v) for v in res.cpu().tolist()]


def cigar_score(cigar_runs, query, target, qual, scoring: dict) -> int | None:
    """Score of one alignment: ``cigar_runs`` [(op, length)] over the
    query's aligned bases (clips removed) and the target span; None when
    the runs do not consume both exactly."""
    x, ic = base_costs(scoring, len(query), qual)
    go, ge = scoring["affine_open"], scoring["affine_extend"]
    qi = ti = 0
    total = 0
    for op, ln in cigar_runs:
        if op in "M=X":
            if qi + ln > len(query) or ti + ln > len(target):
                return None
            q = np.asarray(query[qi : qi + ln], np.int64)
            t = np.asarray(target[ti : ti + ln], np.int64)
            eq = (q == t) & (q < 4)
            anyn = (q >= 4) | (t >= 4)
            total += int(np.where(eq, scoring["match"],
                                  np.where(anyn, scoring["n_score"], x[qi : qi + ln])).sum())
            qi += ln
            ti += ln
        elif op == "I":
            if qi + ln > len(query):
                return None
            total += min(int(ic[qi : qi + ln].sum()), go + ge * ln)
            qi += ln
        elif op == "D":
            if ti + ln > len(target):
                return None
            total += min(scoring["deletion"] * ln, go + ge * ln)
            ti += ln
        else:
            return None
    if qi != len(query) or ti != len(target):
        return None
    return total
