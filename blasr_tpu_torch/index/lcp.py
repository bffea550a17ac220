"""LCP tables for suffix-array binary search (L2 satellite).

Role of reference ``LCPTable`` (common/datastructures/suffixarray/
LCPTable.h:9-120): the Manber–Myers llcp/rlcp acceleration — for every
midpoint of the SA binary-search tree, the longest common prefix of the
midpoint suffix with the interval's left/right boundary suffix, letting
the search skip re-comparing matched prefixes. The reference fills the
tables with per-node character loops; here everything is vectorized:

- adjacent LCPs by batched offset probing (all still-matching pairs
  compare their next CHUNK characters at once — O(n * maxlcp / chunk)
  vector ops, and random DNA keeps maxlcp ~ log4 n);
- llcp/rlcp for ALL search-tree nodes from the adjacent array with a
  sparse-table range-minimum (LCP(SA[i], SA[j]) = min adjacent LCPs in
  (i, j]), one binary-tree level at a time.

The port's copy of ``blasr_tpu/index/lcp.py``, whole.
"""

from __future__ import annotations

import numpy as np


def adjacent_lcp(genome: np.ndarray, sa: np.ndarray, chunk: int = 16) -> np.ndarray:
    """lcp[i] = LCP(suffix sa[i], suffix sa[i+1]); length n-1."""
    g = np.asarray(genome, np.uint8)
    n = len(sa)
    G = len(g)
    if n < 2:
        return np.zeros(0, np.int32)
    a = np.asarray(sa[:-1], np.int64)
    b = np.asarray(sa[1:], np.int64)
    lcp = np.zeros(n - 1, np.int64)
    active = np.arange(n - 1)
    while len(active):
        aa = a[active] + lcp[active]
        bb = b[active] + lcp[active]
        # compare the next `chunk` characters of every active pair
        lim = np.minimum(G - aa, G - bb)
        take = np.minimum(lim, chunk).astype(np.int64)
        eq_run = np.zeros(len(active), np.int64)
        run = np.ones(len(active), bool)
        for k in range(chunk):
            in_range = k < take
            ga = g[np.minimum(aa + k, G - 1)]
            gb = g[np.minimum(bb + k, G - 1)]
            run = run & in_range & (ga == gb)
            eq_run += run
        lcp[active] += eq_run
        # continue only pairs that matched a full in-range chunk
        active = active[run & (take == chunk)]
    return lcp.astype(np.int32)


def build_lr_lcp(lcp_adj: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(llcp, rlcp) for every midpoint of the binary search over n = len+1
    suffixes (LCPTable.h llcp/rlcp contract):

        llcp[m] = LCP(suffix at l(m), suffix at m)
        rlcp[m] = LCP(suffix at m, suffix at r(m))

    where (l, r) is the unique search interval whose midpoint is m.
    Computed level-by-level with a sparse-table RMQ over the adjacent-LCP
    array (LCP(i, j) = min lcp_adj[i..j-1]).
    """
    m = len(lcp_adj)
    n = m + 1
    if n < 3:
        return np.zeros(n, np.int32), np.zeros(n, np.int32)
    # sparse table over lcp_adj
    levels = [np.asarray(lcp_adj, np.int32)]
    k = 1
    while (1 << k) <= m:
        prev = levels[-1]
        half = 1 << (k - 1)
        levels.append(np.minimum(prev[: m - (1 << k) + 1], prev[half : m - half + 1]))
        k += 1

    def rmq(i: np.ndarray, j: np.ndarray) -> np.ndarray:
        """min lcp_adj[i..j) vectorized; i < j."""
        ln = j - i
        out = np.empty(len(i), np.int32)
        lg = (np.floor(np.log2(np.maximum(ln, 1)))).astype(np.int64)
        for lev in range(len(levels)):
            sel = lg == lev
            if not sel.any():
                continue
            ii = i[sel]
            jj = j[sel]
            w = 1 << lev
            out[sel] = np.minimum(levels[lev][ii], levels[lev][jj - w])
        return out

    llcp = np.zeros(n, np.int32)
    rlcp = np.zeros(n, np.int32)
    # walk the static binary-search tree level by level
    frontier = [(np.asarray([0]), np.asarray([n - 1]))]
    while frontier:
        nl, nr = frontier.pop()
        keep = nr - nl > 1
        nl, nr = nl[keep], nr[keep]
        if len(nl) == 0:
            continue
        mid = (nl + nr) // 2
        llcp[mid] = rmq(nl, mid)
        rlcp[mid] = rmq(mid, nr)
        frontier.append((nl, mid))
        frontier.append((mid, nr))
    return llcp, rlcp
