"""FM-index construction (L2, host side); the port's copy of
``blasr_tpu/index/fm.py``, with ``fm_reconstruct``, which only the
bwtutils tools use.

Role of reference ``common/datastructures/bwt/BWT.h`` (:45 ``Bwt<>``,
Occ two-level tables at Occ.h:44, sampled-SA ``Pos`` at Pos.h:30, built
from the suffix array at BWT.h:301 ``InitializeFromSuffixArray``) and the
``sa2bwt`` tool (bwtutils/SuffixArrayToBWT.cpp).

The BWT string is stored as (NB, 128) uint8 rows so a rank query is one
row gather, a compare and a masked sum; Occ checkpoints are per-row
cumulative counts (one level: a 128-wide row is the minor bin). The sampled
SA uses a bit-packed row mask with popcount-rank (role of the reference's
PackedHash, PackedHash.h:305).

Alphabet: 0..3 = ACGT, 4 = N, 5 = sentinel '$' (smallest is the sentinel,
then A < C < G < T < N, matching the SA convention where the past-the-end
suffix sorts first). ``save``/``load`` use the JAX package's ``np.savez``
keys, so a bundle written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np

ROW = 128          # rank row width
SAMPLE_D = 8       # sampled-SA stride (reference Pos.h stride 8)
SENTINEL = 5


@dataclasses.dataclass
class FMIndex:
    bwt_rows: np.ndarray      # (NB, ROW) uint8, padded with SENTINEL+1 (=6)
    occ_bins: np.ndarray      # (NB, 6) int32: counts of char c in bwt[0:b*ROW)
    C: np.ndarray             # (7,) int64: C[c] = # chars < c in bwt (incl $)
    ssa_mask: np.ndarray      # (ceil(n/32),) uint32 bit b set = row sampled
    ssa_base: np.ndarray      # (ceil(n/32),) int32 popcount-rank prefix
    ssa_vals: np.ndarray      # (n_sampled,) int64 text positions
    n: int                    # = G + 1 (text + sentinel)

    @property
    def genome_length(self) -> int:
        return self.n - 1

    def save(self, path: str) -> None:
        np.savez(
            path,
            bwt_rows=self.bwt_rows,
            occ_bins=self.occ_bins,
            C=self.C,
            ssa_mask=self.ssa_mask,
            ssa_base=self.ssa_base,
            ssa_vals=self.ssa_vals,
            n=np.int64(self.n),
        )

    @staticmethod
    def load(path: str) -> "FMIndex":
        z = np.load(path)
        return FMIndex(
            z["bwt_rows"], z["occ_bins"], z["C"],
            z["ssa_mask"], z["ssa_base"], z["ssa_vals"], int(z["n"]),
        )


def build_fm_index(genome: np.ndarray, sa: np.ndarray) -> FMIndex:
    """Build the FM-index from the genome and its suffix array.

    The SA here follows the framework convention (no explicit sentinel row);
    the full rotation order is [G] + sa, i.e. the empty suffix first.
    """
    g = np.asarray(genome, dtype=np.uint8)
    G = int(len(g))
    n = G + 1

    # bwt[i] = T[sa$[i] - 1], with T[-1] = '$'
    sa_full = np.empty(n, dtype=np.int64)
    sa_full[0] = G
    sa_full[1:] = sa
    prev = sa_full - 1
    bwt = np.where(prev >= 0, g[np.clip(prev, 0, G - 1)], SENTINEL).astype(np.uint8)

    NB = -(-n // ROW)
    bwt_rows = np.full((NB, ROW), SENTINEL + 1, dtype=np.uint8)
    bwt_rows.reshape(-1)[:n] = bwt

    # per-row cumulative counts (exclusive)
    onehot = (bwt_rows[:, :, None] == np.arange(6)[None, None, :])
    row_counts = onehot.sum(axis=1).astype(np.int64)          # (NB, 6)
    occ_bins = np.vstack(
        [np.zeros((1, 6), np.int64), np.cumsum(row_counts, axis=0)[:-1]]
    ).astype(np.int32)

    counts = np.bincount(bwt, minlength=6).astype(np.int64)
    # C[c] counts the chars that SORT before c: $ sorts first, then codes
    # 0..4; C[6] == C[5] ($ contributes nothing beyond its initial offset)
    C = np.zeros(7, dtype=np.int64)
    C[0] = counts[SENTINEL]
    for c in range(1, 6):
        C[c] = C[c - 1] + counts[c - 1]
    C[6] = C[5]

    # sampled SA: rows whose text position is a multiple of SAMPLE_D
    sampled = (sa_full % SAMPLE_D) == 0
    n_words = -(-n // 32)
    ssa_mask = np.zeros(n_words, dtype=np.uint32)
    idx = np.flatnonzero(sampled)
    np.bitwise_or.at(ssa_mask, idx // 32, (1 << (idx % 32)).astype(np.uint32))
    csum = np.concatenate(
        [[0], np.cumsum(np.bitwise_count(ssa_mask).astype(np.int64))[:-1]]
    )
    ssa_base = csum.astype(np.int32)
    ssa_vals = sa_full[sampled].astype(np.int64)

    return FMIndex(bwt_rows, occ_bins, C, ssa_mask, ssa_base, ssa_vals, n)


# ---- host-side reference queries (the oracle for the device search) ----

def occ_host(fm: FMIndex, c: int, i: int) -> int:
    """# occurrences of char c in bwt[0:i); i == n clamps to the last row
    with a whole-row residual (padding value 6 never matches)."""
    b, r = divmod(i, ROW)
    if b >= fm.bwt_rows.shape[0]:
        b, r = fm.bwt_rows.shape[0] - 1, ROW
    return int(fm.occ_bins[b, c]) + int(np.sum(fm.bwt_rows[b, :r] == c))


def count_host(fm: FMIndex, pattern: np.ndarray) -> tuple[int, int]:
    """Backward-search interval [lo, hi) of rows prefixed by ``pattern``.

    Role of reference ``Bwt::Count`` (BWT.h:204-232).
    """
    lo, hi = 0, fm.n
    for c in pattern[::-1]:
        c = int(c)
        lo = int(fm.C[c]) + occ_host(fm, c, lo)
        hi = int(fm.C[c]) + occ_host(fm, c, hi)
        if lo >= hi:
            return lo, lo
    return lo, hi


def locate_host(fm: FMIndex, row: int) -> int:
    """Text position of the suffix at BWT row ``row`` via LF-walk to a
    sampled row (role of ``Bwt::Locate``, BWT.h:113-139)."""
    steps = 0
    while True:
        w, b = divmod(row, 32)
        if (fm.ssa_mask[w] >> b) & 1:
            rank = int(fm.ssa_base[w]) + int(
                bin(int(fm.ssa_mask[w]) & ((1 << b) - 1)).count("1")
            )
            return int(fm.ssa_vals[rank]) + steps
        c = int(fm.bwt_rows[row // ROW, row % ROW])
        if c == SENTINEL:
            # wrapped past the start of the text
            return steps - 1 if steps else fm.n - 1
        row = int(fm.C[c]) + occ_host(fm, c, row)
        steps += 1


def fm_reconstruct(fm: FMIndex) -> tuple[np.ndarray, np.ndarray]:
    """Invert the FM-index: recover (genome, full-rotation SA) from the BWT
    alone — the completeness property reference ``bwt2sa`` relies on
    (bwtutils/BwtToSuffixArray.cpp:24-27 calls ``Locate`` per row; here the
    whole LF orbit is materialised with O(log n) pointer-doubling gathers
    instead of n sequential walks).

    Returns ``(genome codes (G,), sa_full (n,) int64)`` where ``sa_full``
    includes the sentinel row (sa_full[0] == G) in this framework's
    $-first row order.
    """
    n = fm.n
    G = n - 1
    bwt = fm.bwt_rows.reshape(-1)[:n]
    # vectorized LF: LF[i] = C[bwt[i]] + rank_{bwt[i]}(i)
    lf = np.zeros(n, np.int64)
    for c in range(6):
        m = bwt == c
        base = 0 if c == SENTINEL else int(fm.C[c])
        lf[m] = base + np.arange(int(m.sum()), dtype=np.int64)
    # orbit of row 0 under LF: row_k = row of rotation (G - k) mod n
    S = np.zeros(1, np.int64)
    P = lf
    while len(S) < n:
        S = np.concatenate([S, P[S]])
        if len(S) < n:
            P = P[P]
    S = S[:n]
    sa_full = np.empty(n, np.int64)
    sa_full[S] = G - np.arange(n, dtype=np.int64)
    # text[p] = bwt[row of rotation p+1] = bwt[S[G-p-1]]
    genome = bwt[S[:G][::-1]].astype(np.uint8)
    return genome, sa_full
