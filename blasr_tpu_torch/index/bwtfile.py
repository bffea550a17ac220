"""Reference-format ``.bwt`` file interop (read side); the port's copy of
``blasr_tpu/index/bwtfile.py``.

Layout (reference ``common/datastructures/bwt/BWT.h:70-80`` Write +
``PackedDNASequence.h:178-184``): a 3-bit-packed BWT string (10 nucs per
uint32 word, low bits first, codes A0 C1 G2 T3 N4 $5 per NucConversion.h
ThreeBit), the cumulative character-count array ``charCount[7]``, the $
row position, a debug flag, then Occ/Pos acceleration tables (skipped —
this reader rebuilds its own index).

The BWT string is ``T`` of ``ReadAllSequencesIntoOne`` (contigs joined by
single 'N' spacers plus one trailing 'N', FASTAReader.h:126-131) with row
0 prepended as ``T[N-1]`` (BWT.h:278-281). Inversion: LF(i) =
charCount[bwt[i]] + rank_excl(bwt[i], i), walked from row 0, yields T
back-to-front. The orbit is materialised with O(log n) pointer-doubling
gathers, not n serial steps.
"""

from __future__ import annotations

import struct

import numpy as np

NUCS_PER_WORD = 10
DOLLAR = 5


def read_ref_bwt(path: str) -> np.ndarray:
    """Reference .bwt -> the concatenated genome (codes, N spacers kept)."""
    with open(path, "rb") as f:
        raw = f.read()
    arrlen, length = struct.unpack_from("<II", raw, 0)
    words = np.frombuffer(raw, "<u4", count=arrlen, offset=8)
    off = 8 + 4 * arrlen
    C = np.asarray(struct.unpack_from("<7I", raw, off), np.int64)
    idx = np.arange(length, dtype=np.int64)
    bwt = (
        (words[idx // NUCS_PER_WORD] >> (3 * (idx % NUCS_PER_WORD))) & 7
    ).astype(np.int64)
    n = length
    # vectorized LF permutation: C[c] + occurrence index (rank among all
    # rows in row order == exclusive rank at each row)
    lf = np.zeros(n, np.int64)
    for c in range(5):
        m = bwt == c
        lf[m] = C[c] + np.arange(int(m.sum()), dtype=np.int64)
    # the $ row closes the cycle back to the prepended row 0
    lf[bwt == DOLLAR] = 0
    # orbit of row 0 by pointer doubling
    S = np.zeros(1, np.int64)
    P = lf
    while len(S) < n:
        S = np.concatenate([S, P[S]])
        if len(S) < n:
            P = P[P]
    S = S[:n]
    chars = bwt[S]          # step k collects T[N-1-k] (k=0 at row 0)
    # drop the single $ (the final step hits the $ row) and reverse
    return chars[chars != DOLLAR][::-1].astype(np.uint8)


def ref_bwt_genome_matches(genome: np.ndarray, fasta_contigs) -> bool:
    """Does a .bwt-reconstructed genome equal these contigs under the
    reference's join convention (contig + 'N' for each contig)?"""
    parts = []
    for _, codes in fasta_contigs:
        parts.append(np.asarray(codes, np.uint8))
        parts.append(np.full(1, 4, np.uint8))
    ref = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return np.array_equal(genome, ref)
