"""Nucleotide encoding (L0); the port's copy of ``blasr_tpu/core/encode.py``.

Role of reference ``common/NucConversion.h`` + ``common/DNASequence.h``
(ASCII<->2/3-bit tables, MakeRC), re-designed for batched array processing:
sequences are dense ``uint8`` code arrays (A,C,G,T,N = 0..4) and every
transform is vectorized numpy.

The 2-bit packing of k-mers into int32/int64 words is the device index key:
a k-mer's packed value is its lexicographic rank, so an array of packed
k-mers in suffix-array order is sorted and supports binary search
(cf. reference SuffixArray prefix lookup table, SuffixArray.h:193).
"""

from __future__ import annotations

import numpy as np

CODE_A, CODE_C, CODE_G, CODE_T, CODE_N = 0, 1, 2, 3, 4
SIGMA = 5  # alphabet size incl. N

_ASCII_TO_CODE = np.full(256, CODE_N, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ASCII_TO_CODE[_b] = _i
    _ASCII_TO_CODE[_b + 32] = _i  # lowercase

_CODE_TO_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


def seq_to_codes(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes (A,C,G,T=0..3, anything else=4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return _ASCII_TO_CODE[arr]


def codes_to_seq(codes: np.ndarray) -> str:
    """uint8 codes -> ASCII string."""
    return _CODE_TO_ASCII[np.minimum(codes, CODE_N)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement on code arrays (N maps to N).

    Complement of c in {0..3} is 3-c; 4 (N) stays 4.
    """
    comp = np.where(codes < 4, 3 - codes, codes)
    return comp[::-1].copy()


def pack_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack every k-window of ``codes`` into an integer key.

    Returns ``(keys, valid)`` both of length ``len(codes)``:
      * ``keys[t]`` = big-endian 2-bit packing of ``codes[t:t+k]`` (N treated
        as A for packing; windows running past the end are padded with A,
        which preserves suffix-array sortedness because A is the minimal
        symbol).
      * ``valid[t]`` = True iff the window lies fully inside the array and
        contains no N.

    dtype is int32 when 2k <= 31 else int64.
    """
    n = len(codes)
    dtype = np.int32 if 2 * k <= 31 else np.int64
    ext = np.zeros(n + k, dtype=np.int64)
    ext[:n] = codes & 3
    has_n = np.zeros(n + k, dtype=bool)
    has_n[:n] = codes >= 4
    acc = np.zeros(n, dtype=np.int64)
    bad = np.zeros(n, dtype=bool)
    for j in range(k):
        acc = (acc << 2) | ext[j : j + n]
        bad |= has_n[j : j + n]
    valid = ~bad
    valid[n - k + 1 :] = False
    return acc.astype(dtype), valid
