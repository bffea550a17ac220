"""Homopolymer-condensed sequences (L0, cmpseq role).

Role of reference ``common/cmpseq/CompressedSequence.h`` (332 LoC:
4-bit homopolymer-condensed genome, lossy "condensed" representation) +
``ReverseCompressIndex.h`` (coordinate map back to the original) and the
``sequtils/Condense.cpp`` tool: collapse each homopolymer run to one base
and keep enough bookkeeping to translate condensed coordinates back.

The port's copy of ``blasr_tpu/core/condense.py``, whole.
"""

from __future__ import annotations

import numpy as np


def condense(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse homopolymer runs.

    Returns (condensed, run_lengths, orig_start):
      condensed[i]    first base of run i
      run_lengths[i]  length of run i in the original sequence
      orig_start[i]   original coordinate of the run start — the
                      ReverseCompressIndex: condensed pos -> original pos
    """
    codes = np.asarray(codes, np.uint8)
    if codes.size == 0:
        z = np.zeros(0, np.int64)
        return codes.copy(), z, z
    change = np.empty(len(codes), bool)
    change[0] = True
    change[1:] = codes[1:] != codes[:-1]
    starts = np.flatnonzero(change).astype(np.int64)
    lengths = np.diff(np.append(starts, len(codes)))
    return codes[starts].copy(), lengths, starts


def expand(condensed: np.ndarray, run_lengths: np.ndarray) -> np.ndarray:
    """Inverse of condense (lossless with the run lengths)."""
    return np.repeat(np.asarray(condensed, np.uint8), run_lengths)


def condensed_to_original(orig_start: np.ndarray, pos) -> np.ndarray:
    """Map condensed coordinate(s) to original coordinates."""
    return orig_start[np.asarray(pos)]


def original_to_condensed(orig_start: np.ndarray, pos) -> np.ndarray:
    """Map original coordinate(s) to the containing run's condensed index."""
    return np.searchsorted(orig_start, np.asarray(pos), side="right") - 1
