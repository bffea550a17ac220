"""Concatenated-genome coordinate database (L1/L2); the port's copy of
``blasr_tpu/io/seqdb.py``.

Role of reference ``common/datastructures/metagenome/SequenceIndexDatabase.h``
(:19-117 — seqStartPos[], SearchForIndex binary search, MakeSAMSQString):
maps positions in the single concatenated genome array back to
(contig, offset), vectorized with numpy searchsorted.

Positions are int64 throughout, removing the reference's 4 Gb genome limit
(SAWriter.cpp:176-181).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from blasr_tpu_torch.io.fasta import md5_of_codes, read_fasta


@dataclasses.dataclass
class SeqDB:
    names: list[str]
    starts: np.ndarray   # int64 [C+1]: contig c spans [starts[c], starts[c+1])
    md5s: list[str]

    @property
    def num_contigs(self) -> int:
        return len(self.names)

    @property
    def total_length(self) -> int:
        return int(self.starts[-1])

    def lengths(self) -> np.ndarray:
        return np.diff(self.starts)

    def contig_of(self, pos: np.ndarray) -> np.ndarray:
        """Global position(s) -> contig index (vectorized)."""
        return np.searchsorted(self.starts, np.asarray(pos), side="right") - 1

    def sam_sq_lines(self) -> list[str]:
        out = []
        lens = self.lengths()
        for i, name in enumerate(self.names):
            out.append(f"@SQ\tSN:{name}\tLN:{int(lens[i])}\tM5:{self.md5s[i]}")
        return out


def load_genome(path: str) -> tuple[np.ndarray, SeqDB]:
    """Read a (multi-)FASTA genome into one concatenated code array + SeqDB.

    Equivalent of reference FASTAReader::ReadAllSequencesIntoOne
    (used at Blasr.cpp:4316-4338), minus the 'N' spacer — contig-boundary
    crossing is instead excluded by the index's per-position validity mask.
    """
    records = read_fasta(path)
    if not records:
        raise ValueError(f"{path}: no sequences")
    names = [n for n, _ in records]
    starts = np.zeros(len(records) + 1, dtype=np.int64)
    for i, (_, codes) in enumerate(records):
        starts[i + 1] = starts[i] + len(codes)
    genome = np.concatenate([c for _, c in records]).astype(np.uint8)
    md5s = [md5_of_codes(c) for _, c in records]
    return genome, SeqDB(names, starts, md5s)
