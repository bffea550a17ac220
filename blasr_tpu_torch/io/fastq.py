"""FASTQ reading/writing (L1); the port's copy of ``blasr_tpu/io/fastq.py``.

Role of reference ``common/FASTQReader.h`` (4-line records, PHRED+33 quals).
"""

from __future__ import annotations

import numpy as np

from blasr_tpu_torch.core.encode import codes_to_seq, seq_to_codes


def read_fastq(path: str) -> list[tuple[str, np.ndarray, np.ndarray]]:
    """Parse FASTQ -> list of (name, codes uint8[n], qual uint8[n] phred)."""
    records = []
    opener = __import__("gzip").open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        lines = f.read().split(b"\n")
    i = 0
    n = len(lines)
    while i < n:
        title = lines[i].strip()
        if not title:
            i += 1
            continue
        if not title.startswith(b"@"):
            raise ValueError(f"{path}: malformed FASTQ title at line {i + 1}")
        if i + 3 >= n:
            raise ValueError(
                f"{path}: truncated FASTQ record at line {i + 1}"
            )
        name = title[1:].split()[0].decode("ascii")
        seq = lines[i + 1].strip()
        qual_line = lines[i + 3].strip()
        codes = seq_to_codes(seq)
        qual = np.frombuffer(qual_line, dtype=np.uint8).astype(np.uint8) - 33
        if len(qual) != len(codes):
            raise ValueError(f"{path}: seq/qual length mismatch for read {name}")
        records.append((name, codes, qual))
        i += 4
    return records


def write_fastq(path: str, records: list[tuple[str, np.ndarray, np.ndarray]]) -> None:
    with open(path, "w") as f:
        for name, codes, qual in records:
            q = (np.asarray(qual, dtype=np.uint8) + 33).tobytes().decode("ascii")
            f.write(f"@{name}\n{codes_to_seq(codes)}\n+\n{q}\n")
