"""Traffic generators, found by name: ``generators/<name>.py`` holds
``generate(genome, traffic, n_reads, seed) -> list[(name, codes, qual)]``.

Each read's name carries its truth, ``<tag>/<i>|ref|<start>|<end>|<strand>``
(the simulators' title convention), so the true locus can be scored
without the program. Nothing here imports the program.
"""

from __future__ import annotations

import importlib
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


def load(name: str):
    """The generator module ``generators/<name>.py``."""
    if not os.path.isfile(os.path.join(HERE, name + ".py")):
        raise FileNotFoundError(f"no traffic generator {name!r} in {HERE}")
    return importlib.import_module(f"{__name__}.{name}")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of 2-bit codes (4, N, stays 4)."""
    comp = np.where(codes < 4, 3 - codes, codes)
    return comp[::-1].astype(np.uint8)


def parse_truth(name: str) -> tuple[int, int, int]:
    """(start, end, strand) from a simulated read's name."""
    parts = name.split("|")
    return int(parts[2]), int(parts[3]), int(parts[4])


def codes_to_bytes(codes: np.ndarray) -> bytes:
    return _ASCII[np.asarray(codes, dtype=np.intp)].tobytes()


def write_reads(path: str, reads, fastq: bool) -> None:
    """Write ``reads`` as FASTA (one line a sequence) or FASTQ, through a
    file beside ``path`` that replaces it at the end."""
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        for name, codes, qual in reads:
            if fastq:
                q = (np.asarray(qual, dtype=np.uint8) + 33).tobytes()
                f.write(b"@%s\n%s\n+\n%s\n" % (name.encode(), codes_to_bytes(codes), q))
            else:
                f.write(b">%s\n%s\n" % (name.encode(), codes_to_bytes(codes)))
    os.replace(tmp, path)


def write_genome(path: str, name: str, codes: np.ndarray, width: int = 70) -> None:
    """Write one contig as FASTA, ``width`` bases a line."""
    tmp = path + ".part"
    seq = codes_to_bytes(codes)
    with open(tmp, "wb") as f:
        f.write(b">%s\n" % name.encode())
        for i in range(0, len(seq), width):
            f.write(seq[i : i + width] + b"\n")
    os.replace(tmp, path)


def fixed_lengths(traffic: dict, n_reads: int, draw) -> np.ndarray:
    """The pool's read lengths: drawn once from the traffic's own
    ``length_seed`` by ``draw(rng, n)``, so every run seed maps the same
    set of sizes (in another order, ``permute``)."""
    rng = np.random.default_rng(int(traffic["length_seed"]))
    return np.asarray(draw(rng, n_reads), dtype=np.int64)


def permute(lengths: np.ndarray, seed: int) -> np.ndarray:
    return lengths[np.random.default_rng([seed, 1]).permutation(len(lengths))]
