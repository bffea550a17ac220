"""FASTA reads with uniform substitution, insertion and deletion rates.

``simulate_reads`` is a copy of the port's ``sim.simulate_reads``: with
``lengths`` left out, the same seed gives the same reads. The traffic
fixes the lengths from its own ``length_seed`` (the same distribution:
``0.65 mean + Exp(0.35 mean)``, clipped to [min_len, 3 mean]), so every
run seed maps the same set of sizes at other loci, strands and errors.

Traffic parameters: ``mean_len``, ``min_len``, ``sub_rate``, ``ins_rate``,
``del_rate``, ``length_seed``.
"""

from __future__ import annotations

import numpy as np

from . import fixed_lengths, permute, revcomp_codes


def simulate_reads(genome, n_reads, mean_len=1000, min_len=200, seed=1,
                   sub_rate=0.01, ins_rate=0.08, del_rate=0.04, lengths=None,
                   tag="sim"):
    """Noisy reads of ``genome``; returns (name, codes, None) triples."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    reads = []
    for i in range(n_reads):
        if lengths is None:
            length = int(np.clip(rng.exponential(mean_len * 0.35) + mean_len * 0.65,
                                 min_len, mean_len * 3))
        else:
            length = int(lengths[i])
        length = min(length, G - 1)
        start = int(rng.integers(0, G - length))
        end = start + length
        seg = genome[start:end]
        r = rng.random(length)
        keep = r >= del_rate
        seg = seg[keep]
        r2 = rng.random(len(seg))
        subs = r2 < sub_rate
        seg = np.where(subs, (seg + rng.integers(1, 4, len(seg))) % 4, seg).astype(np.uint8)
        n_ins = rng.binomial(len(seg), ins_rate)
        if n_ins:
            pos = np.sort(rng.integers(0, len(seg) + 1, n_ins))
            ins = rng.integers(0, 4, n_ins).astype(np.uint8)
            seg = np.insert(seg, pos, ins)
        strand = int(rng.integers(0, 2))
        if strand:
            seg = revcomp_codes(seg)
        reads.append((f"{tag}/{i}|ref|{start}|{end}|{strand}", seg, None))
    return reads


def draw_lengths(rng, n, mean_len, min_len):
    return np.clip(rng.exponential(mean_len * 0.35, n) + mean_len * 0.65,
                   min_len, mean_len * 3).astype(np.int64)


def generate(genome, traffic: dict, n_reads: int, seed: int):
    mean_len = int(traffic["mean_len"])
    min_len = int(traffic["min_len"])
    lengths = permute(fixed_lengths(
        traffic, n_reads, lambda rng, n: draw_lengths(rng, n, mean_len, min_len)), seed)
    return simulate_reads(genome, n_reads, mean_len=mean_len, min_len=min_len, seed=seed,
                          sub_rate=float(traffic["sub_rate"]),
                          ins_rate=float(traffic["ins_rate"]),
                          del_rate=float(traffic["del_rate"]), lengths=lengths,
                          tag=traffic.get("tag", "sim"))
