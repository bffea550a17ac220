"""FASTQ reads from a context-conditioned error model (the alchemy recipe).

The port's ``sim.simulate_reads_alchemy`` walks each read base by base in
Python. This is the same recipe over whole reads at once: a length from
the model's histogram, a uniform start, per base a deletion, a
substitution or a match by the rates of its context (previous base,
base), then a geometric number of insertions, each a copy of the base
just emitted with probability ``ins_cognate`` and a random base
otherwise; phred values around ``mean_qual`` (sd 4, clipped to 4-60) at
matches, ``mean_qual - 8`` at substitutions and ``mean_qual - 10`` at
insertions (both at least 4); then a random strand. One departure: the
context's previous base is the genome's, where the loop takes the last
base it emitted, which differs after a deletion or a substitution; the
rates that follow differ by a few percent of themselves (see the tests).

Traffic parameters: ``lengths`` and ``length_probs`` (the histogram),
``sub``, ``ins``, ``dele`` (16 rates each, context ``(prev << 2) | cur``),
``mean_qual``, ``ins_cognate``, ``length_seed``.
"""

from __future__ import annotations

import numpy as np

from . import fixed_lengths, permute, revcomp_codes


def draw_lengths(rng, n, lengths, probs, genome_len):
    p = np.asarray(probs, float)
    got = rng.choice(np.asarray(lengths, np.int64), size=n, p=p / p.sum())
    return np.clip(got, 100, genome_len - 1)


def simulate_reads(genome, model: dict, read_lengths, seed: int, tag: str = "alchemy"):
    """One read per entry of ``read_lengths``; (name, codes, qual) triples."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    sub = np.asarray(model["sub"], float)
    ins = np.asarray(model["ins"], float)
    dele = np.asarray(model["dele"], float)
    mean_q = float(model["mean_qual"])
    cognate = float(model["ins_cognate"])
    q_sub = max(4, int(mean_q) - 8)
    q_ins = max(4, int(mean_q) - 10)
    reads = []
    for i, length in enumerate(read_lengths):
        length = int(length)
        start = int(rng.integers(0, G - length))
        seg = genome[start : start + length].astype(np.int64)
        prev = np.concatenate(([0], seg[:-1]))
        ctx = (prev << 2) | (seg & 3)
        r = rng.random(length)
        gone = r < dele[ctx]
        is_sub = ~gone & (r < dele[ctx] + sub[ctx])
        base = np.where(is_sub, (seg + rng.integers(1, 4, length)) % 4, seg)
        qual = np.where(is_sub, q_sub,
                        np.clip(rng.normal(mean_q, 4, length), 4, 60).astype(np.int64))
        n_ins = rng.geometric(1.0 - ins[ctx]) - 1
        kept = ~gone
        base, qual, n_ins = base[kept], qual[kept], n_ins[kept]
        counts = 1 + n_ins
        total = int(counts.sum())
        first = np.cumsum(counts) - counts
        slot = np.arange(total) - np.repeat(first, counts)
        codes = np.repeat(base, counts)
        q = np.repeat(qual, counts)
        at_ins = slot > 0
        n_new = int(at_ins.sum())
        copy = rng.random(n_new) < cognate
        codes[at_ins] = np.where(copy, codes[at_ins], rng.integers(0, 4, n_new))
        q[at_ins] = q_ins
        codes = codes.astype(np.uint8)
        q = q.astype(np.uint8)
        strand = int(rng.integers(0, 2))
        if strand:
            codes = revcomp_codes(codes)
            q = q[::-1].copy()
        reads.append((f"{tag}/{i}|ref|{start}|{start + length}|{strand}", codes, q))
    return reads


def generate(genome, traffic: dict, n_reads: int, seed: int):
    lengths = permute(fixed_lengths(
        traffic, n_reads,
        lambda rng, n: draw_lengths(rng, n, traffic["lengths"], traffic["length_probs"],
                                    len(genome))), seed)
    return simulate_reads(genome, traffic, lengths, seed, tag=traffic.get("tag", "alchemy"))
