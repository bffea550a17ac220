"""The bench corpora and operating point of the mapping path.

The same corpus and parameters as the repository's ``bench.py``: a 4.6 Mb
simulated genome (seed 7) and 2000 simulated PacBio-like reads of mean
length 1 kb (seed 11) under ``benchdata/``, a k=14 suffix-array index with
the direct 4^k tables, B=256, 4 candidates per strand and 2 DP windows per
read, every 4th read position seeded, 128 anchors per read-strand, the
W=32 band on every bucket up to 3328 bp, best_n 1, -m 4 output (no move
strings) and band escalation on. ``accuracy_true_locus`` is the fraction
of reads whose best record lies on the true strand within 100 bp of the
true start and end.

The FASTQ corpus (``ensure_fastq_corpus``) holds 2000 reads of 500-3000 bp
on the same genome from the alchemy simulator under the published PacBio
CLR error model (``sim.ErrorModel.published_clr``, seed 13): quality
values around phred 10, low at error sites, and the insertion bursts that
make the narrow band clip, so band escalation runs on the main path.

The contig corpus (``ensure_contig_corpus``, the reference measurement's
config 5, ``-alignContigs``) holds two contigs evolved from the bench
genome's 100,000-1,300,000 and 2,000,000-2,800,000 (2% substitutions,
0.5% insertions, 0.5% deletions; seeds 1 and 2). The long-read corpus
(``ensure_long_corpus``) holds 300 simulated reads of mean length 8 kb
(seed 17; 5-24 kb, named ``long/<i>|ref|...``), all above the bench's
``max_read_len``, so ``run_mapping`` maps them piecewise, then the first
100 reads of the FASTA corpus, which pass through whole.
"""

from __future__ import annotations

import os

from blasr_tpu_torch.params import MappingParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(REPO, "benchdata")
GENOME_FA = os.path.join(BENCH_DIR, "genome.fasta")
READS_FA = os.path.join(BENCH_DIR, "reads.fasta")
# config 5's contigs: (name, genome start, genome end, evolve_sequence seed)
CONTIGS = (("ctg1", 100_000, 1_300_000, 1), ("ctg2", 2_000_000, 2_800_000, 2))


def ensure_corpus(bench_dir: str = BENCH_DIR) -> tuple[str, str]:
    """Write the simulated genome and reads (once); returns their paths."""
    from blasr_tpu_torch.io.fasta import read_fasta, write_fasta
    from blasr_tpu_torch.sim import simulate_genome, simulate_reads

    genome_fa = os.path.join(bench_dir, "genome.fasta")
    reads_fa = os.path.join(bench_dir, "reads.fasta")
    os.makedirs(bench_dir, exist_ok=True)
    if not os.path.exists(genome_fa):
        write_fasta(genome_fa, [("ref", simulate_genome(4_600_000, seed=7))])
    if not os.path.exists(reads_fa):
        g = read_fasta(genome_fa)[0][1]
        reads, _ = simulate_reads(g, 2000, mean_len=1000, seed=11)
        write_fasta(reads_fa, [(r.name, r.codes) for r in reads])
    return genome_fa, reads_fa


def ensure_fastq_corpus(bench_dir: str = BENCH_DIR) -> str:
    """Write the CLR-model FASTQ corpus beside the bench genome (once);
    returns its path."""
    from blasr_tpu_torch.io.fasta import read_fasta
    from blasr_tpu_torch.io.fastq import write_fastq
    from blasr_tpu_torch.sim import ErrorModel, simulate_reads_alchemy

    genome_fa, _ = ensure_corpus(bench_dir)
    reads_fq = os.path.join(bench_dir, "reads_clr.fastq")
    if not os.path.exists(reads_fq):
        g = read_fasta(genome_fa)[0][1]
        reads, _ = simulate_reads_alchemy(g, ErrorModel.published_clr(), 2000, seed=13)
        write_fastq(reads_fq, [(r.name, r.codes, r.qual) for r in reads])
    return reads_fq


def ensure_contig_corpus(bench_dir: str = BENCH_DIR) -> str:
    """Write config 5's two evolved contigs beside the bench genome (once);
    returns their path."""
    from blasr_tpu_torch.io.fasta import read_fasta, write_fasta
    from blasr_tpu_torch.sim import evolve_sequence

    genome_fa, _ = ensure_corpus(bench_dir)
    path = os.path.join(bench_dir, "contigs.fasta")
    if not os.path.exists(path):
        g = read_fasta(genome_fa)[0][1]
        write_fasta(path, [(name, evolve_sequence(g[lo:hi], 0.02, 0.005, 0.005, seed=seed)[0])
                           for name, lo, hi, seed in CONTIGS])
    return path


def ensure_long_corpus(bench_dir: str = BENCH_DIR) -> str:
    """Write the long-read corpus beside the bench genome (once): 300
    simulated reads of mean 8 kb, then the first 100 bench reads; returns
    its path."""
    from blasr_tpu_torch.io.fasta import read_fasta, write_fasta
    from blasr_tpu_torch.sim import simulate_reads

    genome_fa, reads_fa = ensure_corpus(bench_dir)
    path = os.path.join(bench_dir, "reads_long.fasta")
    if not os.path.exists(path):
        g = read_fasta(genome_fa)[0][1]
        long_reads, _ = simulate_reads(g, 300, mean_len=8000, seed=17)
        write_fasta(path, [("long/" + r.name.split("/", 1)[1], r.codes) for r in long_reads]
                    + read_fasta(reads_fa)[:100])
    return path


def load_bench_index(genome_fa: str = GENOME_FA, k: int = 14):
    """The k=14 suffix-array index of the bench genome (cached beside it)."""
    from blasr_tpu_torch.index.artifacts import load_index

    return load_index(genome_fa, k=k)


def load_reads(reads_fa: str = READS_FA):
    from blasr_tpu_torch.io.batching import read_records

    return read_records(reads_fa)


def write_reads(path: str, reads) -> None:
    from blasr_tpu_torch.io.fasta import write_fasta

    write_fasta(path, [(r.name, r.codes) for r in reads])


def bench_params(**overrides) -> MappingParams:
    kw = dict(
        batch_size=256,
        max_read_len=3328,
        n_candidates=4,
        n_dp_candidates=2,
        anchor_stride=4,
        max_anchors_per_read=128,
        narrow_band=32,
        narrow_band_max=3328,
        best_n=1,
        emit_moves=False,
        direct_lut=True,
    )
    kw.update(overrides)
    return MappingParams(**kw)


def config3_params() -> MappingParams:
    """The bench operating point with two alignments per read and their
    move strings: the reference measurement's config 3 (``-bestn 2 -m 5``,
    ``scripts/bench_config34.py``)."""
    return bench_params(best_n=2, emit_moves=True)


def config4_params() -> MappingParams:
    """The reference measurement's config 4 (``-bwt -m 4``,
    ``scripts/bench_config34.py:89-96``): the bench operating point at
    B=64, best_n 1, no move strings, anchored through the FM index. B=64
    keeps the JAX package's batches, so a read has the same batch mates
    (its records depend on them)."""
    return bench_params(batch_size=64, best_n=1, emit_moves=False)


def config5_params() -> MappingParams:
    """The reference measurement's config 5 (``-alignContigs``,
    ``BASELINE.md:27``): the bench operating point with piecewise mapping,
    ``remove_contained`` and move strings on, as the CLI's preset sets
    them; run through ``pipeline/piecewise.run_mapping_piecewise``."""
    return bench_params(piecewise=True, remove_contained=True, emit_moves=True)


def k15_params() -> MappingParams:
    """The bench operating point with 15-base seeds: 2k = 30 > 28, so the
    suffix-array index takes bisection although ``direct_lut`` is set."""
    return bench_params(min_match_length=15)


def k18_params() -> MappingParams:
    """The bench operating point with 18-base seeds: the wide-key index
    (keys split into a top-30-bit and a 6-bit half)."""
    return bench_params(min_match_length=18)


def true_locus_windows(genome, reads, L: int, pad2: int = 128):
    """The DP inputs of simulated reads at their true loci, as the mapper
    places them: each read's forward-strand codes cut to ``L`` (N-padded),
    its quality values in the same orientation (phred 15 where it has none
    or past its end), and its genome window of ``T = L + 2 * pad2`` codes
    (5 outside the genome): (query (n, L) uint8, qlen (n,) int32, target
    (n, T) uint8, qual (n, L) uint8)."""
    import numpy as np

    from blasr_tpu_torch.core.encode import revcomp_codes
    from blasr_tpu_torch.sim import parse_truth

    n = len(reads)
    T = L + 2 * pad2
    Q = np.full((n, L), 4, np.uint8)
    Tg = np.full((n, T), 5, np.uint8)
    qual = np.full((n, L), 15, np.uint8)
    qlen = np.zeros(n, np.int32)
    G = len(genome)
    for i, r in enumerate(reads):
        start, _end, strand = parse_truth(r.name)
        codes = revcomp_codes(r.codes) if strand else r.codes
        m = min(len(codes), L)
        Q[i, :m] = codes[:m]
        qlen[i] = m
        if r.qual is not None:
            qual[i, :m] = (r.qual[::-1] if strand else r.qual)[:m]
        t0 = start - pad2
        lo, hi = max(t0, 0), min(t0 + T, G)
        Tg[i, lo - t0 : hi - t0] = genome[lo:hi]
    return Q, qlen, Tg, qual


def simulated_windows(genome, n: int, L: int, pad2: int = 128, seed: int = 0):
    """``n`` simulated reads of a length-``L`` bucket (mean length 0.7 L) at
    their true loci: (query (n, L) uint8, qlen (n,) int32, target (n, T)
    uint8), see ``true_locus_windows``."""
    from blasr_tpu_torch.sim import simulate_reads

    reads, _ = simulate_reads(genome, n, mean_len=int(L * 0.7), seed=seed)
    return true_locus_windows(genome, reads, L, pad2)[:3]


def accuracy_true_locus(records, reads) -> float:
    """Share of reads whose best record hits the simulated true locus."""
    from blasr_tpu_torch.sim import parse_truth

    best = {}
    for r in records:
        cur = best.get(r.qname)
        if cur is None or r.score < cur.score:
            best[r.qname] = r
    n_ok = 0
    for rd in reads:
        rec = best.get(rd.name)
        if rec is None:
            continue
        start, end, strand = parse_truth(rd.name)
        if (
            rec.tstrand == strand
            and abs(rec.tstart_fwd - start) < 100
            and abs(rec.tend_fwd - end) < 100
        ):
            n_ok += 1
    return n_ok / max(len(reads), 1)


def deviating_knots(I: int, L: int, T: int, W: int, pad2: int, num: int,
                    seed: int = 0, device=None):
    """Guided band knots (I, NK) for DP windows of one bucket: each item's
    band wanders off the shared drift line (``make_qoff_num(L, T, W, pad2,
    num)``) by a random walk whose excursions reach past the reference's
    clamp, through ``make_qoff_knots`` and ``clamp_knots_to_shared`` at
    ``guided_max_dev(W)``, as the mapper builds them."""
    import numpy as np
    import torch

    from blasr_tpu_torch.ops.banded_align import (
        KNOT_SPACING, clamp_knots_to_shared, guided_max_dev, make_qoff_knots,
        make_qoff_num, n_knots,
    )

    rng = np.random.default_rng(seed)
    S = L + T - 1
    NK = n_knots(S)
    shared = make_qoff_num(L, T, W, pad2, num)
    a = np.minimum(np.arange(NK) * KNOT_SPACING, S - 1)
    walk = np.cumsum(rng.integers(-6, 7, (I, NK)), axis=1).astype(np.float64)
    reach = rng.uniform(0.5, 1.5, (I, 1)) * guided_max_dev(W)
    walk *= reach / np.maximum(np.abs(walk).max(axis=1, keepdims=True), 1)
    v = shared.numpy()[a][None, :] + np.rint(walk).astype(np.int32)
    knots = make_qoff_knots(
        torch.from_numpy(np.broadcast_to(a, (I, NK)).astype(np.int32)),
        torch.from_numpy(v.astype(np.int32)), torch.ones((I, NK), dtype=torch.bool),
        S, L, W, diag=pad2, num=num,
    )
    knots = clamp_knots_to_shared(knots, shared, W, max_dev=guided_max_dev(W))
    return knots.to(device) if device is not None else knots


def span_gather_inputs(span: int, n_words: int = 600_064, items: int = 512,
                       seed: int = 0, device=None):
    """The shapes of the TPU span-gather microbenchmark
    (``scripts/micro_dma.py``): a source of ``n_words`` random int32 words
    and ``items`` starts in [0, n_words - span - 128); (src, starts)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.integers(0, 2**31 - 1, n_words).astype(np.int32))
    starts = torch.from_numpy(rng.integers(0, n_words - span - 128, items).astype(np.int32))
    if device is not None:
        src, starts = src.to(device), starts.to(device)
    return src, starts
