#!/usr/bin/env python3
"""accuracy_true_locus of the JAX package on the CLR FASTQ corpus, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_clr_accuracy.py [--reads N]

The reference figure that ``chip_smoke.py`` holds the port's accuracy on
the same corpus against. The corpus is the one ``blasr_tpu_torch.bench.
ensure_fastq_corpus`` writes (4.6 Mb genome, seed 7; 2000 reads of the
published-CLR alchemy model, seed 13), made here with the JAX package's
own simulator and writers, which give the same bytes. Mapping runs
``blasr_tpu.pipeline.runner.run_mapping`` at the bench operating point
with the XLA paths (``use_pallas`` is off on the CPU), on the first
``--reads`` reads of the corpus. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def ensure_clr_corpus() -> tuple[str, str]:
    """The bench genome and the CLR FASTQ corpus under benchdata/, written
    by the JAX package's simulator and writers when missing; their paths."""
    from blasr_tpu.io.fasta import read_fasta, write_fasta
    from blasr_tpu.io.fastq import write_fastq
    from blasr_tpu.sim import ErrorModel, simulate_genome, simulate_reads_alchemy

    bench_dir = os.path.join(REPO, "benchdata")
    os.makedirs(bench_dir, exist_ok=True)
    genome_fa = os.path.join(bench_dir, "genome.fasta")
    reads_fq = os.path.join(bench_dir, "reads_clr.fastq")
    if not os.path.exists(genome_fa):
        write_fasta(genome_fa, [("ref", simulate_genome(4_600_000, seed=7))])
    if not os.path.exists(reads_fq):
        g = read_fasta(genome_fa)[0][1]
        reads, _ = simulate_reads_alchemy(g, ErrorModel.published_clr(), 2000, seed=13)
        write_fastq(reads_fq, [(r.name, r.codes, r.qual) for r in reads])
    return genome_fa, reads_fq


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=2000)
    args = ap.parse_args()

    from blasr_tpu.index.artifacts import load_index
    from blasr_tpu.io.batching import read_records
    from blasr_tpu.params import MappingParams
    from blasr_tpu.pipeline import runner
    from blasr_tpu.sim import parse_truth

    genome_fa, reads_fq = ensure_clr_corpus()
    reads = read_records(reads_fq)[: args.reads]
    index = load_index(genome_fa, k=14)
    # the operating point of blasr_tpu_torch.bench.bench_params
    params = MappingParams(
        batch_size=256, max_read_len=3328, n_candidates=4, n_dp_candidates=2,
        anchor_stride=4, max_anchors_per_read=128, narrow_band=32,
        narrow_band_max=3328, best_n=1, emit_moves=False, direct_lut=True,
    )
    t0 = time.time()
    records, unmapped = runner.run_mapping(index, reads, params)
    seconds = time.time() - t0
    best: dict = {}
    for r in records:
        if r.qname not in best or r.score < best[r.qname].score:
            best[r.qname] = r
    n_ok = 0
    for rd in reads:
        rec = best.get(rd.name)
        if rec is None:
            continue
        start, end, strand = parse_truth(rd.name)
        if (rec.tstrand == strand and abs(rec.tstart_fwd - start) < 100
                and abs(rec.tend_fwd - end) < 100):
            n_ok += 1
    print(json.dumps({
        "reads": len(reads), "records": len(records), "unmapped": len(unmapped),
        "accuracy_true_locus": n_ok / max(len(reads), 1),
        "seconds_cpu_host_clock": round(seconds, 1),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
