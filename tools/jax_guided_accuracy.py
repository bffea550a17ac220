#!/usr/bin/env python3
"""accuracy_true_locus of the JAX package with guided bands on the CLR
FASTQ corpus, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_guided_accuracy.py [--reads N]

The reference figure that ``chip_smoke.py`` holds the port's guided run
against. The corpus is the one ``tools/jax_clr_accuracy.py`` describes
(``benchdata/reads_clr.fastq``, written here by the JAX package's own
simulator when it is missing). The parameters are those of the port's
guided phase: the JAX command line's ``params_from_args`` on
``chip_smoke.CLI_FLAGS`` with ``-useGuidedAlign`` (without ``-device``,
which only the port's command line has): reads up to 1536 bp take the
guided W=32 band, longer ones the guided base band of 128, and band
escalation re-maps the clipped reads through the wide unguided band.
Mapping runs ``blasr_tpu.pipeline.runner.run_mapping`` with the XLA paths
(``use_pallas`` is off on the CPU) on the first ``--reads`` reads. Prints
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, HERE]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=2000)
    args = ap.parse_args()

    import jax_clr_accuracy  # the corpus writer beside this file

    from blasr_tpu.cli.blasr import build_arg_parser, params_from_args
    from blasr_tpu.index.artifacts import load_index
    from blasr_tpu.io.batching import read_records
    from blasr_tpu.pipeline import runner
    from blasr_tpu.sim import parse_truth
    from chip_smoke import CLI_FLAGS

    genome_fa, reads_fq = jax_clr_accuracy.ensure_clr_corpus()
    reads = read_records(reads_fq)[: args.reads]
    index = load_index(genome_fa, k=14)
    flags = list(CLI_FLAGS)
    i = flags.index("-device")
    del flags[i : i + 2]
    params = params_from_args(
        build_arg_parser().parse_args([reads_fq, genome_fa, *flags, "-useGuidedAlign"]))
    if not params.guided_band:
        raise SystemExit("-useGuidedAlign did not set guided_band")
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
