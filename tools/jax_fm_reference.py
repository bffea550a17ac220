#!/usr/bin/env python3
"""The JAX package's config-4 (-bwt -m 4) records on the FASTA bench
corpus, as per-read digests, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_fm_reference.py [--out FILE] [--lines FILE]

The corpus is benchdata/reads.fasta (2000 simulated reads of mean 1 kb,
seed 11, on the 4.6 Mb genome of seed 7), written by the repository's
bench.py when it is missing. The index is what the JAX command line builds
for ``-bwt``: a genome-only ``GenomeIndex`` (no suffix array) and the FM
index from ``blasr_tpu.index.fm.build_fm_index`` over the genome's suffix
array. The operating point is config 4 of scripts/bench_config34.py as
``blasr_tpu_torch.bench.config4_params`` names it: the bench operating
point at B=64, best_n 1, no move strings. Mapping runs
``blasr_tpu.pipeline.runner.run_mapping(..., fm=fm)`` on the XLA paths
(``use_pallas`` is off on the CPU), and every record is formatted with the
JAX package's -m 4 writer. The output (default
``tools/jax_fm_reference.json``) holds, under ``config4``, the digest of
each read's -m 4 lines keyed by read name (``chip_smoke.m4_digests``), the
unmapped read names, the record count, ``accuracy_true_locus`` of the best
records (``blasr_tpu_torch.bench``), the sha256 of all lines sorted and the
md5 of the reads file. ``chip_smoke.py`` holds the card's lines to it read
by read. ``--lines`` also writes the lines, to diff against the card's.
Prints one JSON line with the host-clock seconds of the FM build and of
the mapping.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, HERE]


def config4_params():
    """blasr_tpu_torch.bench.config4_params as the JAX package's
    MappingParams: the port's one definition of the operating point."""
    from blasr_tpu.params import MappingParams
    from blasr_tpu_torch.bench import config4_params as port_params

    return MappingParams(**dataclasses.asdict(port_params()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "jax_fm_reference.json"))
    ap.add_argument("--lines", default=None, help="also write the -m 4 lines to this file")
    args = ap.parse_args()

    import numpy as np

    from bench import GENOME_FA, READS_FA, ensure_corpus
    from blasr_tpu.index.artifacts import GenomeIndex, build_pos_ok
    from blasr_tpu.index.fm import build_fm_index
    from blasr_tpu.index.suffix_array import build_suffix_array
    from blasr_tpu.io.batching import read_records
    from blasr_tpu.io.seqdb import load_genome
    from blasr_tpu.output.m4 import format_m4
    from blasr_tpu.pipeline import runner
    from blasr_tpu_torch.bench import accuracy_true_locus
    from chip_smoke import m4_digests, sorted_sha256

    ensure_corpus()
    params = config4_params()
    genome, seqdb = load_genome(GENOME_FA)
    empty = np.zeros(0, np.int32)
    k = params.min_match_length
    index = GenomeIndex(genome, empty, empty, build_pos_ok(genome, seqdb, k), k, seqdb)
    t0 = time.time()
    fm = build_fm_index(genome, build_suffix_array(genome))
    fm_seconds = time.time() - t0
    reads = read_records(READS_FA)
    t0 = time.time()
    records, unmapped = runner.run_mapping(index, reads, params, fm=fm)
    seconds = time.time() - t0
    lines = [(r.qname, format_m4(r)) for r in records]
    with open(READS_FA, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    ref = {
        "reads_file": os.path.relpath(READS_FA, REPO), "reads_md5": md5, "reads": len(reads),
        "records": len(records), "accuracy_true_locus": accuracy_true_locus(records, reads),
        "unmapped": sorted(unmapped),
        "sha256_sorted": sorted_sha256([line for _, line in lines]),
        "digests": m4_digests(lines),
    }
    if args.lines:
        with open(args.lines, "w") as f:
            f.writelines(line + "\n" for _, line in lines)
    with open(args.out, "w") as f:
        json.dump({"config4": ref}, f, indent=0, sort_keys=True)
        f.write("\n")
    print(json.dumps({"corpus": "config4", "reads": len(reads), "records": len(records),
                      "unmapped": len(unmapped),
                      "accuracy_true_locus": ref["accuracy_true_locus"],
                      "sha256_sorted": ref["sha256_sorted"],
                      "fm_build_seconds_cpu_host_clock": round(fm_seconds, 1),
                      "seconds_cpu_host_clock": round(seconds, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
