#!/usr/bin/env python3
"""The JAX package's -m 4 records with seeds of k = 15 and k = 18 on the
FASTA bench corpus, as per-read digests, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_sa_reference.py [--out FILE] [--lines-dir DIR]

The corpus is benchdata/reads.fasta (2000 simulated reads of mean 1 kb,
seed 11, on the 4.6 Mb genome of seed 7), written by the repository's
bench.py when it is missing. For each k the index is the JAX package's
``build_index_from_arrays`` of the genome; the operating points are
``blasr_tpu_torch.bench.k15_params`` and ``k18_params`` (the bench
operating point with ``min_match_length`` 15 or 18), so the JAX package's
``make_device_index`` takes its bisection index at k = 15 (although
``direct_lut`` is set: 2k > 28) and its wide-key index at k = 18. Mapping
runs ``blasr_tpu.pipeline.runner.run_mapping`` on the XLA paths
(``use_pallas`` is off on the CPU), and every record is formatted with the
JAX package's -m 4 writer. The output (default
``tools/jax_sa_reference.json``) holds, under ``k15`` and ``k18``, the
digest of each read's -m 4 lines keyed by read name
(``chip_smoke.m4_digests``), the unmapped read names, the record count,
``accuracy_true_locus`` of the best records (``blasr_tpu_torch.bench``),
the sha256 of all lines sorted, the md5 of the reads file and the
host-clock seconds of the index build (with ``make_device_index``) and of
the mapping, as CPU figures. ``chip_smoke.py`` holds the card's lines to
it read by read. ``--lines-dir`` also writes the lines, to diff against
the card's.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "jax_sa_reference.json"))
    ap.add_argument("--lines-dir", default=None, help="also write each cell's -m 4 lines here")
    args = ap.parse_args()

    from bench import GENOME_FA, READS_FA, ensure_corpus
    from blasr_tpu.index.artifacts import build_index_from_arrays
    from blasr_tpu.io.batching import read_records
    from blasr_tpu.io.seqdb import load_genome
    from blasr_tpu.output.m4 import format_m4
    from blasr_tpu.params import MappingParams
    from blasr_tpu.pipeline import mapper, runner
    from blasr_tpu_torch import bench
    from chip_smoke import m4_digests, sorted_sha256

    ensure_corpus()
    genome, seqdb = load_genome(GENOME_FA)
    reads = read_records(READS_FA)
    with open(READS_FA, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    out = {}
    for cell, port_params in (("k15", bench.k15_params), ("k18", bench.k18_params)):
        params = MappingParams(**dataclasses.asdict(port_params()))
        t0 = time.time()
        index = build_index_from_arrays(genome, seqdb, params.min_match_length)
        di = mapper.make_device_index(index, params)
        index_seconds = time.time() - t0
        t0 = time.time()
        records, unmapped = runner.run_mapping(index, reads, params)
        seconds = time.time() - t0
        lines = [(r.qname, format_m4(r)) for r in records]
        out[cell] = {
            "reads_file": os.path.relpath(READS_FA, REPO), "reads_md5": md5,
            "reads": len(reads), "records": len(records),
            "accuracy_true_locus": bench.accuracy_true_locus(records, reads),
            "unmapped": sorted(unmapped),
            "sha256_sorted": sorted_sha256([line for _, line in lines]),
            "digests": m4_digests(lines), "k": params.min_match_length,
            "lut_meta": list(di.lut_meta),
            "index_seconds_cpu_host_clock": round(index_seconds, 1),
            "seconds_cpu_host_clock": round(seconds, 1),
        }
        if args.lines_dir:
            os.makedirs(args.lines_dir, exist_ok=True)
            with open(os.path.join(args.lines_dir, f"{cell}.m4"), "w") as f:
                f.writelines(line + "\n" for _, line in lines)
        print(json.dumps({"corpus": cell, "records": len(records), "unmapped": len(unmapped),
                          "accuracy_true_locus": out[cell]["accuracy_true_locus"],
                          "lut_meta": out[cell]["lut_meta"],
                          "index_seconds_cpu_host_clock": round(index_seconds, 1),
                          "seconds_cpu_host_clock": round(seconds, 1)}), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
