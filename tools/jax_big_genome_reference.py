#!/usr/bin/env python3
"""The JAX package's -m 4 records on the 200 Mb genome of
``scripts/big_genome_smoke.py``, as per-read digests, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_big_genome_reference.py [--out FILE]

The genome, reads and parameters are ``tools/torch_big_genome_smoke.py``'s
(the port's twin of the script, which holds the card's lines to this
file): 200,000,000 random bases (seed 3) in 10 contigs, the JAX package's
``build_index_from_arrays`` at k = 15 (its bisection index), and 256 reads
of mean length 500 and 256 of mean 1000 (``blasr_tpu.sim.simulate_reads``,
seed 5), mapped by ``blasr_tpu.pipeline.runner.run_mapping`` on the XLA
paths at B = 64, ``max_read_len`` 3072, 4 candidates, best_n 1. The output
(default ``tools/jax_big_genome_reference.json``) holds, for each read set
(``mean500``, ``mean1000``), the digest of each read's -m 4 lines keyed by
read name, the unmapped read names, the record count, the script's
correctness figures, the sha256 of all lines sorted and the reads' md5
(``torch_big_genome_smoke.reads_md5``), and the host-clock seconds of the
JAX index build (with ``make_device_index``) and of each mapping, as CPU
figures. The host holds some 12 GB at the peak.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, HERE]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "jax_big_genome_reference.json"))
    args = ap.parse_args()

    from blasr_tpu.index.artifacts import build_index_from_arrays
    from blasr_tpu.io.seqdb import SeqDB
    from blasr_tpu.output.m4 import format_m4
    from blasr_tpu.params import MappingParams
    from blasr_tpu.pipeline import mapper, runner
    from blasr_tpu.sim import simulate_reads

    import torch_big_genome_smoke as twin
    from chip_smoke import m4_digests, sorted_sha256

    params = MappingParams(**dataclasses.asdict(twin.big_params()))
    genome, starts, names = twin.big_genome()
    seqdb = SeqDB(names, starts, ["0" * 32] * twin.N_CONTIGS)
    t0 = time.time()
    index = build_index_from_arrays(genome, seqdb, twin.K)
    build_s = time.time() - t0
    t0 = time.time()
    di = mapper.make_device_index(index, params)
    di_s = time.time() - t0
    out = {"index_build_seconds_cpu_host_clock": round(build_s, 1),
           "make_device_index_seconds_cpu_host_clock": round(di_s, 1),
           "lut_meta": list(di.lut_meta)}
    for mean_len in twin.MEAN_LENS:
        reads, _ = simulate_reads(genome, twin.N_READS, mean_len=mean_len, seed=twin.READ_SEED)
        t0 = time.time()
        records, unmapped = runner.run_mapping(index, reads, params)
        seconds = time.time() - t0
        lines = [(r.qname, format_m4(r)) for r in records]
        n_ok, n_strand = twin.locus_counts(records, reads, starts)
        out[f"mean{mean_len}"] = {
            "reads_md5": twin.reads_md5(reads), "reads": len(reads), "records": len(records),
            "correct": n_ok, "strand_ok": n_strand, "unmapped": sorted(unmapped),
            "sha256_sorted": sorted_sha256([line for _, line in lines]),
            "digests": m4_digests(lines),
            "seconds_cpu_host_clock": round(seconds, 1),
        }
        print(json.dumps({"cell": f"mean{mean_len}", "records": len(records),
                          "unmapped": len(unmapped), "correct": n_ok, "strand_ok": n_strand,
                          "seconds_cpu_host_clock": round(seconds, 1)}), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items() if not k.startswith("mean")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
