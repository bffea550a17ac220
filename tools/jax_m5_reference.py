#!/usr/bin/env python3
"""The JAX package's -bestn 2 -m 5 records on the FASTA bench corpus, as
per-read digests, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_m5_reference.py [--out FILE] [--lines FILE]

The corpus is benchdata/reads.fasta (2000 simulated reads of mean 1 kb,
seed 11, on the 4.6 Mb genome of seed 7), written by the repository's
bench.py when it is missing. The operating point is config 3 of
scripts/bench_config34.py as ``blasr_tpu_torch.bench.config3_params``
names it: the bench operating point with best_n 2 and move strings on.
Mapping runs ``blasr_tpu.pipeline.runner.run_mapping`` on the XLA paths
(``use_pallas`` is off on the CPU), and every record is formatted with the
JAX package's ``format_m5``. The output (default
``tools/jax_m5_reference.json``) holds, under ``config3``, the digest of
each read's -m 5 lines keyed by read name (``chip_smoke.m4_digests``), the
unmapped read names, the record count, the secondaries (records beyond the
first of their read), ``accuracy_true_locus`` of the best records
(``blasr_tpu_torch.bench``), the sha256 of all lines sorted and the md5 of
the reads file; then the secondaries the JAX package emits from their SDP
chain's blocks (``sdp_records``, their reads ``sdp_reads``), which the port
refines along the chain instead, and the digests of each read's lines
without them (``untouched_digests``). ``chip_smoke.py`` holds the card's
lines to it read by read, its refined records to the plain reference.
``--lines`` also writes the lines, to diff against the card's. About a
minute; prints one JSON line.
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


def config3_params():
    """blasr_tpu_torch.bench.config3_params as the JAX package's
    MappingParams: the port's one definition of the operating point."""
    from blasr_tpu.params import MappingParams
    from blasr_tpu_torch.bench import config3_params as port_params

    return MappingParams(**dataclasses.asdict(port_params()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "jax_m5_reference.json"))
    ap.add_argument("--lines", default=None, help="also write the -m 5 lines to this file")
    args = ap.parse_args()

    from bench import GENOME_FA, READS_FA, ensure_corpus
    from blasr_tpu.index.artifacts import load_index
    from blasr_tpu.io.batching import read_records
    from blasr_tpu.output.verbose import format_m5
    from blasr_tpu.pipeline import runner
    from blasr_tpu_torch.bench import accuracy_true_locus
    from chip_smoke import m4_digests, n_secondaries, sorted_sha256

    ensure_corpus()
    index = load_index(GENOME_FA, k=14)
    reads = read_records(READS_FA)
    by_name = {r.name: r for r in reads}
    params = config3_params()
    t0 = time.time()
    records, unmapped = runner.run_mapping(index, reads, params)
    seconds = time.time() - t0
    lines = [(r.qname, format_m5(r, by_name[r.qname], index)) for r in records]
    # a secondary on its SDP chain's blocks (a longer read's records are
    # stitched from segments, and carry ops too)
    sdp = [r.path.packed is None and r.qlength <= params.max_read_len for r in records]
    with open(READS_FA, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    ref = {
        "reads_file": os.path.relpath(READS_FA, REPO), "reads_md5": md5, "reads": len(reads),
        "records": len(records), "secondaries": n_secondaries(records),
        "accuracy_true_locus": accuracy_true_locus(records, reads),
        "unmapped": sorted(unmapped),
        "sha256_sorted": sorted_sha256([line for _, line in lines]),
        "digests": m4_digests(lines),
        "sdp_records": sum(sdp), "sdp_reads": sorted({r.qname for r, x in zip(records, sdp) if x}),
        "untouched_digests": m4_digests([ln for ln, x in zip(lines, sdp) if not x]),
    }
    if args.lines:
        with open(args.lines, "w") as f:
            f.writelines(line + "\n" for _, line in lines)
    with open(args.out, "w") as f:
        json.dump({"config3": ref}, f, indent=0, sort_keys=True)
        f.write("\n")
    print(json.dumps({"corpus": "config3", "reads": len(reads), "records": len(records),
                      "secondaries": ref["secondaries"], "unmapped": len(unmapped),
                      "accuracy_true_locus": ref["accuracy_true_locus"],
                      "sha256_sorted": ref["sha256_sorted"],
                      "seconds_cpu_host_clock": round(seconds, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
