#!/usr/bin/env python3
"""The JAX package's -m 4 records on the three corpora that chip_smoke.py
maps, as per-read digests, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_m4_reference.py [--out FILE] [--lines-dir DIR]

The corpora and their flags are those of chip_smoke.py's timed runs:

  fasta       benchdata/reads.fasta (2000 simulated reads, seed 11) at the
              bench operating point (blasr_tpu_torch.bench.bench_params);
  clr         benchdata/reads_clr.fastq (2000 CLR-model reads, seed 13) at
              the bench operating point;
  clr_guided  the same reads with -useGuidedAlign on chip_smoke.CLI_FLAGS
              (the JAX command line's params_from_args, without -device).

Each corpus is written by the JAX package's own simulator and writers when
it is missing (the same bytes as the port's). Mapping runs
``blasr_tpu.pipeline.runner.run_mapping`` on the XLA paths (``use_pallas``
is off on the CPU) and formats every record with the JAX package's -m 4
writer. The output (default ``tools/jax_m4_reference.json``) holds, per
corpus, the digest of each read's -m 4 lines keyed by read name
(``chip_smoke.m4_digests``), the unmapped read names, the record count,
the sha256 of all lines sorted and the md5 of the reads file.
``chip_smoke.py`` holds the card's lines to it read by read.
``--lines-dir`` also writes each corpus's lines as ``<DIR>/<corpus>.m4``,
to diff against the card's. About a minute per corpus; prints one JSON
line per corpus.
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
CORPORA = ("fasta", "clr", "clr_guided")


def bench_params():
    """blasr_tpu_torch.bench.bench_params as the JAX package's
    MappingParams: the port's one definition of the operating point."""
    from blasr_tpu.params import MappingParams
    from blasr_tpu_torch.bench import bench_params as port_params

    return MappingParams(**dataclasses.asdict(port_params()))


def guided_params(reads_fq: str, genome_fa: str):
    """chip_smoke.CLI_FLAGS with -useGuidedAlign, through the JAX command
    line (without -device, which only the port's command line has)."""
    from blasr_tpu.cli.blasr import build_arg_parser, params_from_args
    from chip_smoke import CLI_FLAGS

    flags = list(CLI_FLAGS)
    i = flags.index("-device")
    del flags[i : i + 2]
    params = params_from_args(
        build_arg_parser().parse_args([reads_fq, genome_fa, *flags, "-useGuidedAlign"]))
    if not params.guided_band:
        raise SystemExit("-useGuidedAlign did not set guided_band")
    return params


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "jax_m4_reference.json"))
    ap.add_argument("--lines-dir", default=None,
                    help="also write each corpus's -m 4 lines as <DIR>/<corpus>.m4")
    ap.add_argument("--corpora", default=",".join(CORPORA))
    args = ap.parse_args()

    import jax_clr_accuracy  # the CLR corpus writer beside this file

    from bench import GENOME_FA, READS_FA, ensure_corpus
    from blasr_tpu.index.artifacts import load_index
    from blasr_tpu.io.batching import read_records
    from blasr_tpu.output.m4 import format_m4
    from blasr_tpu.pipeline import runner
    from chip_smoke import m4_digests, sorted_sha256

    ensure_corpus()
    genome_fa, reads_fq = jax_clr_accuracy.ensure_clr_corpus()
    if genome_fa != GENOME_FA:
        raise SystemExit(f"two bench genomes: {genome_fa} and {GENOME_FA}")
    index = load_index(genome_fa, k=14)
    inputs = {
        "fasta": (READS_FA, bench_params),
        "clr": (reads_fq, bench_params),
        "clr_guided": (reads_fq, lambda: guided_params(reads_fq, genome_fa)),
    }
    out = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    for name in args.corpora.split(","):
        path, make_params = inputs[name]
        reads = read_records(path)
        t0 = time.time()
        records, unmapped = runner.run_mapping(index, reads, make_params())
        seconds = time.time() - t0
        lines = [(r.qname, format_m4(r)) for r in records]
        with open(path, "rb") as f:
            md5 = hashlib.md5(f.read()).hexdigest()
        out[name] = {
            "reads_file": os.path.relpath(path, REPO), "reads_md5": md5, "reads": len(reads),
            "records": len(records), "unmapped": sorted(unmapped),
            "sha256_sorted": sorted_sha256([line for _, line in lines]),
            "digests": m4_digests(lines),
        }
        if args.lines_dir:
            os.makedirs(args.lines_dir, exist_ok=True)
            with open(os.path.join(args.lines_dir, f"{name}.m4"), "w") as f:
                f.writelines(line + "\n" for _, line in lines)
        print(json.dumps({"corpus": name, "reads": len(reads), "records": len(records),
                          "unmapped": len(unmapped), "sha256_sorted": out[name]["sha256_sorted"],
                          "seconds_cpu_host_clock": round(seconds, 1)}), flush=True)
    with open(args.out, "w") as f:
        json.dump({k: out[k] for k in CORPORA if k in out}, f, indent=0, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
