#!/usr/bin/env python3
"""The JAX package's SAM lines on the CLR FASTQ and FASTA bench corpora, as
per-read digests, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_sam_reference.py [--out FILE] [--lines-dir DIR]

Two cells, each mapped by ``blasr_tpu.pipeline.runner.run_mapping`` on the
XLA paths (``use_pallas`` is off on the CPU) and written by the JAX
package's ``output.sam_writer.write_sam`` with ``clipping="soft"``, the
genome (so the CIGAR splits matches into = and X), the reads file's
basename as the movie name and the unmapped reads:

  config2      benchdata/reads_clr.fastq (2000 CLR-model reads, seed 13) at
               the bench operating point with move strings
               (``blasr_tpu_torch.bench.bench_params(emit_moves=True)``):
               the reference measurement's config 2, ``-sam -clipping
               soft`` on FASTQ reads;
  config3_sam  benchdata/reads.fasta (2000 simulated reads, seed 11) at
               ``blasr_tpu_torch.bench.config3_params()`` (best_n 2): the
               secondaries carry FLAG 256.

The parameters are the port's one definition of each operating point, as
the JAX package's ``MappingParams``. The output (default
``tools/jax_sam_reference.json``) holds, per cell, the digest of the @HD,
@RG and @SQ lines and the digest of each read's lines keyed by QNAME
(``chip_smoke.sam_digests``), the number of alignment lines, of those with
FLAG 4 and with FLAG 256, the unmapped read names, ``accuracy_true_locus``
of the records (``blasr_tpu_torch.bench``), the sha256 of all alignment
lines sorted and the md5 of the reads file; then the reads with a
secondary the JAX package emits from its SDP chain's blocks (``sdp_reads``),
which the port refines along the chain instead, and the digests of each
read's lines written without those records (``untouched_digests``, FLAG 256
lines ``untouched_secondaries``). ``chip_smoke.py`` holds the card's SAM
lines to it read by read, its refined records to the plain reference.
``--lines-dir`` also writes each cell's SAM text as ``<DIR>/<cell>.sam``.
Prints one JSON line per cell. Mapping the committed JSON's cells took
90.2 s (config2) and 32.0 s (config3_sam) on an x86 CPU, each line's
``seconds_cpu_host_clock``, the bench genome, the CLR corpus and the k=14
index written first.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import io
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, HERE]


def cell_params(cell: str):
    """The port's operating point of ``cell`` as the JAX package's
    MappingParams."""
    from blasr_tpu.params import MappingParams
    from blasr_tpu_torch import bench

    port = bench.bench_params(emit_moves=True) if cell == "config2" else bench.config3_params()
    return MappingParams(**dataclasses.asdict(port))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "jax_sam_reference.json"))
    ap.add_argument("--lines-dir", default=None,
                    help="also write each cell's SAM text as <DIR>/<cell>.sam")
    args = ap.parse_args()

    import jax_clr_accuracy  # the CLR corpus writer beside this file
    from bench import GENOME_FA, READS_FA, ensure_corpus
    from blasr_tpu.index.artifacts import load_index
    from blasr_tpu.io.batching import read_records
    from blasr_tpu.output.sam_writer import write_sam
    from blasr_tpu.pipeline import runner
    from blasr_tpu_torch.bench import accuracy_true_locus
    from chip_smoke import sam_digests, sam_flag_count, sorted_sha256

    ensure_corpus()
    genome_fa, reads_fq = jax_clr_accuracy.ensure_clr_corpus()
    if genome_fa != GENOME_FA:
        raise SystemExit(f"two bench genomes: {genome_fa} and {GENOME_FA}")
    index = load_index(genome_fa, k=14)
    out = {}
    for cell, path in (("config2", reads_fq), ("config3_sam", READS_FA)):
        reads = read_records(path)
        params = cell_params(cell)
        t0 = time.time()
        records, unmapped = runner.run_mapping(index, reads, params)
        seconds = time.time() - t0
        buf = io.StringIO()
        write_sam(records, reads, index.seqdb, buf, clipping="soft", unmapped=unmapped,
                  movie_name=os.path.basename(path), genome=index.genome)
        text = buf.getvalue()
        lines = text.splitlines()
        body = [ln for ln in lines if not ln.startswith("@")]
        header_sha, digests = sam_digests(lines)
        with open(path, "rb") as f:
            md5 = hashlib.md5(f.read()).hexdigest()
        # a secondary on its SDP chain's blocks (a longer read's records are
        # stitched from segments, and carry ops too)
        sdp = [r.path.packed is None and r.qlength <= params.max_read_len for r in records]
        keep = [r for r, x in zip(records, sdp) if not x]
        ubuf = io.StringIO()
        write_sam(keep, reads, index.seqdb, ubuf, clipping="soft", unmapped=unmapped,
                  movie_name=os.path.basename(path), genome=index.genome)
        ulines = ubuf.getvalue().splitlines()
        out[cell] = {
            "reads_file": os.path.relpath(path, REPO), "reads_md5": md5, "reads": len(reads),
            "movie_name": os.path.basename(path), "header_sha256": header_sha,
            "lines": len(body), "unmapped_lines": sam_flag_count(lines, 4),
            "secondaries": sam_flag_count(lines, 256), "unmapped": sorted(unmapped),
            "accuracy_true_locus": accuracy_true_locus(records, reads),
            "sha256_sorted": sorted_sha256(body), "digests": digests,
            "sdp_reads": sorted({r.qname for r, x in zip(records, sdp) if x}),
            "untouched_digests": sam_digests(ulines)[1],
            "untouched_secondaries": sam_flag_count(ulines, 256),
        }
        if args.lines_dir:
            os.makedirs(args.lines_dir, exist_ok=True)
            with open(os.path.join(args.lines_dir, f"{cell}.sam"), "w") as f:
                f.write(text)
        ref = out[cell]
        print(json.dumps({"cell": cell, "reads": len(reads), "lines": ref["lines"],
                          "unmapped_lines": ref["unmapped_lines"],
                          "secondaries": ref["secondaries"],
                          "accuracy_true_locus": ref["accuracy_true_locus"],
                          "sha256_sorted": ref["sha256_sorted"],
                          "seconds_cpu_host_clock": round(seconds, 1)}), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
