#!/usr/bin/env python3
"""The JAX package's piecewise records on config 5's contigs and on the
long-read corpus, as per-read digests, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_piecewise_reference.py [--out FILE] [--lines-dir DIR]

The corpora are written under benchdata/ by ``blasr_tpu_torch.bench``
when missing: ``contigs.fasta`` (``ensure_contig_corpus``, config 5: two
contigs of 1.2 and 0.8 Mb evolved from the bench genome) and
``reads_long.fasta`` (``ensure_long_corpus``: 300 simulated reads of
5-24 kb, then the first 100 bench reads). The index is the JAX package's
k=14 index of the bench genome. Config 5 runs
``blasr_tpu.pipeline.piecewise.run_mapping_piecewise`` at
``blasr_tpu_torch.bench.config5_params`` (the bench operating point with
piecewise mapping, ``remove_contained`` and move strings on); the long
reads run ``blasr_tpu.pipeline.runner.run_mapping`` at ``bench_params``,
whose automatic segmentation maps every read above ``max_read_len``
piecewise. Both on the XLA paths (``use_pallas`` is off on the CPU).

The output (default ``tools/jax_piecewise_reference.json``) holds, under
``config5`` and ``long``, the digest of each read's -m 4 lines keyed by
read name (``chip_smoke.m4_digests``), the unmapped read names, the
record count, ``accuracy_true_locus`` (``blasr_tpu_torch.bench``; the
long reads only), the sha256 of all lines sorted and the md5 of the reads
file, config 5's -m 4 lines themselves, and under ``config5_sam`` config
5's SAM text (``-clipping soft``) as ``chip_smoke.sam_digests`` gives it,
with the host-clock seconds of each mapping as CPU figures.
``chip_smoke.py`` holds the card's lines to it read by read.
``--lines-dir`` also writes the lines, to diff against the card's.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "jax_piecewise_reference.json"))
    ap.add_argument("--lines-dir", default=None, help="also write each cell's lines here")
    args = ap.parse_args()

    from blasr_tpu.index.artifacts import load_index
    from blasr_tpu.io.batching import read_records
    from blasr_tpu.output.m4 import format_m4
    from blasr_tpu.output.sam_writer import write_sam
    from blasr_tpu.params import MappingParams
    from blasr_tpu.pipeline import runner
    from blasr_tpu.pipeline.piecewise import run_mapping_piecewise
    from blasr_tpu_torch import bench
    from chip_smoke import m4_digests, sam_digests, sam_flag_count, sorted_sha256

    genome_fa, _ = bench.ensure_corpus()
    cells = (("config5", bench.ensure_contig_corpus(), bench.config5_params()),
             ("long", bench.ensure_long_corpus(), bench.bench_params()))
    index = load_index(genome_fa, k=14)
    out = {}
    for cell, path, port_params in cells:
        params = MappingParams(**dataclasses.asdict(port_params))
        reads = read_records(path)
        run = run_mapping_piecewise if cell == "config5" else runner.run_mapping
        t0 = time.time()
        records, unmapped = run(index, reads, params)
        seconds = time.time() - t0
        lines = [(r.qname, format_m4(r)) for r in records]
        with open(path, "rb") as f:
            md5 = hashlib.md5(f.read()).hexdigest()
        out[cell] = {
            "reads_file": os.path.relpath(path, REPO), "reads_md5": md5,
            "reads": len(reads), "bases": sum(len(r) for r in reads), "records": len(records),
            "unmapped": sorted(unmapped),
            "sha256_sorted": sorted_sha256([line for _, line in lines]),
            "digests": m4_digests(lines), "seconds_cpu_host_clock": round(seconds, 1),
        }
        if cell == "long":
            out[cell]["accuracy_true_locus"] = bench.accuracy_true_locus(records, reads)
        else:
            out[cell]["lines"] = [line for _, line in lines]
            buf = io.StringIO()
            write_sam(records, reads, index.seqdb, buf, clipping="soft", unmapped=unmapped,
                      movie_name=os.path.basename(path), genome=index.genome)
            sam = buf.getvalue().splitlines()
            body = [ln for ln in sam if not ln.startswith("@")]
            header_sha, digests = sam_digests(sam)
            out["config5_sam"] = {
                "reads_file": out[cell]["reads_file"], "reads_md5": md5,
                "movie_name": os.path.basename(path), "header_sha256": header_sha,
                "lines": len(body), "unmapped_lines": sam_flag_count(sam, 4),
                "secondaries": sam_flag_count(sam, 256), "sha256_sorted": sorted_sha256(body),
                "digests": digests,
            }
            if args.lines_dir:
                os.makedirs(args.lines_dir, exist_ok=True)
                with open(os.path.join(args.lines_dir, "config5.sam"), "w") as f:
                    f.writelines(line + "\n" for line in sam)
        if args.lines_dir:
            os.makedirs(args.lines_dir, exist_ok=True)
            with open(os.path.join(args.lines_dir, f"{cell}.m4"), "w") as f:
                f.writelines(line + "\n" for _, line in lines)
        print(json.dumps({"cell": cell, "reads": len(reads), "records": len(records),
                          "unmapped": len(unmapped),
                          **({"accuracy_true_locus": out[cell]["accuracy_true_locus"]}
                             if cell == "long" else {"lines": out[cell]["lines"]}),
                          "seconds_cpu_host_clock": round(seconds, 1)}), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
