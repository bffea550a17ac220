#!/usr/bin/env python3
"""The JAX package's lines for phase 15 of chip_smoke.py (the optional
mapping modes), as per-read digests, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_modes_reference.py [--out FILE] [--lines-dir DIR]

Two parts, on the corpora that ``blasr_tpu_torch.bench`` writes under
benchdata/ when missing:

  * ``modes_cli``: ``blasr_tpu.cli.blasr.main`` with ``chip_smoke.CLI_FLAGS``
    (less ``-device``) and ``chip_smoke.MODES_CLI_FLAGS`` (-useSensitiveSearch
    -maxExpand 2 -placeRepeatsRandomly -randomSeed 7) on
    ``benchdata/reads_modes.fastq`` (``bench.ensure_modes_corpus``: the
    first 256 CLR FASTQ reads and four planted reads that need the
    passes), its -out lines kept as ``chip_smoke.text_digests`` gives
    them;
  * one ``run_mapping`` in this process per cell of
    ``chip_smoke.MODES_CELLS`` at the bench operating point with the
    cell's overrides: on the first 256 bench FASTA reads
    (``benchdata/reads_cli.fasta``, the file phase 4 writes) ``plain``,
    ``adaptive`` (adaptive_cd), ``exact_chain``, ``pvaltype2`` and
    ``pvaltype3``; on the modes corpus ``clr_plain`` and ``clr_retry``
    (the sensitive retry with the expand cascade to level 2).
    Each is kept as tools/jax_m4_reference.py keeps a corpus: per-read
    digests of the -m 4 lines, the unmapped names, the record count, the
    sorted lines' sha256 and the reads file's md5.

The JAX package raises at -pvaltype 2/3 (mapper.py:736 rebinds ``cand``,
which mapper.py:971 reads the window corners from), so those two cells
run through ``tests/test_torch_modes_passes.jax_run``: the package's
runner on a copy of its mapper made at run time with that one name
changed. The host-clock seconds of each run are kept as CPU figures. The
output defaults to ``tools/jax_modes_reference.json``; ``--lines-dir``
also writes the lines, to diff against the card's.
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
sys.path[:0] = [REPO, HERE, os.path.join(REPO, "tests")]


def _md5(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "jax_modes_reference.json"))
    ap.add_argument("--lines-dir", default=None, help="also write each cell's lines here")
    args = ap.parse_args()

    from blasr_tpu.cli.blasr import main as jax_cli
    from blasr_tpu.index.artifacts import load_index
    from blasr_tpu.io.batching import read_records
    from blasr_tpu.output.m4 import format_m4
    from blasr_tpu.params import MappingParams
    from blasr_tpu_torch import bench
    from chip_smoke import (CLI_FLAGS, MODES_CELLS, MODES_CLI_FLAGS, m4_digests,
                            side_file_names, sorted_sha256, text_digests)
    from test_torch_modes_passes import jax_run

    genome_fa, _ = bench.ensure_corpus()
    if os.path.exists(os.path.join(bench.BENCH_DIR, "reads_modes.fastq")):
        os.remove(os.path.join(bench.BENCH_DIR, "reads_modes.fastq"))   # written anew
    reads_modes = bench.ensure_modes_corpus()
    reads_cli = os.path.join(bench.BENCH_DIR, "reads_cli.fasta")
    bench.write_reads(reads_cli, bench.load_reads()[:256])
    out: dict = {}
    lines_out: dict = {}

    # the in-process cells, on the k = 14 index
    index = load_index(genome_fa, k=14)
    paths = {"fasta": reads_cli, "modes": reads_modes}
    for cell, (corpus, overrides) in MODES_CELLS.items():
        path = paths[corpus]
        reads = read_records(path)
        params = MappingParams(**dataclasses.asdict(bench.bench_params(**overrides)))
        t0 = time.time()
        records, unmapped = jax_run(index, reads, params)
        seconds = time.time() - t0
        lines = [(r.qname, format_m4(r)) for r in records]
        lines_out[cell] = [line for _, line in lines]
        out[cell] = {
            "reads_file": os.path.relpath(path, REPO), "reads_md5": _md5(path),
            "reads": len(reads), "overrides": overrides, "records": len(records),
            "unmapped": sorted(unmapped), "sha256_sorted": sorted_sha256(lines_out[cell]),
            "digests": m4_digests(lines), "seconds_cpu_host_clock": round(seconds, 1),
        }
        print(json.dumps({"cell": cell, "records": len(records), "unmapped": len(unmapped),
                          "seconds_cpu_host_clock": round(seconds, 1)}), flush=True)

    # the CLI with the retry passes, on its own k = 12 index
    i = CLI_FLAGS.index("-device")
    flags = CLI_FLAGS[:i] + CLI_FLAGS[i + 2:]
    tmp = os.path.join(bench.BENCH_DIR, "jax_modes")
    os.makedirs(tmp, exist_ok=True)
    out_path = os.path.join(tmp, "modes_cli.m4")
    t0 = time.time()
    jax_cli([reads_modes, genome_fa, *flags, *MODES_CLI_FLAGS, "-out", out_path])
    seconds = time.time() - t0
    with open(out_path) as f:
        lines = f.read().splitlines()
    names = side_file_names("out", lines, None)
    mapped = set(names)
    planted = [r.name for r in read_records(reads_modes) if r.name.startswith("planted/")]
    lines_out["modes_cli"] = lines
    out["modes_cli"] = {
        "reads_file": os.path.relpath(reads_modes, REPO), "reads_md5": _md5(reads_modes),
        "flags": MODES_CLI_FLAGS, "records": len(lines), **text_digests(lines, names),
        "planted_mapped": sorted(n for n in planted if n in mapped),
        "seconds_cpu_host_clock": round(seconds, 1),
    }
    print(json.dumps({"cell": "modes_cli", "records": len(lines),
                      "planted_mapped": out["modes_cli"]["planted_mapped"],
                      "seconds_cpu_host_clock": round(seconds, 1)}), flush=True)
    if args.lines_dir:
        os.makedirs(args.lines_dir, exist_ok=True)
        for cell, ls in lines_out.items():
            with open(os.path.join(args.lines_dir, f"{cell}.m4"), "w") as f:
                f.writelines(ln + "\n" for ln in ls)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
