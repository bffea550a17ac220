#!/usr/bin/env python3
"""The JAX package's -m 4 records on the 200 Mb genome in 4 shards, as
per-read digests, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_sharded_reference.py [--out FILE] [--dir DIR]

The genome, reads and parameters are ``tools/torch_sharded_smoke.py``'s
(those of ``tools/torch_big_genome_smoke.py``: 200,000,000 random bases,
seed 3, 10 contigs, k = 15, 256 reads of mean 500 and 256 of mean 1000,
seed 5, B = 64). The genome is written as FASTA under ``--dir`` (default
a temporary directory, removed at the end), beside which
``blasr_tpu.parallel.sharded.run_mapping_sharded`` keeps its shard
caches; each read set maps over 4 shards with ``lazy_load``, every read
to every shard (``broadcast``) and routed by the k-mer sketches
(``routed``). The output (default ``tools/jax_sharded_reference.json``)
holds, per read set and cell, the digest of each read's -m 4 lines keyed
by read name (``chip_smoke.m4_digests``), the unmapped names, the record
count, the sorted sha256, the routed shard visits and the reads' md5
(``torch_big_genome_smoke.reads_md5``), with the host-clock seconds of
each mapping as CPU figures.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, HERE]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "jax_sharded_reference.json"))
    ap.add_argument("--dir", default=None, help="where the genome FASTA and caches go")
    args = ap.parse_args()

    import numpy as np

    from blasr_tpu.io.seqdb import SeqDB
    from blasr_tpu.output.m4 import format_m4
    from blasr_tpu.params import MappingParams
    from blasr_tpu.parallel import sharded
    from blasr_tpu.sim import simulate_reads

    import torch_big_genome_smoke as twin
    import torch_sharded_smoke as smoke
    from chip_smoke import m4_digests, sorted_sha256

    params = MappingParams(**dataclasses.asdict(twin.big_params()))
    genome, starts, names = twin.big_genome()
    seqdb = SeqDB(names, starts, ["0" * 32] * twin.N_CONTIGS)
    work = args.dir or tempfile.mkdtemp()
    gpath = os.path.join(work, "genome.fasta")
    smoke.write_genome(gpath, genome, starts, names)
    overlap = params.max_read_len + params.target_pad
    specs = sharded.make_shards(len(genome), smoke.N_SHARDS, overlap)
    out = {}
    for mean_len in twin.MEAN_LENS:
        name = f"mean{mean_len}"
        reads, _ = simulate_reads(genome, twin.N_READS, mean_len=mean_len, seed=twin.READ_SEED)
        out[name] = {"reads_md5": twin.reads_md5(reads)}
        for cell, kw in (("broadcast", {}), ("routed", {"route": True})):
            t0 = time.time()
            recs, unmapped = sharded.run_mapping_sharded(
                genome, seqdb, reads, params, n_shards=smoke.N_SHARDS, k=twin.K,
                genome_path=gpath, lazy_load=True, **kw)
            seconds = time.time() - t0
            lines = [(r.qname, format_m4(r)) for r in recs]
            n_ok, n_strand = twin.locus_counts(recs, reads, starts)
            out[name][cell] = {
                "records": len(recs), "unmapped": sorted(unmapped), "correct": n_ok,
                "strand_ok": n_strand, "sha256_sorted": sorted_sha256([ln for _, ln in lines]),
                "digests": m4_digests(lines), "seconds_cpu_host_clock": round(seconds, 1)}
            if kw:
                sketches = [np.load(sharded.sketch_cache_path(gpath, smoke.N_SHARDS, s, overlap))
                            for s in range(len(specs))]
                out[name][cell]["shard_visits"] = sum(
                    len(rt) for rt in sharded.route_reads(reads, sketches))
            print(json.dumps({"cell": f"{name}/{cell}", **{
                k: v for k, v in out[name][cell].items() if k not in ("digests", "unmapped")}}),
                flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
        f.write("\n")
    if args.dir is None:
        shutil.rmtree(work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
