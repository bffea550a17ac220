#!/usr/bin/env python3
"""The JAX package's records on phase 16's parallel paths of
``chip_smoke.py``, as per-read digests, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_parallel_reference.py [--out FILE] [--cache-dir DIR]

The corpus is phase 4's: the first 256 reads of benchdata/reads.fasta on
the 4.6 Mb bench genome (the repository's bench.py writes both), at the
bench operating point (``blasr_tpu_torch.bench.bench_params``, k = 14).
The cells, each with the JAX package's -m 4 writer:

  * ``sharded_broadcast``: ``blasr_tpu.parallel.sharded.run_mapping_sharded``
    over 4 shards (``PARALLEL_SHARDS``), every read to every shard;
  * ``sharded_routed``: the same with ``route=True`` (the k-mer sketches);
  * ``server_1``, ``server_2``: the routed path on the first and the last
    128 of the reads, the two calls phase 16 makes of ``ShardedServer.map``
    (one server call is ``run_mapping_sharded`` with the server's routes);
  * ``host_parts``: ``blasr_tpu.parallel.multihost`` with two parts
    (``run_mapping_host_part`` 0 and 1 of 2, -m 4) merged by
    ``merge_host_parts``: the merged file's sha256 and line count;
  * ``dotplot``: ``blasr_tpu.pipeline.debug.dump_anchors`` (the body of
    ``tools dotplot``) on the first 32 reads with k = 14, its lines in
    ``pipeline/debug.canonical_anchor_lines`` order: their sha256 and count.

The sharded cells run with ``lazy_load`` from shard caches under
``--cache-dir`` (default a temporary directory), one shard's tables at a
time: ``lazy_load`` changes which arrays are resident, not the records.
The output (default ``tools/jax_parallel_reference.json``) holds, per
sharded cell, the digest of each read's -m 4 lines keyed by read name
(``chip_smoke.m4_digests``), the unmapped names, the record count, the
sorted sha256, the routed shard visits, and the reads file's md5, with
the host-clock seconds of each cell as CPU figures.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import io
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
    ap.add_argument("--out", default=os.path.join(HERE, "jax_parallel_reference.json"))
    ap.add_argument("--cache-dir", default=None, help="where the shard caches go")
    args = ap.parse_args()

    from bench import GENOME_FA, READS_FA, ensure_corpus
    from blasr_tpu.index.artifacts import build_index_from_arrays
    from blasr_tpu.io.batching import read_records
    from blasr_tpu.io.seqdb import load_genome
    from blasr_tpu.output.m4 import format_m4
    from blasr_tpu.params import MappingParams
    from blasr_tpu.parallel import multihost, sharded
    from blasr_tpu.pipeline.debug import dump_anchors
    from blasr_tpu_torch import bench
    from blasr_tpu_torch.pipeline.debug import canonical_anchor_lines
    from chip_smoke import PARALLEL_READS, PARALLEL_SHARDS, m4_digests, sorted_sha256

    ensure_corpus()
    genome, seqdb = load_genome(GENOME_FA)
    reads = read_records(READS_FA)[:PARALLEL_READS]
    with open(READS_FA, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    params = MappingParams(**dataclasses.asdict(bench.bench_params()))
    k = params.min_match_length
    cache = args.cache_dir or tempfile.mkdtemp()
    os.makedirs(cache, exist_ok=True)
    gpath = os.path.join(cache, "genome.fasta")
    shutil.copyfile(GENOME_FA, gpath)
    overlap = params.max_read_len + params.target_pad
    specs = sharded.make_shards(len(genome), PARALLEL_SHARDS, overlap)
    sketches = [sharded.build_shard_sketch(genome[s.block_lo : s.block_hi]) for s in specs]
    out = {}

    def cell(name, sub, **kw):
        t0 = time.time()
        recs, unmapped = sharded.run_mapping_sharded(
            genome, seqdb, sub, params, n_shards=PARALLEL_SHARDS, k=k, genome_path=gpath,
            lazy_load=True, **kw)
        lines = [(r.qname, format_m4(r)) for r in recs]
        visits = (sum(len(rt) for rt in sharded.route_reads(sub, sketches))
                  if kw.get("route") else len(sub) * len(specs))
        out[name] = {"reads_md5": md5, "reads": len(sub), "records": len(recs),
                     "unmapped": sorted(unmapped), "shard_visits": visits,
                     "accuracy_true_locus": bench.accuracy_true_locus(recs, sub),
                     "sha256_sorted": sorted_sha256([ln for _, ln in lines]),
                     "digests": m4_digests(lines),
                     "seconds_cpu_host_clock": round(time.time() - t0, 1)}
        print(json.dumps({"cell": name, **{k_: v for k_, v in out[name].items()
                                           if k_ not in ("digests", "unmapped")}}), flush=True)

    half = PARALLEL_READS // 2
    cell("sharded_broadcast", reads)
    cell("sharded_routed", reads, route=True)
    cell("server_1", reads[:half], route=True)
    cell("server_2", reads[half:], route=True)

    t0 = time.time()
    index = build_index_from_arrays(genome, seqdb, k)
    prefix = os.path.join(cache, "parts")
    for pid in range(2):
        multihost.run_mapping_host_part(index, reads, params, prefix, pid, 2)
    merged = os.path.join(cache, "merged.m4")
    n = multihost.merge_host_parts(prefix, merged, 2)
    with open(merged, "rb") as f:
        text = f.read()
    out["host_parts"] = {"reads_md5": md5, "records": n,
                         "sha256": hashlib.sha256(text).hexdigest(),
                         "seconds_cpu_host_clock": round(time.time() - t0, 1)}

    buf = io.StringIO()
    dump_anchors(index, reads[:32], MappingParams(min_match_length=k), buf)
    dots = canonical_anchor_lines(buf.getvalue().splitlines())
    out["dotplot"] = {"reads_md5": md5, "reads": 32, "lines": len(dots),
                      "sha256": hashlib.sha256("\n".join(dots).encode()).hexdigest()}
    print(json.dumps({c: {k_: v for k_, v in out[c].items() if k_ != "reads_md5"}
                      for c in ("host_parts", "dotplot")}), flush=True)
    with open(args.out, "w") as f:
        json.dump({"parallel": out}, f, indent=0, sort_keys=True)
        f.write("\n")
    if args.cache_dir is None:
        shutil.rmtree(cache)
    return 0


if __name__ == "__main__":
    sys.exit(main())
