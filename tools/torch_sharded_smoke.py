#!/usr/bin/env python3
"""The 200 Mb genome in shards on one GPU: the port's twin of
``scripts/hg19_sharded_smoke.py``.

    python3 tools/torch_sharded_smoke.py [--out FILE] [--dir DIR]

The genome, reads and parameters are ``tools/torch_big_genome_smoke.py``'s
(200,000,000 random bases, seed 3, 10 contigs; k = 15, which takes the
bisection index; 256 reads of mean length 500 and 256 of mean 1000, seed
5; B = 64, ``max_read_len`` 3072, 4 candidates, best_n 1). The genome is
written once as FASTA under ``--dir`` (default ``benchdata/big200/``),
beside which ``parallel/sharded.build_or_load_shards`` writes the 4 shard
caches (uncompressed) and the routing sketches; each is timed. Then, per
read set, on cuda:0:

  * ``plain``: the unsharded index, resident (a warm-up run, then a timed
    one), held to ``tools/jax_big_genome_reference.json``;
  * ``broadcast`` and ``routed``: ``run_mapping_sharded`` with
    ``lazy_load`` from the shard caches (one shard's arrays at a time,
    loaded in the call), every read to every shard or to the shards its
    k-mer sketch names;
  * ``broadcast_resident`` and ``routed_resident``: the shard indexes
    loaded once and their device tables built before the timed runs (and
    kept between the two read sets), one thread for the one card;

each sharded run held to ``tools/jax_sharded_reference.json``
(``tools/jax_sharded_reference.py``, the JAX package on the CPU) read by
read, no read may differ, with its wall, reads/s against the plain run's,
peak device memory and the routed shard visits a read. Prints the card's
name and power limit first and one JSON line last. Needs a CUDA card; it
does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, HERE]

N_SHARDS = 4
REFERENCE = os.path.join(HERE, "jax_sharded_reference.json")
PLAIN_REFERENCE = os.path.join(HERE, "jax_big_genome_reference.json")


def write_genome(path: str, genome, starts, names) -> float:
    """The 200 Mb genome as FASTA at ``path`` (once); returns the seconds."""
    from blasr_tpu_torch.io.fasta import write_fasta

    if os.path.exists(path):
        return 0.0
    t0 = time.time()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_fasta(path + ".tmp", [(n, genome[int(a) : int(b)])
                                for n, a, b in zip(names, starts[:-1], starts[1:])])
    os.replace(path + ".tmp", path)
    return time.time() - t0


def held(name: str, recs, unmapped, want: dict) -> int:
    """Reads whose -m 4 lines differ from the reference's (or whose
    unmapped status does)."""
    from blasr_tpu_torch.output.m4 import format_m4
    from chip_smoke import m4_digests

    got = m4_digests((r.qname, format_m4(r)) for r in recs)
    diff = {n for n in set(got) | set(want["digests"]) if got.get(n) != want["digests"].get(n)}
    diff |= set(unmapped) ^ set(want["unmapped"])
    if diff:
        raise AssertionError(f"{name}: {len(diff)} reads differ from the JAX package's; "
                             f"first {sorted(diff)[:5]}")
    return len(diff)


def run(out_path: str | None, work_dir: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_sharded_smoke: torch.cuda.is_available() is False; this needs a CUDA "
              "card", file=sys.stderr)
        return 1
    import torch_big_genome_smoke as twin
    from blasr_tpu_torch.index.artifacts import build_index_from_arrays
    from blasr_tpu_torch.io.seqdb import SeqDB
    from blasr_tpu_torch.parallel import sharded
    from blasr_tpu_torch.pipeline import mapper
    from blasr_tpu_torch.pipeline.runner import run_mapping
    from blasr_tpu_torch.sim import simulate_reads

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with open(REFERENCE) as f:
        ref = json.load(f)
    with open(PLAIN_REFERENCE) as f:
        plain_ref = json.load(f)
    params = twin.big_params()
    genome, starts, names = twin.big_genome()
    seqdb = SeqDB(names, starts, ["0" * 32] * twin.N_CONTIGS)
    gpath = os.path.join(work_dir, "genome.fasta")
    fasta_s = write_genome(gpath, genome, starts, names)
    overlap = params.max_read_len + params.target_pad
    specs = sharded.make_shards(len(genome), N_SHARDS, overlap)
    build = {"fasta_s": fasta_s, "shard_s": [], "shard_file_bytes": []}
    for s, spec in enumerate(specs):
        t0 = time.time()
        path = sharded.shard_cache_path(gpath, N_SHARDS, twin.K, s, overlap)
        if not os.path.exists(path):
            sharded.build_shard_index(genome, seqdb, spec, twin.K).save(path, compress=False)
        build["shard_s"].append(time.time() - t0)
        build["shard_file_bytes"].append(os.path.getsize(path))
    t0 = time.time()
    sketches = sharded.load_or_build_sketches(genome, specs, gpath, overlap)
    build["sketches_s"] = time.time() - t0
    print(f"{N_SHARDS} shards of {specs[0].hi - specs[0].lo:,} bases (overlap {overlap}): "
          f"FASTA {fasta_s:.1f} s; shard index + cache {[round(x, 1) for x in build['shard_s']]}"
          f" s ({sum(build['shard_file_bytes']) / 1e9:.2f} GB on disk); the {N_SHARDS} "
          f"sketches {build['sketches_s']:.1f} s", flush=True)
    t0 = time.time()
    index = build_index_from_arrays(genome, seqdb, twin.K)
    build["plain_index_s"] = time.time() - t0
    t0 = time.time()
    resident = sharded.build_or_load_shards(genome, seqdb, specs, twin.K, gpath, overlap)
    build["shard_load_s"] = time.time() - t0
    t0 = time.time()
    for ix in resident:
        mapper.make_device_index(ix, params, "cuda")
    torch.cuda.synchronize()
    build["resident_tables_s"] = time.time() - t0
    print(f"plain index {build['plain_index_s']:.1f} s; the {N_SHARDS} shard caches loaded "
          f"in {build['shard_load_s']:.1f} s, their device tables built in "
          f"{build['resident_tables_s']:.1f} s", flush=True)

    kw = dict(n_shards=N_SHARDS, k=twin.K, devices=["cuda:0"], genome_path=gpath)
    cells = {}
    for mean_len in twin.MEAN_LENS:
        name = f"mean{mean_len}"
        reads, _ = simulate_reads(genome, twin.N_READS, mean_len=mean_len, seed=twin.READ_SEED)
        if twin.reads_md5(reads) != ref[name]["reads_md5"]:
            raise AssertionError(f"{name}: the reads are not the reference's")
        routes = sharded.route_reads(reads, sketches)
        visits = sum(len(rt) for rt in routes) / len(reads)
        runs = {
            "plain": lambda: run_mapping(index, reads, params, device="cuda"),
            "broadcast": lambda: sharded.run_mapping_sharded(
                genome, seqdb, reads, params, lazy_load=True, **kw),
            "routed": lambda: sharded.run_mapping_sharded(
                genome, seqdb, reads, params, lazy_load=True, route=True, **kw),
            "broadcast_resident": lambda: sharded.run_mapping_sharded(
                genome, seqdb, reads, params, shard_indexes=resident, **kw),
            "routed_resident": lambda: sharded.run_mapping_sharded(
                genome, seqdb, reads, params, shard_indexes=resident, route=True, **kw),
        }
        t0 = time.time()
        runs["plain"]()
        torch.cuda.synchronize()
        warm_s = time.time() - t0
        row = {"shard_visits_per_read": visits, "plain_warm_s": warm_s}
        for cell, fn in runs.items():
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            recs, unmapped = fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
            want = plain_ref[name] if cell == "plain" else ref[name][
                "routed" if cell.startswith("routed") else "broadcast"]
            n_diff = held(f"{name} {cell}", recs, unmapped, want)
            n_ok, _ = twin.locus_counts(recs, reads, starts)
            row[cell] = {"wall_s": wall, "reads_per_s": len(reads) / wall,
                         "peak_bytes": torch.cuda.max_memory_allocated(),
                         "records": len(recs), "unmapped": len(unmapped), "correct": n_ok,
                         "reads_differing": n_diff}
        for cell in ("broadcast", "routed", "broadcast_resident", "routed_resident"):
            row[cell]["wall_vs_plain"] = row[cell]["wall_s"] / row["plain"]["wall_s"]
        cells[name] = row
        print(f"{name}: shard visits {visits:.2f} a read; " + "; ".join(
            f"{c} {row[c]['wall_s']:.2f} s ({row[c]['reads_per_s']:.1f} reads/s"
            + (f", {row[c]['wall_vs_plain']:.2f}x plain" if c != "plain" else "")
            + f", peak {row[c]['peak_bytes'] / 2**30:.2f} GiB, correct {row[c]['correct']})"
            for c in runs) + "; 0 reads differ from the JAX package's", flush=True)
    result = {"card": smi, "torch": torch.__version__, "device": torch.cuda.get_device_name(0),
              "shards": N_SHARDS, "build": build, "cells": cells}
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the result JSON here")
    ap.add_argument("--dir", default=os.path.join(REPO, "benchdata", "big200"),
                    help="where the genome FASTA, the shard caches and sketches go")
    args = ap.parse_args()
    return run(args.out, args.dir)


if __name__ == "__main__":
    sys.exit(main())
