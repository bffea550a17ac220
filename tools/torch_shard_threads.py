#!/usr/bin/env python3
"""The thread layouts of sharded mapping on one GPU, timed in one call.

    python3 tools/torch_shard_threads.py [--out FILE] [--repeats N]

The bench genome (``bench.ensure_corpus``) in 4 shards at the bench
operating point, the shard indexes built and their device tables
uploaded before any timed run, so every run finds them resident; phase
4's 256 FASTA reads, every read to every shard (broadcast). Four
layouts of the same work on cuda:0:

  * ``loop``: ``run_mapping`` on each shard's index in turn, one thread;
  * ``per_shard``: the same calls, one thread a shard (four threads), the
    layout of the JAX package's ``run_mapping_sharded(concurrent=True)``;
  * ``sharded``: ``run_mapping_sharded(devices=["cuda:0"])``, one thread
    for the one card (the port's layout);
  * ``sharded_two``: ``run_mapping_sharded(devices=["cuda:0", "cuda"])``,
    two names of the one card, so two threads with two shards each.

Each layout runs ``--repeats`` times (default 2), the order reversed on
each pass (loop, per_shard, sharded, sharded_two, then back), with its
wall and peak device memory. ``per_shard``'s -m 4 lines equal
``loop``'s shard by shard and ``sharded_two``'s equal ``sharded``'s, or
the script fails. Prints the card's name and power limit first and one
JSON line last. Needs a CUDA card; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_SHARDS = 4
N_READS = 256


def run(out_path: str | None, repeats: int) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_shard_threads: torch.cuda.is_available() is False; this needs a CUDA "
              "card", file=sys.stderr)
        return 1
    from blasr_tpu_torch import bench
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.parallel import sharded
    from blasr_tpu_torch.pipeline.mapper import make_device_index
    from blasr_tpu_torch.pipeline.runner import run_mapping

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    genome_fa, reads_fa = bench.ensure_corpus()
    index = bench.load_bench_index(genome_fa)
    reads = bench.load_reads(reads_fa)[:N_READS]
    params = bench.bench_params()
    overlap = params.max_read_len + params.target_pad
    specs = sharded.make_shards(index.genome_length, N_SHARDS, overlap)
    t0 = time.time()
    shards = sharded.build_or_load_shards(index.genome, index.seqdb, specs, index.k,
                                          genome_fa, overlap)
    build_s = time.time() - t0
    t0 = time.time()
    for s in shards:
        make_device_index(s, params, "cuda")
    torch.cuda.synchronize()
    tables_s = time.time() - t0

    def one_shard(s):
        recs, _ = run_mapping(shards[s], reads, params, device="cuda")
        return [format_m4(r) for r in recs]

    def loop():
        return [one_shard(s) for s in range(N_SHARDS)]

    def per_shard():
        with ThreadPoolExecutor(max_workers=N_SHARDS) as pool:
            return list(pool.map(one_shard, range(N_SHARDS)))

    def sharded_run(devices):
        def go():
            recs, unmapped = sharded.run_mapping_sharded(
                index.genome, index.seqdb, reads, params, n_shards=N_SHARDS, k=index.k,
                devices=devices, shard_indexes=shards)
            return [format_m4(r) for r in recs], unmapped
        return go

    layouts = {"loop": loop, "per_shard": per_shard,
               "sharded": sharded_run(["cuda:0"]),
               "sharded_two": sharded_run(["cuda:0", "cuda"])}
    t0 = time.time()
    loop()  # warm-up: every shard once
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    print(f"{N_SHARDS} shards built in {build_s:.1f} s, device tables {tables_s:.1f} s, "
          f"warm-up loop {warm_s:.2f} s", flush=True)
    walls = {name: [] for name in layouts}
    peaks = {name: 0 for name in layouts}
    lines = {}
    order = list(layouts)
    for rep in range(repeats):
        for name in order if rep % 2 == 0 else order[::-1]:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            got = layouts[name]()
            torch.cuda.synchronize()
            walls[name].append(time.time() - t0)
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
            if lines.setdefault(name, got) != got:
                raise AssertionError(f"{name}: repeat {rep} wrote other lines")
            print(f"  {name}: {walls[name][-1]:.2f} s", flush=True)
    if lines["per_shard"] != lines["loop"]:
        raise AssertionError("one thread a shard wrote other lines than the loop")
    if lines["sharded_two"] != lines["sharded"]:
        raise AssertionError("two threads wrote other lines than one")
    base = min(walls["loop"])
    result = {"card": smi, "torch": torch.__version__, "device": torch.cuda.get_device_name(0),
              "shards": N_SHARDS, "reads": len(reads), "build_s": build_s,
              "tables_s": tables_s, "warm_s": warm_s,
              "layouts": {name: {"wall_s": walls[name], "min_vs_loop": min(walls[name]) / base,
                                 "peak_bytes": peaks[name]} for name in layouts}}
    print("; ".join(f"{n} {min(walls[n]):.2f} s ({min(walls[n]) / base:.2f}x the loop, peak "
                    f"{peaks[n] / 2**30:.2f} GiB)" for n in layouts) + "; lines equal",
          flush=True)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the result JSON here")
    ap.add_argument("--repeats", type=int, default=2, help="passes over the layouts")
    args = ap.parse_args()
    return run(args.out, args.repeats)


if __name__ == "__main__":
    sys.exit(main())
