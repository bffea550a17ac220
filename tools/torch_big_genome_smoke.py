#!/usr/bin/env python3
"""The 200 Mb genome smoke test of the port on one GPU: the twin of
``scripts/big_genome_smoke.py``.

    python3 tools/torch_big_genome_smoke.py [--out FILE]

The same synthetic genome (200,000,000 random bases, seed 3, cut into 10
equal contigs) and k = 15, which takes the bisection index; the same 256
reads of mean length 500 and the same 256 of mean 1000 (``sim.
simulate_reads``, seed 5), at the script's parameters (B = 64,
``max_read_len`` 3072, 4 candidates, best_n 1). The index is built by the
port's ``build_index_from_arrays`` and ``make_device_index``; the
build is split into the suffix array (SA-IS), the keys (the rest of
``build_index_from_arrays``), the prefix table (``GenomeIndex.lut``) and
the run lengths (``mapper.run_lengths``), each on the host clock, then the
upload. Each read set is mapped once as a warm-up and once timed; the
timed run's -m 4 lines are held to the JAX package's
(``tools/jax_big_genome_reference.json``, ``tools/jax_big_genome_reference.py``)
read by read, no read may differ. Reports the device bytes of the four
index arrays, peak device memory over each timed run, reads/s, and the
script's own correctness figure (best record on the true strand within
100 bp of the true start, in genome coordinates). Prints the card's name
and power limit first and one JSON line last. Needs a CUDA card; it does
not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, HERE]

G = 200_000_000
N_CONTIGS = 10
GENOME_SEED = 3
K = 15
N_READS = 256
MEAN_LENS = (500, 1000)
READ_SEED = 5
REFERENCE = os.path.join(HERE, "jax_big_genome_reference.json")


def big_params():
    """``scripts/big_genome_smoke.py``'s MappingParams."""
    from blasr_tpu_torch.params import MappingParams

    return MappingParams(batch_size=64, max_read_len=3072, n_candidates=4,
                         best_n=1, min_match_length=K)


def big_genome():
    """(genome codes, contig starts, contig names) of the 200 Mb genome."""
    import numpy as np

    rng = np.random.default_rng(GENOME_SEED)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    starts = np.linspace(0, G, N_CONTIGS + 1).astype(np.int64)
    return genome, starts, [f"chr{i}" for i in range(N_CONTIGS)]


def reads_md5(reads) -> str:
    """md5 over every read's name, a newline and its code bytes."""
    h = hashlib.md5()
    for r in reads:
        h.update(r.name.encode() + b"\n" + r.codes.tobytes())
    return h.hexdigest()


def locus_counts(records, reads, starts) -> tuple[int, int]:
    """``scripts/big_genome_smoke.py``'s figures: reads whose best record is
    on the true strand within 100 bp of the true start (genome
    coordinates), and reads whose best record is on the true strand."""
    best = {}
    for r in records:
        cur = best.get(r.qname)
        if cur is None or r.score < cur.score:
            best[r.qname] = r
    n_ok = n_strand = 0
    for rd in reads:
        rec = best.get(rd.name)
        if rec is None:
            continue
        s, _e, st = (int(v) for v in rd.name.split("|")[2:5])
        if rec.tstrand == st:
            n_strand += 1
            if abs(int(starts[rec.contig_index]) + rec.tstart_fwd - s) < 100:
                n_ok += 1
    return n_ok, n_strand


def run(out_path: str | None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_big_genome_smoke: torch.cuda.is_available() is False; this needs a "
              "CUDA card", file=sys.stderr)
        return 1
    from blasr_tpu_torch.index import artifacts
    from blasr_tpu_torch.io.seqdb import SeqDB
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.pipeline import mapper
    from blasr_tpu_torch.pipeline.runner import run_mapping
    from blasr_tpu_torch.sim import simulate_reads
    from chip_smoke import m4_digests

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with open(REFERENCE) as f:
        ref = json.load(f)
    params = big_params()
    t0 = time.time()
    genome, starts, names = big_genome()
    gen_s = time.time() - t0
    seqdb = SeqDB(names, starts, ["0" * 32] * N_CONTIGS)

    # the suffix-array call of build_index_from_arrays, timed where it is made
    sa_clock = {}
    build_sa = artifacts.build_suffix_array

    def timed_sa(codes):
        t = time.time()
        out = build_sa(codes)
        sa_clock["s"] = time.time() - t
        return out

    artifacts.build_suffix_array = timed_sa
    try:
        t0 = time.time()
        index = artifacts.build_index_from_arrays(genome, seqdb, K)
        build_s = time.time() - t0
    finally:
        artifacts.build_suffix_array = build_sa
    t0 = time.time()
    lut, shift, max_steps = index.lut()
    lut_s = time.time() - t0
    t0 = time.time()
    run_len = mapper.run_lengths(index.sa_kmers)
    run_len_s = time.time() - t0
    del lut, run_len
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    di = mapper.make_device_index(index, params, "cuda")
    torch.cuda.synchronize()
    upload_s = time.time() - t0
    if di.kind != "bisect" or di.lut_meta != (shift, max_steps) or max_steps == 0:
        raise AssertionError(f"k={K} did not take the bisection index: {di.kind} {di.lut_meta}")
    array_bytes = [a.numel() * a.element_size() for a in di.arrays]
    index_peak = torch.cuda.max_memory_allocated()
    build = {"genome_s": gen_s, "sa_is_s": sa_clock["s"], "keys_s": build_s - sa_clock["s"],
             "lut_s": lut_s, "run_len_s": run_len_s, "make_device_index_s": upload_s,
             "lut_meta": [shift, max_steps], "array_bytes": array_bytes,
             "genome_pad_bytes": di.genome_pad.numel() * 4, "index_peak_bytes": index_peak}
    print(f"200 Mb index (k={K}, bisection): genome {gen_s:.1f} s, SA-IS {sa_clock['s']:.1f} s, "
          f"keys {build_s - sa_clock['s']:.1f} s, lut() {lut_s:.1f} s (shift {shift}, max_steps "
          f"{max_steps}), run lengths {run_len_s:.1f} s; make_device_index {upload_s:.1f} s "
          f"(lut() and run lengths again, upload); arrays (sa_masked, sa_kmers, lut, run_len) "
          f"{array_bytes} B = {sum(array_bytes) / 1e9:.3f} GB, packed genome "
          f"{di.genome_pad.numel() * 4 / 1e6:.1f} MB; peak {index_peak / 2**30:.2f} GiB", flush=True)

    cells = {}
    for mean_len in MEAN_LENS:
        name = f"mean{mean_len}"
        reads, _ = simulate_reads(genome, N_READS, mean_len=mean_len, seed=READ_SEED)
        want = ref[name]
        md5 = reads_md5(reads)
        if md5 != want["reads_md5"]:
            raise AssertionError(f"{name}: reads md5 {md5} != the reference's {want['reads_md5']}")
        t0 = time.time()
        run_mapping(index, reads, params, device="cuda")
        torch.cuda.synchronize()
        warm_s = time.time() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        recs, unmapped = run_mapping(index, reads, params, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        got = m4_digests((r.qname, format_m4(r)) for r in recs)
        diff = {n for n in set(got) | set(want["digests"]) if got.get(n) != want["digests"].get(n)}
        diff |= set(unmapped) ^ set(want["unmapped"])
        n_ok, n_strand = locus_counts(recs, reads, starts)
        cells[name] = {"reads": len(reads), "records": len(recs), "unmapped": len(unmapped),
                       "reads_differing": len(diff), "correct": n_ok, "strand_ok": n_strand,
                       "wall_s": wall, "warm_s": warm_s, "reads_per_s": len(reads) / wall,
                       "peak_bytes": peak}
        print(f"mean_len={mean_len}: {len(reads) / wall:.1f} reads/s ({wall:.2f} s; warm-up "
              f"{warm_s:.1f} s), correct {n_ok}/{len(reads)} strand-ok {n_strand}/{len(reads)} "
              f"unmapped {len(unmapped)} (JAX {want['correct']}/{want['strand_ok']}/"
              f"{len(want['unmapped'])}); {len(diff)} reads differ from the JAX package's "
              f"-m 4 lines; peak {peak / 2**30:.2f} GiB", flush=True)
        if diff:
            raise AssertionError(f"{name}: {len(diff)} reads differ from the JAX package's; "
                                 f"first {sorted(diff)[:5]}")
    result = {"card": smi, "torch": torch.__version__, "device": torch.cuda.get_device_name(0),
              "build": build, "cells": cells}
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the result JSON here")
    return run(ap.parse_args().out)


if __name__ == "__main__":
    sys.exit(main())
