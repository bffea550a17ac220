#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (blasr_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out FILE]

Phases, each of which must pass:
  1. the card's name and power limit, torch and CUDA versions, and the
     build of the CUDA kernels and the C++ host helpers from
     blasr_tpu_torch/csrc/ (one compiler per source, all at once);
  2. the corpora under benchdata/: the 4.6 Mb simulated genome with its
     k=14 index, the 2000-read FASTA bench corpus and the 2000-read CLR
     FASTQ corpus (published PacBio CLR error model, quality values);
  3. each kernel against its plain PyTorch version on the card, bit for
     bit, at the main path's shapes: the banded DP with I = 512 items at
     W = 32, 64, 128 (L = 1024) and W = 32, 256 (L = 3328), without
     quality values on simulated read windows and in both quality modes
     (single uint8, dual uint16 with bytes >= 128) on CLR reads; its guided
     mode (per-item knots that wander off the shared line up to the clamp)
     at W = 32, 64, 128, 256 (L = 1024) and W = 128 (L = 3328) with
     single quality; its matrix mode (a negative off-diagonal) at W = 32
     and 256, L = 1024, without and with quality; the span and row gathers
     at the bench shapes (the row gather in its int4 and scalar instances)
     and the span gather at the TPU microbenchmark's shapes
     (scripts/micro_dma.py); each with its per-call time (CUDA events
     around back-to-back calls), its device time (CUDA-graph replay), its
     bound and, where one PyTorch call computes the same function, that
     call's times; each DP row names its kernel instance (W, quality,
     guided, matrix) and its device ns per anti-diagonal step; then the
     microbenchmark's span gathers once on their own, with the launch
     counts reset, for K2' launches;
  4. the FASTA bench corpus through run_mapping on the card at the bench
     operating point (a warm-up run, then one timed run with the per-stage
     clock on and every kernel launch counter reset just before it; each
     later cell maps once, so, with no warm-up, to fit the time limit),
     the timed run's -m 4 lines equal to the JAX package's read by read
     (tools/jax_m4_reference.json; with --out the card's lines are written
     beside it as m4_<corpus>.m4), then the user's CLI on 256 reads and a
     torch.profiler trace of one batch;
  5. the CLR FASTQ corpus through run_mapping (one timed run with the
     per-stage clock); accuracy within 0.01 of the JAX package's CPU
     figure and the records read by read as in phase 4; the single-quality
     DP kernel launched at W = 32 and at W >= 128 (band escalation);
  6. 256 CLR reads written as SAM with iq/sq tracks through the user's CLI:
     the same -m 4 lines as run_mapping in this process, and the
     dual-stream DP kernel launched in both; then the CLI's -sam -clipping
     hard -samqv InsertionQV SubstitutionQV -unaligned prints write_sam's
     lines for run_mapping's records (H clips, each read's iq/sq tracks, the unmapped
     reads in the -unaligned file), and the same flags to a .bam read back
     equal the text;
  7. the CLR FASTQ corpus with -useGuidedAlign on the CLI's parameters
     (one timed run with the per-stage clock): accuracy within 0.01 of the JAX
     package's CPU figure for the same flags, the records read by read,
     the guided DP kernel at W = 32 and W = 128, the walk's launches on
     one batch against the unguided walk; the CLI on 256 of those reads
     prints the lines of run_mapping;
  8. -scoreMatrix through the CLI on the 256 FASTA reads: a matrix equal
     to the default scores prints phase 4's lines, a transition-favouring
     matrix prints the lines of run_mapping and runs the matrix kernel;
  9. config 3, -bestn 2 -m 5, on the FASTA corpus (bench.config3_params:
     two alignments per read, move strings on the wire, the secondaries
     admitted on the host): one timed run with the per-stage clock;
     every -m 5 line equal to the JAX package's read by read
     (tools/jax_m5_reference.json), accuracy equal to phase 4's, the
     host seconds of the secondary admission, the walk's launches and
     device ms on one batch with and without moves; the same records as SAM
     equal to the JAX package's read by read (tools/jax_sam_reference.json
     config3_sam, secondaries with FLAG 256); then the CLI with -bestn 2
     -m 5 on phase 4's 256 reads prints run_mapping's lines;
 10. config 2, -sam -clipping soft, on the CLR FASTQ corpus
     (bench.bench_params(emit_moves=True)): one timed run of run_mapping
     with the per-stage clock plus write_sam into a StringIO; its SAM
     lines equal to the JAX package's read by read
     (tools/jax_sam_reference.json config2, the header too; with --out
     the card's text lands in sam_config2.sam), accuracy equal to phase
     5's, the single-quality DP at W = 32 and W = 256, and the lines read
     back through read_sam from SAM text and from BAM;
 11. config 4, -bwt -m 4, on the FASTA corpus (bench.config4_params: B=64,
     anchored through the FM index; the suffix-array cells' device tables
     are freed first): the FM index built from the genome (build seconds,
     the device bytes of its arrays), one timed run with the per-stage
     clock; its -m 4 lines equal to the JAX
     package's read by read (tools/jax_fm_reference.json) and accuracy
     equal to its figure; peak device memory; the FM anchors of the
     widest batch on the card equal to the CPU's, and their time on the
     card; the CLI with -bwt on phase 4's 256 reads twice (the first run
     builds and saves the bundle, the second loads it), each printing
     run_mapping's lines;
 12. seeds of k = 15 and k = 18 on the FASTA corpus (bench.k15_params,
     bench.k18_params): each index built by build_index_from_arrays (seconds,
     the device bytes of its arrays), its kind asserted (bisection at k =
     15 although direct_lut is set, wide keys at k = 18); one timed run
     with the per-stage clock; its -m 4 lines equal to
     the JAX package's read by read (tools/jax_sa_reference.json) and
     accuracy equal to its figure; peak device memory; the anchors of the
     widest batch on the card equal to the CPU's, and their time on the
     card; then the CLI on phase 4's 256 reads with -minMatch 18 -sa
     benchdata/genome.sa (written here by write_sa_file of
     reference_order_sa) prints the lines of run_mapping on
     build_index_from_sa of that file, and with -nucmer the lines of
     run_mapping on a k = 30 index at the parameters params_from_args
     gives;
 13. piecewise mapping, once per corpus with no warm-up: config 5
     (-alignContigs, bench.config5_params: two contigs of 1.2 and 0.8 Mb
     evolved from the genome, run_mapping_piecewise), its -m 4 and SAM
     lines equal to the JAX package's read by read
     (tools/jax_piecewise_reference.json) and its two whole-contig
     records; the long-read corpus (300 reads of 5-24 kb, then 100 bench
     reads) through run_mapping, which maps every read above
     max_read_len piecewise, its -m 4 lines read by read and accuracy
     within 0.01 of the JAX package's; the host seconds of stitching and
     of the secondary admission apart from the run's; then the CLI with
     -alignContigs on the 0.8 Mb contig and with -m 4 on 50 long reads,
     each printing the library's lines;
 14. the CLI's host surface: (A) one CLI process on phase 4's 256 FASTA
     reads with the read selectors, compatibility flags that change
     nothing and the four diagnostic writers (-anchors, its searches on
     the card; -fullMetrics, -clusters, -lcpBounds), each file equal to
     the JAX CLI's (tools/jax_cli_reference.json cli_host: 0 differing
     reads, the text equal); (B) -resume on the CLR FASTQ corpus, killed
     (SIGKILL) once its manifest reports 3 batches written, then run
     again to its end: the file's lines are the JAX CLI's uninterrupted
     run's (resume: none missing, none repeated, 0 differing);
 15. the optional mapping modes: (B) run_mapping in this process on phase
     4's 256 FASTA reads once per FASTA cell of MODES_CELLS (plain,
     adaptive_cd, exact_chain, -pvaltype 2 and 3) and on the modes corpus
     (256 CLR FASTQ reads and four planted reads that need the passes,
     bench.ensure_modes_corpus) plain and with the sensitive retry and the
     expand cascade, each with the stage clock, its -m 4 lines equal to
     the JAX package's read by read (tools/jax_modes_reference.json),
     adaptive_cd's also the plain cell's, the k = 14 device index shared
     by every cell; (A) one CLI process with -useSensitiveSearch -maxExpand
     2 -placeRepeatsRandomly -randomSeed 7 on the modes corpus, its lines
     the JAX CLI's; each pass meant to run (adaptive_cd's re-map, the
     sensitive retry on the modes corpus; both expand levels and the
     sensitive retry in the CLI) re-maps at least one read, and what each
     pass re-mapped and changed is printed.
The line before the last is a JSON object with each kernel's launches
(each on its own path: the single-quality DP and the gathers on config 2;
K1, K2 and K3 also on config 4's timed run, ``launches_config4``,
on phase 12's timed run, ``launches_k15`` and ``launches_k18``, and on
phase 13's runs, ``launches_config5`` and ``launches_long``; on phase
14's processes, ``launches_cli_host`` for K1 without quality, K2 and K3
and ``launches_resume`` for K1 with single quality, K2 and K3; on each
run of phase 15, ``launches_modes``, K1 without quality on the FASTA
cells and with single quality on the FASTQ ones and the CLI's),
error, times and bound; the last line is {"ok": true, "device": {...}}.
Any failure raises and the exit code is not 0. Needs one CUDA card.
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
# each DP instance at the buckets its paths give it: the narrow bands (W = 32,
# 64) up to 1536 bp and W = 32 up to 3328 at the bench point; the wide band
# W = 128 at 1024 bp and W = 256 at 2048 bp and above (params.band_width_for);
# the guided full band stays at 128 at every length. Every W of each mode
# runs at least once; bucket pairs no path launches (W = 64 or 128 at 3328,
# W = 256 at 1024 unguided, guided W = 32 at 3328) are left to the card-only
# tests (tests/test_torch_cuda.py), which hold every instance at more shapes
DP_SHAPES = [(32, 1024), (64, 1024), (128, 1024), (32, 3328), (256, 3328)]
GUIDED_DP_SHAPES = [(32, 1024), (64, 1024), (128, 1024), (256, 1024), (128, 3328)]
MATRIX_DP_SHAPES = [(32, 1024), (256, 1024)]
DP_ITEMS = 512          # B = 256 reads x 2 DP windows
MAIN_DP_SHAPE = (32, 1024)
DP_PAD2 = 128           # target_pad // 2 at the bench operating point
DP_NUM = round(65536 / 1.96)  # the ins-heavy drift of the simulated error models
# transitions (A<->G, C<->T) at -2: a negative off-diagonal, so local
# alignments can start on a mismatch
TRANSITION_MATRIX = (-5, 6, -2, 6, 0, 6, -5, 6, -2, 0, -2, 6, -5, 6, 0,
                     6, -2, 6, -5, 0, 0, 0, 0, 0, 0)
# the default scores as a matrix (match -5, mismatch 6, N 0)
DEFAULT_MATRIX = tuple(0 if i == 4 or j == 4 else (-5 if i == j else 6)
                       for i in range(5) for j in range(5))
# the span gather at the TPU microbenchmark's shapes (scripts/micro_dma.py)
MICRO_DMA_SPANS = (162, 482)
MIN_ACCURACY = 0.98     # FASTA bench corpus: the JAX package's steady state is 0.982
# accuracy_true_locus of the JAX package on the whole CLR FASTQ corpus, on
# the CPU (tools/jax_clr_accuracy.py), and the corpus it was measured on
JAX_CLR_ACCURACY = 0.966
# the same with -useGuidedAlign on CLI_FLAGS (tools/jax_guided_accuracy.py;
# 1955 records, 45 unmapped)
JAX_GUIDED_ACCURACY = 0.9655
CLR_ACCURACY_SLACK = 0.01
CLR_FASTQ_MD5 = "897fb8881c92d3fc33874e9a065602f7"
# the JAX package's -m 4 lines of each corpus, per read (tools/jax_m4_reference.py),
# and how many reads of each may differ from them on the card
M4_REFERENCE = os.path.join(HERE, "tools", "jax_m4_reference.json")
# the same for config 3's -m 5 lines on the FASTA corpus (tools/jax_m5_reference.py)
M5_REFERENCE = os.path.join(HERE, "tools", "jax_m5_reference.json")
# the same for the SAM lines of config 2 (CLR FASTQ, -sam -clipping soft) and
# of config 3 (tools/jax_sam_reference.py)
SAM_REFERENCE = os.path.join(HERE, "tools", "jax_sam_reference.json")
# the same for config 4's -m 4 lines on the FASTA corpus (tools/jax_fm_reference.py)
FM_REFERENCE = os.path.join(HERE, "tools", "jax_fm_reference.json")
# the same for seeds of k = 15 and k = 18 on the FASTA corpus (tools/jax_sa_reference.py)
SA_REFERENCE = os.path.join(HERE, "tools", "jax_sa_reference.json")
# the same for config 5's -m 4 and SAM lines and the long reads' -m 4 lines
# (tools/jax_piecewise_reference.py)
PIECEWISE_REFERENCE = os.path.join(HERE, "tools", "jax_piecewise_reference.json")
# the JAX CLI's files for phase 14 (tools/jax_cli_reference.py): command A's
# -out lines and side files on the 256 FASTA reads, and the -m 4 lines of
# the uninterrupted CLI_FLAGS run on the CLR FASTQ corpus
CLI_REFERENCE = os.path.join(HERE, "tools", "jax_cli_reference.json")
# command A (after CLI_FLAGS): the read selectors, compatibility flags that
# change nothing, and the four diagnostic writers, each given its file
CLI_HOST_SELECTORS = ["-start", "3", "-stride", "2", "-subsample", "0.8", "-randomSeed", "7"]
CLI_HOST_COMPAT = ["-nproc", "16", "-V", "1", "-affineAlign", "-noSplitSubreads",
                   "-maxLCPLength", "16", "-useQuality"]
CLI_HOST_SIDE_FILES = ("fullMetrics", "clusters", "lcpBounds", "anchors")
RESUME_KILL_AFTER = 3     # batches the manifest must report done before the kill
# the JAX package's lines for phase 15 (tools/jax_modes_reference.py): the CLI
# with the retry passes on the modes corpus, and each in-process cell on the
# first 256 FASTA reads
MODES_REFERENCE = os.path.join(HERE, "tools", "jax_modes_reference.json")
MODES_CLI_FLAGS = ["-useSensitiveSearch", "-maxExpand", "2", "-placeRepeatsRandomly",
                   "-randomSeed", "7"]
# phase 15's in-process cells: (corpus, bench_params overrides); "fasta" is
# phase 4's 256 FASTA reads (benchdata/reads_cli.fasta), "modes" the modes
# corpus of the CLI cell (bench.ensure_modes_corpus)
MODES_CELLS = {"plain": ("fasta", {}), "adaptive": ("fasta", {"adaptive_cd": True}),
               "exact_chain": ("fasta", {"exact_chain": True}),
               "pvaltype2": ("fasta", {"pval_type": 2}),
               "pvaltype3": ("fasta", {"pval_type": 3}),
               "clr_plain": ("modes", {}),
               "clr_retry": ("modes", {"sensitive_retry": True, "max_expand": 2})}
RECORD_DIFF_LIMIT = {"fasta": 0, "clr": 0, "clr_guided": 0, "config3": 0,
                     "config2": 0, "config3_sam": 0, "config4": 0, "k15": 0, "k18": 0,
                     "config5": 0, "config5_sam": 0, "long": 0,
                     **{cell: 0 for cell in MODES_CELLS}}
RECORD_FORMAT = {"fasta": "m4", "clr": "m4", "clr_guided": "m4", "config3": "m5",
                 "config4": "m4", "k15": "m4", "k18": "m4", "config5": "m4", "long": "m4",
                 **{cell: "m4" for cell in MODES_CELLS}}
# H100 SXM peaks: HBM 3.35 TB/s; INT32 ALU 132 SMs x 64 lanes x 1.98 GHz
# (Hopper architecture white paper), the rate of the DP's integer work
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations per DP cell: the elementwise operations of one cell
# of the plain version's step (ops/banded_align.py), the quality cost
# formula (clip, multiply, add, divide, max for two costs) in the quality
# modes and the byte split in the dual mode
DP_OPS_PER_CELL = {"none": 79, "single": 92, "dual": 94}
# with a score matrix: the range check, clamp, index and table read replace
# the match/mismatch/N select, and the scaled mismatch cost goes
DP_OPS_PER_CELL_MATRIX = {"none": 78, "single": 85, "dual": 86}
# per step and item in the guided mode: the knot lerp (two knot reads, two
# multiplies, an add, two shifts, a mask, a subtract, a min)
GUIDED_OPS_PER_STEP = 10
QUAL_MODES = ("none", "single", "dual")
KERNEL_META = {
    "banded_dp": ("blasr_tpu_torch/csrc/banded_dp.cu", "blasr_tpu/ops/banded_pallas.py:716"),
    "banded_dp[guided]": ("blasr_tpu_torch/csrc/banded_dp.cu",
                          "blasr_tpu/ops/banded_pallas.py:289"),
    "banded_dp[matrix]": ("blasr_tpu_torch/csrc/banded_dp.cu",
                          "blasr_tpu/ops/banded_pallas.py:555"),
    "gather_spans": ("blasr_tpu_torch/csrc/gather.cu", "blasr_tpu/ops/dma_gather.py:38"),
    "gather_spans[micro_dma]": ("blasr_tpu_torch/csrc/gather.cu", "scripts/micro_dma.py:115"),
    "gather_rows": ("blasr_tpu_torch/csrc/gather.cu", "blasr_tpu/ops/dma_gather.py:127"),
}
CLI_FLAGS = ["-m", "4", "-device", "cuda", "-minMatch", "14", "-nCandidates", "4",
             "-dpCandidates", "2", "-anchorStride", "4", "-maxAnchorsPerRead", "128",
             "-batchSize", "256", "-maxReadLen", "3328", "-bandSize", "16"]


def log(msg: str) -> None:
    print(msg, flush=True)


def m4_digests(lines) -> dict:
    """{read name: the first 16 hex digits of the sha256 of its -m 4 lines
    joined by newlines, in output order} from (read name, line) pairs."""
    by_read: dict = {}
    for name, line in lines:
        by_read.setdefault(name, []).append(line)
    return {name: hashlib.sha256("\n".join(ls).encode()).hexdigest()[:16]
            for name, ls in by_read.items()}


def sam_digests(lines) -> tuple[str, dict]:
    """(the first 16 hex digits of the sha256 of the @HD, @RG and @SQ lines
    joined by newlines, ``m4_digests`` of the alignment lines keyed by
    QNAME) of SAM text lines. @PG is left out: its CL is the command
    line."""
    header = [ln for ln in lines if ln.startswith("@") and not ln.startswith("@PG")]
    body = [(ln.split("\t", 1)[0], ln) for ln in lines if ln and not ln.startswith("@")]
    return hashlib.sha256("\n".join(header).encode()).hexdigest()[:16], m4_digests(body)


def sam_flag_count(lines, flag: int) -> int:
    """Alignment lines of SAM text whose FLAG has every bit of ``flag``."""
    return sum(1 for ln in lines if ln and not ln.startswith("@")
               and int(ln.split("\t", 2)[1]) & flag == flag)


def n_secondaries(records) -> int:
    """Records beyond the first of their read: at best_n 2, the rank-1
    records emitted (a read's records come from distinct ranks)."""
    return len(records) - len({r.qname for r in records})


def text_digests(lines, names=None) -> dict:
    """A text file's lines as the JAX reference keeps them: their count,
    the sha256 of the lines in order and sorted, and with ``names`` (each
    line's read name) ``m4_digests`` of the lines by read."""
    out = {"lines": len(lines),
           "sha256": hashlib.sha256("".join(ln + "\n" for ln in lines).encode()).hexdigest(),
           "sha256_sorted": sorted_sha256(lines)}
    if names is not None:
        out["digests"] = m4_digests(zip(names, lines))
    return out


def side_file_names(kind: str, lines, selected) -> list | None:
    """The read name of each line of a phase-14 file: an -m 4 line's qname
    less its /0_<len> suffix, the first field of an -anchors line and of a
    -fullMetrics row (its header row under "Read"), the read of each pair
    of -lcpBounds lines (forward, then reverse complement, in read order);
    None for -clusters, whose rows name no read."""
    if kind == "out":
        return [ln.split()[0].rpartition("/")[0] for ln in lines]
    if kind in ("anchors", "fullMetrics"):
        return [ln.split()[0] for ln in lines]
    if kind == "lcpBounds":
        return [selected[i // 2] for i in range(len(lines))]
    return None


def sorted_sha256(lines) -> str:
    """sha256 of all -m 4 lines sorted, one per line."""
    return hashlib.sha256("".join(line + "\n" for line in sorted(lines)).encode()).hexdigest()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Per-call time of ``fn``: CUDA events around ``reps`` calls made back
    to back. A call that costs the host more than the device is timed at
    the host's pace; ``graph_ms`` gives the device's time alone."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int, rounds: int = 1) -> float:
    """Device time of ``fn`` per call: CUDA events around one replay of a
    CUDA graph that holds ``reps`` calls, the median over ``rounds``
    replays. The host's launch work is done at capture, so a replay times
    the device alone, the gaps between its kernels included. Each wrapper
    launches onto PyTorch's current stream, which is the capturing
    stream."""
    import statistics

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the default stream, as capture asks
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(rounds):
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        means.append(e0.elapsed_time(e1) / reps)
    del graph
    return statistics.median(means)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least time in ms, what binds it) from the bytes moved and the
    integer operations done."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dp_bound(I: int, L: int, T: int, W: int, mode: str, traceback: bool = True,
             guided: bool = False, matrix: bool = False):
    S = L + T - 1
    qual_bytes = {"none": 0, "single": 1, "dual": 2}[mode] * I * L
    from blasr_tpu_torch.ops.banded_align import n_knots

    sched_bytes = 4 * I * n_knots(S) if guided else 4 * S
    n_bytes = I * L + I * T + 3 * 4 * I + sched_bytes + qual_bytes + 3 * 4 * I
    if traceback:
        n_bytes += 2 * S * I * W
    per_cell = (DP_OPS_PER_CELL_MATRIX if matrix else DP_OPS_PER_CELL)[mode]
    n_ops = per_cell * S * I * W + (GUIDED_OPS_PER_STEP * S * I if guided else 0)
    return bound(n_bytes, n_ops)



def dp_inputs(windows, W: int, L: int, mode: str):
    """The DP call's tensors on the card for one bucket: reads at their true
    loci, the drift-slope band schedule, and the quality stream of
    ``mode`` (dual: sq = the read's phred, iq = 9x it mod 256, so the high
    byte is >= 128 wherever the phred is 15 or more, about a tenth of the
    cells; every 7th cell's low byte at 255)."""
    import numpy as np
    import torch

    from blasr_tpu_torch.ops.banded_align import make_qoff_num

    Q, qlen, Tg, qual = windows
    T = Tg.shape[1]
    dev = torch.device("cuda")
    args = [
        torch.from_numpy(Q).to(dev),
        torch.from_numpy(qlen).to(dev),
        torch.from_numpy(Tg).to(dev),
        torch.zeros(DP_ITEMS, dtype=torch.int32, device=dev),
        torch.full((DP_ITEMS,), T, dtype=torch.int32, device=dev),
        make_qoff_num(L, T, W, DP_PAD2, DP_NUM, device=dev),
    ]
    if mode == "single":
        args.append(torch.from_numpy(qual).to(dev))
    elif mode == "dual":
        sq = qual.astype(np.uint16)
        sq.reshape(-1)[::7] = 255
        iq = (qual.astype(np.uint16) * 9) % 256
        if not (iq >= 128).any():
            raise AssertionError("the dual stream's high byte never reaches 128")
        args.append(torch.from_numpy((sq | (iq << 8)).view(np.int16)).to(dev))
    return args


def dp_windows(genome, clr_reads, L: int, seed: int) -> dict:
    """Simulated read windows (quality-free DP) and CLR read windows (the
    quality modes) of one bucket at their true loci."""
    from blasr_tpu_torch import bench

    plain = bench.simulated_windows(genome, DP_ITEMS, L, pad2=DP_PAD2, seed=seed)
    return {"none": (*plain, None),
            "clr": bench.true_locus_windows(genome, clr_reads[:DP_ITEMS], L, pad2=DP_PAD2)}


def compare_dp(args, W: int, L: int, mode: str, kind: str, knots=None, scores=None) -> dict:
    """One DP shape: the kernel against the plain version on the same
    inputs (max_abs_err over score, best_a, best_w and the arrow words),
    the kernel's CUDA-event time, the plain version's time and the bound."""
    import torch

    from blasr_tpu_torch.ops.banded_align import (
        AlignScores, banded_align_plain, qoff_from_knots,
    )
    from blasr_tpu_torch.ops.banded_cuda import banded_align

    scores = scores or AlignScores()
    T = args[2].shape[1]
    S = L + T - 1
    kargs = list(args)
    if knots is not None:
        kargs[5] = None
    got = banded_align(*kargs, knots=knots, scores=scores, with_traceback=True, band_width=W)
    torch.cuda.synchronize()
    pargs = list(args)
    if knots is not None:
        pargs[5] = qoff_from_knots(knots, S)
    t0 = time.perf_counter()
    ref = banded_align_plain(*pargs, scores=scores, with_traceback=True, band_width=W)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = 0
    for a, b in zip(got[:3], ref[:3]):
        err = max(err, int((a.long() - b.long()).abs().max()))
    ga = got.arrows.view(torch.int16).to(torch.int32) & 0xFFFF
    ra = ref.arrows.view(torch.int16).to(torch.int32) & 0xFFFF
    err = max(err, int((ga - ra).abs().max()))
    n_aligned = int((ref.score < 0).sum())
    del ga, ra, ref, got
    def call():
        banded_align(*kargs, knots=knots, scores=scores, with_traceback=True, band_width=W)

    ms = cuda_ms(call, reps=3)
    dev_ms = graph_ms(call, reps=3)
    b_ms, b_by = dp_bound(DP_ITEMS, L, T, W, mode, guided=knots is not None,
                          matrix=scores.matrix is not None)
    instance = (f"banded_dp_kernel<W={W}, quality={mode}, guided={knots is not None}, "
                f"matrix={scores.matrix is not None}>")
    row = {"W": W, "L": L, "I": DP_ITEMS, "S": S, "mode": mode, "kind": kind,
           "instance": instance, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
           "ns_per_step": dev_ms * 1e6 / S, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "items_aligned": n_aligned}
    log(f"dp[{kind}] {instance} L={L} I={DP_ITEMS}: max_abs_err={err} kernel "
        f"{ms:.3f} ms (device {dev_ms:.3f} ms, {row['ns_per_step']:.1f} ns per step of {S}) "
        f"plain {plain_ms:.1f} ms bound {b_ms:.4f} ms ({b_by}); {n_aligned} items aligned")
    if err != 0:
        raise AssertionError(
            f"banded_dp[{kind}] kernel disagrees with the plain version at W={W} L={L} "
            f"quality {mode}")
    if n_aligned < DP_ITEMS // 2:
        raise AssertionError(
            f"only {n_aligned}/{DP_ITEMS} windows aligned at W={W} L={L} quality {mode} ({kind})")
    return row


def check_dp(windows) -> list:
    """The DP kernel against its plain version at each (W, L) of
    DP_SHAPES, without quality values and in both quality modes."""
    rows = []
    for W, L in DP_SHAPES:
        for mode in QUAL_MODES:
            args = dp_inputs(windows[L]["none" if mode == "none" else "clr"], W, L, mode)
            rows.append(compare_dp(args, W, L, mode, "shared"))
    return rows


def check_dp_guided(windows) -> list:
    """The guided mode with single quality on CLR windows: per-item knots
    that wander off the shared line as far as the reference's clamp."""
    import torch

    from blasr_tpu_torch import bench
    from blasr_tpu_torch.ops.banded_align import KNOT_SPACING, guided_max_dev

    rows = []
    for W, L in GUIDED_DP_SHAPES:
        args = dp_inputs(windows[L]["clr"], W, L, "single")
        T = args[2].shape[1]
        knots = bench.deviating_knots(DP_ITEMS, L, T, W, DP_PAD2, DP_NUM, seed=W + L,
                                      device="cuda")
        at = torch.clamp(torch.arange(knots.shape[1], device="cuda") * KNOT_SPACING,
                         max=L + T - 2)
        dev_max = int((knots - args[5][at][None, :]).abs().max())
        if not guided_max_dev(W) // 2 <= dev_max <= guided_max_dev(W):
            raise AssertionError(f"guided knots reach {dev_max}, the clamp is {guided_max_dev(W)}")
        row = compare_dp(args, W, L, "single", "guided", knots=knots)
        row["knot_max_deviation"] = dev_max
        rows.append(row)
    return rows


def check_dp_matrix(windows) -> list:
    """The matrix mode (TRANSITION_MATRIX) without and with quality."""
    from blasr_tpu_torch.ops.banded_align import AlignScores

    rows = []
    for W, L in MATRIX_DP_SHAPES:
        for mode in ("none", "single"):
            args = dp_inputs(windows[L]["none" if mode == "none" else "clr"], W, L, mode)
            rows.append(compare_dp(args, W, L, mode, "matrix",
                                   scores=AlignScores(matrix=TRANSITION_MATRIX)))
    return rows


def misaligned(t):
    """A copy of ``t`` whose base address is 4 bytes past a 16-byte
    boundary: the row gather takes its scalar instance on it."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


GATHER_REPS, GATHER_ROUNDS = 100, 11  # calls per timed run, runs per median


def interleaved_times(fns: dict, device: tuple = ()) -> dict:
    """Per-call ms (CUDA events) and host us per call (the host's clock
    around the same calls, issued without a synchronisation) of each
    function of ``fns`` ({key prefix: function}), over GATHER_REPS calls
    back to back, their runs taken in turns GATHER_ROUNDS times so that a
    change in the host's pace falls on all of them alike; the median of
    each. For the prefixes in ``device`` also the device ms (``graph_ms``).
    Keys: prefix + "ms", "host_us", "device_ms"."""
    import statistics

    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    ms = {k: [] for k in fns}
    us = {k: [] for k in fns}
    for _ in range(GATHER_ROUNDS):
        for k, fn in fns.items():
            e0.record()
            t0 = time.perf_counter()
            for _ in range(GATHER_REPS):
                fn()
            t1 = time.perf_counter()
            e1.record()
            torch.cuda.synchronize()
            ms[k].append(e0.elapsed_time(e1) / GATHER_REPS)
            us[k].append((t1 - t0) / GATHER_REPS * 1e6)
    out = {}
    for k in fns:
        out[k + "ms"] = statistics.median(ms[k])
        out[k + "host_us"] = statistics.median(us[k])
        if k in device:
            out[k + "device_ms"] = graph_ms(fns[k], GATHER_REPS, rounds=5)
    return out


def compare_gather(label: str, calls: dict, shape: dict, n_bytes: int) -> dict:
    """One gather shape. ``calls`` holds the kernel's call (""), the plain
    version ("plain_"), the one PyTorch call ("library_") and, for the row
    gather, its scalar instance ("scalar_"): all give the same words, and
    each is timed (``interleaved_times``; device ms of all but the plain
    version) beside the byte bound."""
    ref = calls["plain_"]().long()
    err = max(int((fn().long() - ref).abs().max()) for k, fn in calls.items() if k != "plain_")
    b_ms, b_by = bound(n_bytes, 0)
    row = {**shape, "max_abs_err": err,
           **interleaved_times(calls, device=tuple(k for k in calls if k != "plain_")),
           "bound_ms": b_ms, "bound_by": b_by}
    scalar = (f"; scalar instance {row['scalar_ms']:.4f}, device {row['scalar_device_ms']:.4f}"
              if "scalar_" in calls else "")
    log(f"{label} " + " ".join(f"{k}={v}" for k, v in shape.items())
        + f": max_abs_err={err} kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}"
        f"{scalar}) plain {row['plain_ms']:.4f} ms PyTorch call {row['library_ms']:.4f} ms "
        f"(device {row['library_device_ms']:.4f}) bound {row['bound_ms']:.5f} ms; host us per "
        f"call {row['host_us']:.2f} (PyTorch call {row['library_host_us']:.2f})")
    if err != 0:
        raise AssertionError(f"{label} disagrees with its plain version at {shape}")
    return row


def span_case(src, starts, span: int, label: str) -> dict:
    """K2 at one shape, the PyTorch call an advanced index on a
    precomputed clipped index."""
    import torch

    from blasr_tpu_torch.ops.gather import gather_spans, gather_spans_plain

    N, I = src.shape[0], starts.shape[0]
    idx = torch.clamp(starts.long()[:, None] + torch.arange(span, device=src.device)[None, :],
                      0, N - 1)
    calls = {"": lambda: gather_spans(src, starts, span),
             "plain_": lambda: gather_spans_plain(src, starts, span),
             "library_": lambda: src[idx]}
    return compare_gather(label, calls, {"N": N, "I": I, "span": span}, 2 * 4 * I * span + 4 * I)


def micro_dma_path() -> int:
    """K2' on its own path, the microbenchmark's: one span gather at each
    of its spans, with the launch counts set to 0 just before and read just
    after; the launches of K2's kernel in that run."""
    import torch

    from blasr_tpu_torch import bench
    from blasr_tpu_torch.ops import launch_counts, reset_launch_counts
    from blasr_tpu_torch.ops.gather import gather_spans

    inputs = [(bench.span_gather_inputs(span, device="cuda"), span) for span in MICRO_DMA_SPANS]
    torch.cuda.synchronize()
    reset_launch_counts()
    for (src, starts), span in inputs:
        gather_spans(src, starts, span)
    torch.cuda.synchronize()
    return launch_counts()["gather_spans"]


def check_micro_dma() -> list:
    """K2' (scripts/micro_dma.py:dma_span_gather): the span gather at the
    TPU microbenchmark's own shapes through K2's kernel, against the plain
    version and one advanced-index call."""
    from blasr_tpu_torch import bench

    return [span_case(*bench.span_gather_inputs(span, device="cuda"), span,
                      "K2' span gather (micro_dma shapes)") for span in MICRO_DMA_SPANS]


def check_gathers(genome_pad) -> dict:
    """K2 on the device genome words at the DP buckets' spans, starts with
    clipped element indices at both ends; K3 on the fused anchor rows and
    the packed query rows' widths, rows clipped at both ends, the PyTorch
    call ``index_select`` on the clipped rows, the row gather in both its
    instances (the scalar one on a misaligned copy); each against its plain
    version."""
    import numpy as np
    import torch

    from blasr_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    dev = genome_pad.device
    rng = np.random.default_rng(5)
    N = genome_pad.shape[0]
    out = {"gather_spans": [], "gather_rows": []}
    for L in (1024, 3328):
        span = (L + 256) // 8 + 2
        starts = rng.integers(0, N - span, DP_ITEMS).astype(np.int32)
        starts[:4] = [-3, -span - 7, N - 1, N + 40]   # clipped element indices
        out["gather_spans"].append(span_case(genome_pad, torch.from_numpy(starts).to(dev), span,
                                             "gather_spans"))
    # fused anchor rows (2B, 2A) and packed query rows (2B, L/8)
    for R, Lr in ((512, 256), (512, 1024 // 8), (512, 3328 // 8)):
        src = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (R, Lr)).astype(np.int32)).to(dev)
        src1 = misaligned(src)
        rows_np = rng.integers(0, R, DP_ITEMS).astype(np.int32)
        rows_np[:2] = [-1, R + 3]                      # clipped rows
        rows = torch.from_numpy(rows_np).to(dev)
        rows_c = torch.clamp(rows.long(), 0, R - 1)
        calls = {"": lambda: gather_rows(src, rows),
                 "scalar_": lambda: gather_rows(src1, rows),
                 "plain_": lambda: gather_rows_plain(src, rows),
                 "library_": lambda: torch.index_select(src, 0, rows_c)}
        before = dict(gather_rows.launches_by_path)
        out["gather_rows"].append(compare_gather(
            "gather_rows", calls, {"I": DP_ITEMS, "R": R, "Lr": Lr},
            2 * 4 * DP_ITEMS * Lr + 4 * DP_ITEMS))
        if gather_rows.launches_by_path[1] - before[1] < 1 or (
                gather_rows.launches_by_path[4] - before[4] < 1):
            raise AssertionError(f"gather_rows did not take its int4 and scalar instances: "
                                 f"{before} -> {gather_rows.launches_by_path}")
    return out


def run_cli(reads_path: str, genome_fa: str, tag: str, extra=(), ext: str = "m4"
            ) -> tuple[list, dict, float]:
    """The user's command line on the card with CLI_FLAGS and ``extra``, in
    its own process, writing ``<tag>.<ext>``: (its lines, a BAM file's as
    SAM text read back through ``io/bam.read_bam``; its metrics JSON;
    seconds with the process start)."""
    from blasr_tpu_torch.bench import BENCH_DIR
    from blasr_tpu_torch.io.bam import read_bam

    out_path = os.path.join(BENCH_DIR, f"{tag}.{ext}")
    out_metrics = os.path.join(BENCH_DIR, f"{tag}.metrics.json")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "blasr_tpu_torch.cli.blasr", reads_path, genome_fa,
         *CLI_FLAGS, *extra, "-out", out_path, "-metrics", out_metrics],
        cwd=HERE, capture_output=True, text=True, timeout=600,
    )
    seconds = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"CLI failed ({proc.returncode}): {proc.stderr[-2000:]}")
    if ext == "bam":
        header, recs = read_bam(out_path)
        lines = header + ["\t".join(r) for r in recs]
    else:
        with open(out_path) as f:
            lines = f.read().splitlines()
    with open(out_metrics) as f:
        metrics = json.load(f)
    return lines, metrics, seconds


def cli_params(reads_path: str, genome_fa: str, extra=()):
    from blasr_tpu_torch.cli.blasr import build_parser, params_from_args

    return params_from_args(
        build_parser().parse_args([reads_path, genome_fa, *CLI_FLAGS, *extra]))


def check_cli(genome_fa: str, reads, index) -> dict:
    """The CLI on 256 FASTA reads must print the records that run_mapping
    gives in this process for the same flags. The CLI keeps the
    reference's narrow_band_max of 1536, so reads above it take the
    W = 128/256 band."""
    import torch

    from blasr_tpu_torch.bench import BENCH_DIR, write_reads
    from blasr_tpu_torch.ops.banded_cuda import banded_align
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.pipeline.runner import run_mapping

    sub = reads[:256]
    reads_fa = os.path.join(BENCH_DIR, "reads_cli.fasta")
    write_reads(reads_fa, sub)
    cli_lines, _, cli_s = run_cli(reads_fa, genome_fa, "reads_cli")
    by_shape = banded_align.launches_by_shape

    def wide():
        return sum(by_shape[(w, "none")] for w in (128, 256))

    w0 = wide()
    recs, _ = run_mapping(index, sub, cli_params(reads_fa, genome_fa), device="cuda")
    n_wide = wide() - w0
    torch.cuda.synchronize()
    if cli_lines != [format_m4(r) for r in recs]:
        raise AssertionError("CLI output differs from run_mapping on the same reads")
    log(f"CLI on the card: {len(sub)} FASTA reads -> {len(cli_lines)} m4 lines in {cli_s:.1f} s "
        f"(process included), equal to run_mapping; DP kernel W>=128 launches {n_wide}")
    return {"reads": len(sub), "lines": len(cli_lines), "seconds": cli_s,
            "dp_wide_launches": n_wide, "path": reads_fa, "m4": cli_lines}


def write_sam_with_qvs(path: str, reads) -> None:
    """The reads as unaligned SAM records with iq/sq tracks: sq is the
    read's phred, iq 4 lower (at least 4); odd reads are stored reverse
    complemented with FLAG 16 and their tracks reversed; every eighth read
    carries no iq track (a mixed dual batch)."""
    import numpy as np

    from blasr_tpu_torch.core.encode import codes_to_seq, revcomp_codes

    def phred(a):
        return (np.asarray(a, np.uint8) + 33).tobytes().decode()

    with open(path, "w") as f:
        f.write("@HD\tVN:1.5\tSO:unknown\n")
        for i, r in enumerate(reads):
            codes, sq = r.codes, r.qual
            iq = np.maximum(sq.astype(np.int16) - 4, 4).astype(np.uint8)
            flag = 4
            if i % 2:
                codes, sq, iq, flag = revcomp_codes(codes), sq[::-1], iq[::-1], 20
            tags = [f"sq:Z:{phred(sq)}"]
            if i % 8 != 3:
                tags.append(f"iq:Z:{phred(iq)}")
            f.write("\t".join([r.name, str(flag), "*", "0", "0", "*", "*", "0", "0",
                               codes_to_seq(codes), phred(sq), *tags]) + "\n")


def check_cli_sam(genome_fa: str, clr_reads, index) -> dict:
    """256 CLR reads as SAM with iq/sq tracks: the reader restores each
    read's orientation, the CLI prints the same -m 4 lines as run_mapping
    in this process, and both launch the dual-stream DP kernel."""
    import numpy as np
    import torch

    from blasr_tpu_torch.bench import BENCH_DIR
    from blasr_tpu_torch.io.batching import read_records
    from blasr_tpu_torch.ops import dp_launch_counts, launch_counts, reset_launch_counts
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.pipeline.runner import run_mapping

    sub = clr_reads[:256]
    sam = os.path.join(BENCH_DIR, "reads_clr_cli.sam")
    write_sam_with_qvs(sam, sub)
    back = read_records(sam)
    if [r.name for r in back] != [r.name for r in sub] or not all(
            np.array_equal(a.codes, b.codes) and np.array_equal(a.qvs["sq"], b.qual)
            for a, b in zip(back, sub)):
        raise AssertionError("SAM reads do not come back in their original orientation")
    cli_lines, cli_metrics, cli_s = run_cli(sam, genome_fa, "reads_clr_cli")
    reset_launch_counts()
    recs, _ = run_mapping(index, back, cli_params(sam, genome_fa), device="cuda")
    torch.cuda.synchronize()
    counts, by_shape = launch_counts(), dp_launch_counts()
    if cli_lines != [format_m4(r) for r in recs]:
        raise AssertionError("CLI output on the SAM reads differs from run_mapping")
    dual_here = sum(n for k, n in by_shape.items() if k.endswith("/dual"))
    dual_cli = sum(n for k, n in cli_metrics["dpLaunches"].items() if k.endswith("/dual"))
    if dual_here == 0 or dual_cli == 0:
        raise AssertionError(f"dual-stream DP kernel not launched: here {by_shape}, "
                             f"CLI {cli_metrics['dpLaunches']}")
    log(f"CLI on the card: {len(sub)} SAM reads with iq/sq -> {len(cli_lines)} m4 lines in "
        f"{cli_s:.1f} s (process included), equal to run_mapping; DP launches in the CLI "
        f"{cli_metrics['dpLaunches']}, in run_mapping {by_shape}")
    out = {"reads": len(sub), "lines": len(cli_lines), "seconds": cli_s,
           "cli_dp_launches": cli_metrics["dpLaunches"], "dp_launches": by_shape,
           "launches": counts}
    out["sam_output"] = check_cli_sam_output(sam, genome_fa, back, index)
    return out


def check_cli_sam_output(sam: str, genome_fa: str, reads, index) -> dict:
    """The CLI's SAM output on phase 6's reads: -sam -clipping hard with two
    of the reads' QV tracks and -unaligned prints write_sam's lines for
    run_mapping's records in this process (@PG aside: its CL is the command
    line), hard clips, on every mapped line the tracks its read has (every
    eighth read has no iq) and the unmapped reads in the -unaligned file;
    the same flags to a .bam read back equal the text."""
    import io

    import torch

    from blasr_tpu_torch.bench import BENCH_DIR
    from blasr_tpu_torch.output.sam_writer import write_sam
    from blasr_tpu_torch.pipeline.runner import run_mapping

    flags = ["-sam", "-clipping", "hard", "-samqv", "InsertionQV", "SubstitutionQV"]
    unaligned = os.path.join(BENCH_DIR, "reads_clr_cli.unaligned.fa")
    lines, _, sam_s = run_cli(sam, genome_fa, "reads_clr_cli_sam",
                              [*flags, "-unaligned", unaligned], ext="sam")
    bam_lines, _, bam_s = run_cli(sam, genome_fa, "reads_clr_cli_sam", flags, ext="bam")
    params = cli_params(sam, genome_fa, flags)
    if not params.emit_moves or params.samqv != ("iq", "sq"):
        raise AssertionError(f"-sam -samqv parsed as emit_moves {params.emit_moves}, "
                             f"samqv {params.samqv}")
    recs, unmapped = run_mapping(index, reads, params, device="cuda")
    torch.cuda.synchronize()
    buf = io.StringIO()
    write_sam(recs, reads, index.seqdb, buf, clipping="hard", unmapped=unmapped,
              movie_name=os.path.basename(sam), genome=index.genome, samqv=params.samqv)

    def no_pg(text_lines):
        return [ln for ln in text_lines if not ln.startswith("@PG")]

    want = no_pg(buf.getvalue().splitlines())
    if no_pg(lines) != want:
        raise AssertionError(f"CLI -sam output differs from write_sam of run_mapping: "
                             f"{sum(a != b for a, b in zip(no_pg(lines), want))} of {len(want)} "
                             f"lines, {len(no_pg(lines))} printed")
    if no_pg(bam_lines) != want:
        raise AssertionError("the CLI's BAM, read back, differs from its SAM text")
    mapped = [ln.split("\t") for ln in want if not ln.startswith("@") and "\tAS:i:" in ln]
    by_name = {r.name: r for r in reads}
    tracks = [tuple(t[:3] for t in f[11:] if t[:3] in ("iq:", "sq:")) for f in mapped]
    want_tracks = [tuple(t + ":" for t in ("iq", "sq") if t in by_name[f[0].rsplit("/", 1)[0]].qvs)
                   for f in mapped]
    if not any("H" in f[5] for f in mapped) or tracks != want_tracks:
        raise AssertionError("no H clip in the hard-clipped SAM lines, or a line without the "
                             "iq/sq tracks its read has")
    with open(unaligned) as f:
        unal = [ln[1:] for ln in f.read().splitlines() if ln.startswith(">")]
    if unal != [r.name for r in reads if r.name in set(unmapped)] or not unal:
        raise AssertionError(f"-unaligned wrote {len(unal)} reads, {len(unmapped)} unmapped")
    log(f"CLI -sam -clipping hard -samqv InsertionQV SubstitutionQV -unaligned on the card: "
        f"{len(mapped)} mapped lines with the iq/sq tracks of their reads "
        f"({sum(len(t) == 2 for t in tracks)} with both), {sum('H' in f[5] for f in mapped)} "
        f"with H clips, {len(unal)} unaligned, "
        f"equal to write_sam of run_mapping ({sam_s:.1f} s, process included); to BAM read "
        f"back equal ({bam_s:.1f} s)")
    return {"lines": len(want) - sum(ln.startswith("@") for ln in want), "mapped": len(mapped),
            "unaligned": len(unal), "seconds": sam_s, "bam_seconds": bam_s}


def map_corpus(index, reads, params, warmup: bool = False, formatter=None,
               sam_movie: str | None = None, fm=None) -> dict:
    """One warm-up run when ``warmup`` is set, then one timed run with the
    per-stage clock on (it synchronises after every stage) and every launch
    counter reset just before it, read just after it. The run's records
    are kept as lines, -m 4 unless ``formatter`` (record -> line) says
    otherwise. With ``sam_movie`` the run also writes its records with
    ``write_sam`` (soft clipping, the genome, that movie name) into a
    StringIO, timed in the same window after the mapping's own wall
    (``sam_walls_s``, the write alone ``sam_write_s``), and keeps the SAM
    text's lines. ``fm`` anchors every run through that FM index."""
    import io

    import torch

    from blasr_tpu_torch import bench
    from blasr_tpu_torch.ops import dp_launch_counts, launch_counts, reset_launch_counts
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.output.sam_writer import write_sam
    from blasr_tpu_torch.pipeline.mapper import StageClock
    from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping

    formatter = formatter or format_m4
    warm_s = 0.0
    if warmup:
        t0 = time.time()
        run_mapping(index, reads, params, device="cuda", fm=fm)
        torch.cuda.synchronize()
        warm_s = time.time() - t0
    met = MappingMetrics()
    clock = StageClock(torch.device("cuda"))
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    records, unmapped = run_mapping(index, reads, params, device="cuda", metrics=met,
                                    clock=clock, fm=fm)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts, by_shape = launch_counts(), dp_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    out = {}
    if sam_movie is not None:
        t1 = time.time()
        buf = io.StringIO()
        write_sam(records, reads, index.seqdb, buf, clipping="soft", unmapped=unmapped,
                  movie_name=sam_movie, genome=index.genome)
        torch.cuda.synchronize()
        t2 = time.time()
        out = {"sam_walls_s": [t2 - t0], "sam_write_s": [t2 - t1],
               "sam_runs": [buf.getvalue().splitlines()],
               "reads_per_s_with_sam": [len(reads) / (t2 - t0)]}
    stage = dict(clock.seconds)
    total_stage = sum(stage.values())
    acc = bench.accuracy_true_locus(records, reads)
    log(f"  {len(reads)} reads: {len(reads) / wall:.1f} reads/s in the timed run (stage clock "
        f"on; " + (f"warm-up run {warm_s:.1f} s" if warmup else "no warm-up run")
        + f"); records {len(records)} ({n_secondaries(records)} beyond the first of their "
        f"read), unmapped {len(unmapped)}, escalated {met.escalated_reads}; "
        f"accuracy_true_locus {acc:.4f}")
    log(f"  host split: dispatch {met.dispatch_seconds:.3f} s wait {met.wait_seconds:.3f} s "
        f"finalize {met.finalize_seconds:.3f} s; batches {met.n_batches}; buckets {met.buckets}")
    log(f"  peak torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"  stage clock ({wall:.2f} s run): " + ", ".join(
        f"{k} {v:.3f} s ({100 * v / max(total_stage, 1e-9):.1f}%)" for k, v in stage.items()))
    log(f"  kernel launches in the timed run: {counts}; DP by shape {by_shape}")
    if sam_movie is not None:
        log(f"  with write_sam: {out['reads_per_s_with_sam'][0]:.1f} reads/s; SAM write alone "
            f"{out['sam_write_s'][0]:.3f} s")
    return {**out, "reads": len(reads), "walls_s": [wall], "warm_s": warm_s,
            "reads_per_s": [len(reads) / wall], "accuracy_true_locus": acc,
            "records": len(records), "secondaries": n_secondaries(records),
            "unmapped": len(unmapped),
            "escalated": met.escalated_reads, "metrics": met.to_dict(),
            "stage_seconds": stage, "peak_bytes": peak,
            "launches": counts, "dp_launches": by_shape,
            "line_runs": [([(r.qname, formatter(r)) for r in records], unmapped)]}


def load_references() -> dict:
    """The JAX package's per-read digests: -m 4 on the three corpora
    (tools/jax_m4_reference.py), config 3's -m 5 on the FASTA corpus
    (tools/jax_m5_reference.py), the SAM lines of configs 2 and 3
    (tools/jax_sam_reference.py), config 4's -m 4 on the FASTA corpus
    (tools/jax_fm_reference.py), -m 4 with seeds of k = 15 and 18
    (tools/jax_sa_reference.py), config 5's and the long reads' lines
    (tools/jax_piecewise_reference.py), phase 14's CLI files
    (tools/jax_cli_reference.py) and phase 15's lines
    (tools/jax_modes_reference.py), all written on the CPU."""
    refs = {}
    for path in (M4_REFERENCE, M5_REFERENCE, SAM_REFERENCE, FM_REFERENCE, SA_REFERENCE,
                 PIECEWISE_REFERENCE, CLI_REFERENCE, MODES_REFERENCE):
        with open(path) as f:
            refs.update(json.load(f))
    return refs


def check_records(corpus: str, res: dict, ref: dict, reads_path: str, out_dir) -> dict:
    """Every timed run's lines (-m 4, or -m 5 for config 3) against the JAX
    package's, read by read: a read differs when the digest of its lines
    differs, when only one side has lines for it, or when only one side
    reports it unmapped. Writes the first timed run's lines to
    <out_dir>/<fmt>_<corpus>.<fmt> when ``out_dir`` is given. Fails above
    RECORD_DIFF_LIMIT[corpus]."""
    ref = ref[corpus]
    fmt = RECORD_FORMAT[corpus]
    with open(reads_path, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    if md5 != ref["reads_md5"]:
        raise AssertionError(f"{corpus}: reads md5 {md5} != the reference's {ref['reads_md5']}")
    runs = res.pop("line_runs")
    if out_dir:
        with open(os.path.join(out_dir, f"{fmt}_{corpus}.{fmt}"), "w") as f:
            f.writelines(line + "\n" for _, line in runs[0][0])
    counts = []
    for k, (lines, unmapped) in enumerate(runs):
        got = m4_digests(lines)
        names = set(got) | set(ref["digests"])
        diff = {n for n in names if got.get(n) != ref["digests"].get(n)}
        diff |= set(unmapped) ^ set(ref["unmapped"])
        same_sorted = sorted_sha256([line for _, line in lines]) == ref["sha256_sorted"]
        counts.append(len(diff))
        log(f"  -m {fmt[1]} records against the JAX package's ({corpus}, timed run {k + 1}): "
            f"{len(diff)} reads differ{': ' + ', '.join(sorted(diff)[:5]) if diff else ''}; "
            f"{len(lines)} lines (JAX {ref['records']}), sorted sha256 "
            f"{'equal' if same_sorted else 'differs'}")
        if len(diff) > RECORD_DIFF_LIMIT[corpus]:
            raise AssertionError(
                f"{corpus}: {len(diff)} reads' -m {fmt[1]} lines differ from the JAX package's "
                f"(limit {RECORD_DIFF_LIMIT[corpus]}); first {sorted(diff)[:5]}")
    return {"reads_differing": counts, "limit": RECORD_DIFF_LIMIT[corpus]}


def check_sam_records(cell: str, res: dict, refs: dict, reads_path: str, out_dir) -> dict:
    """Every timed run's SAM lines against the JAX package's
    (tools/jax_sam_reference.json ``cell``), read by read: the digest of
    the @HD, @RG and @SQ lines must be equal, and a read differs when the
    digest of its lines differs or only one side has lines for it. Also the
    number of lines with FLAG 4 and with FLAG 256. Writes the first timed
    run's text to <out_dir>/sam_<cell>.sam when ``out_dir`` is given. Fails
    above RECORD_DIFF_LIMIT[cell]."""
    ref = refs[cell]
    with open(reads_path, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    if md5 != ref["reads_md5"] or os.path.basename(reads_path) != ref["movie_name"]:
        raise AssertionError(f"{cell}: reads {reads_path} (md5 {md5}) are not the reference's "
                             f"{ref['movie_name']} ({ref['reads_md5']})")
    runs = res.pop("sam_runs")
    if out_dir:
        with open(os.path.join(out_dir, f"sam_{cell}.sam"), "w") as f:
            f.writelines(line + "\n" for line in runs[0])
    counts = []
    for k, lines in enumerate(runs):
        header, got = sam_digests(lines)
        diff = {n for n in set(got) | set(ref["digests"]) if got.get(n) != ref["digests"].get(n)}
        body = [ln for ln in lines if not ln.startswith("@")]
        flags = (sam_flag_count(lines, 4), sam_flag_count(lines, 256))
        same_sorted = sorted_sha256(body) == ref["sha256_sorted"]
        counts.append(len(diff))
        log(f"  SAM lines against the JAX package's ({cell}, timed run {k + 1}): {len(diff)} reads "
            f"differ{': ' + ', '.join(sorted(diff)[:5]) if diff else ''}; header "
            f"{'equal' if header == ref['header_sha256'] else 'differs'}; {len(body)} lines "
            f"(JAX {ref['lines']}), FLAG 4 {flags[0]} (JAX {ref['unmapped_lines']}), FLAG 256 "
            f"{flags[1]} (JAX {ref['secondaries']}); sorted sha256 "
            f"{'equal' if same_sorted else 'differs'}")
        if header != ref["header_sha256"]:
            raise AssertionError(f"{cell}: the SAM header differs from the JAX package's")
        if len(diff) > RECORD_DIFF_LIMIT[cell]:
            raise AssertionError(
                f"{cell}: {len(diff)} reads' SAM lines differ from the JAX package's (limit "
                f"{RECORD_DIFF_LIMIT[cell]}); first {sorted(diff)[:5]}")
    return {"reads_differing": counts, "limit": RECORD_DIFF_LIMIT[cell],
            "lines": len(body), "unmapped_lines": flags[0], "secondaries": flags[1]}


def profile_batch(index, reads, params) -> dict:
    """torch.profiler over one full batch of the 1024 bp bucket: device
    kernel time against the host wall clock (the device's idle share while
    the profiler is on), and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blasr_tpu_torch.pipeline.runner import run_mapping

    sub = [r for r in reads if 768 < len(r) <= 1024][: params.batch_size]
    run_mapping(index, sub, params, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_mapping(index, sub, params, device="cuda")
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    ka = prof.key_averages()
    kern = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    log(f"profile (one batch, {len(sub)} reads of 769-1024 bp): wall {wall_ms:.1f} ms (profiler on), device kernels "
        f"{dev_ms:.1f} ms, {sum(e.count for e in kern)} kernel launches, device idle "
        f"{100 * (1 - dev_ms / wall_ms):.1f}%")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<7d} {e.key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "launches": sum(e.count for e in kern),
            "top": [[e.key[:120], e.self_device_time_total / 1e3, e.count] for e in top]}


def walk_profile(index, reads, params, lo: int = 512, hi: int = 768) -> dict:
    """The traceback walk of one batch of reads of ``lo`` + 1 to ``hi`` bp
    (``call_profile``)."""
    sub = [r for r in reads if lo < len(r) <= hi][: params.batch_size]
    if not sub:
        raise AssertionError(f"no reads of {lo + 1}-{hi} bp to profile the walk on")
    return call_profile("walk_arrows_device", index, sub, params)


def call_profile(name: str, index, sub, params) -> dict:
    """The first call of the mapper's ``name`` (a function of
    pipeline/mapper.py's namespace) while ``sub`` maps: its wall time
    without the profiler (the median of three calls, taken first: the
    profiler's event processing outlasts its context and would slow the
    calls after it), then one call under torch.profiler, tracing the card
    only, for its kernel launches and device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blasr_tpu_torch.pipeline import mapper
    from blasr_tpu_torch.pipeline.runner import run_mapping

    fn = getattr(mapper, name)
    out: dict = {}

    def traced(*args, **kw):
        if out:
            return fn(*args, **kw)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            fn(*args, **kw)
            torch.cuda.synchronize()
            walls.append((time.time() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = fn(*args, **kw)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        out.update(reads=len(sub), unprofiled_ms=sorted(walls)[1],
                   launches=sum(e.count for e in kern),
                   device_ms=sum(e.self_device_time_total for e in kern) / 1e3)
        if not out["launches"]:
            raise AssertionError(f"the profiler saw no kernel of {name}")
        return res

    setattr(mapper, name, traced)
    try:
        run_mapping(index, sub, params, device="cuda")
    finally:
        setattr(mapper, name, fn)
    if not out:
        raise AssertionError(f"{name} never ran on the profiled batch")
    return out


def write_fastq_reads(path: str, reads) -> None:
    from blasr_tpu_torch.io.fastq import write_fastq

    write_fastq(path, [(r.name, r.codes, r.qual) for r in reads])


def check_guided(genome_fa: str, reads_fq: str, clr_reads, index, unguided: dict) -> dict:
    """The CLR FASTQ corpus with -useGuidedAlign on the CLI's parameters:
    one timed run with the per-stage clock, accuracy against the JAX
    package's CPU figure, the guided DP at W = 32 and W = 128, the walk's
    launches on one batch with and without guided bands, and the CLI on 256
    of the reads printing run_mapping's lines."""
    import torch

    from blasr_tpu_torch.bench import BENCH_DIR
    from blasr_tpu_torch.ops import dp_launch_counts, reset_launch_counts
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.pipeline.runner import run_mapping

    gparams = cli_params(reads_fq, genome_fa, ["-useGuidedAlign"])
    if not gparams.guided_band:
        raise AssertionError("-useGuidedAlign did not set guided_band")
    log("CLR FASTQ corpus with -useGuidedAlign (CLI parameters) through run_mapping:")
    res = map_corpus(index, clr_reads, gparams)
    acc = res["accuracy_true_locus"]
    if abs(acc - JAX_GUIDED_ACCURACY) > CLR_ACCURACY_SLACK:
        raise AssertionError(f"guided CLR accuracy_true_locus {acc:.4f} not within "
                             f"{CLR_ACCURACY_SLACK} of the JAX package's {JAX_GUIDED_ACCURACY}")
    by = res["dp_launches"]
    if not by.get("W32/guided") or not by.get("W128/guided"):
        raise AssertionError(f"guided DP kernel not launched at W=32 and W=128: {by}")
    missing = [k for k, v in res["launches"].items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the guided path: {missing}")
    walk_u = walk_profile(index, clr_reads, cli_params(reads_fq, genome_fa))
    walk_g = walk_profile(index, clr_reads, gparams)
    share = {name: r["stage_seconds"].get("walk", 0.0) / max(sum(r["stage_seconds"].values()), 1e-9)
             for name, r in (("unguided", unguided), ("guided", res))}
    log(f"guided CLR accuracy {acc:.4f} (JAX package on the CPU {JAX_GUIDED_ACCURACY}); guided DP "
        f"launches {by}; walk of one batch of {walk_g['reads']} reads of 513-768 bp: "
        f"{walk_g['launches']} kernel launches, {walk_g['device_ms']:.1f} ms device, "
        f"{walk_g['unprofiled_ms']:.1f} ms wall without the profiler (unguided: "
        f"{walk_u['launches']}, {walk_u['device_ms']:.1f} ms, {walk_u['unprofiled_ms']:.1f} ms); "
        f"walk share of the stage clock {100 * share['guided']:.1f}% (unguided CLR cell "
        f"{100 * share['unguided']:.1f}%)")

    sub = clr_reads[:256]
    sub_fq = os.path.join(BENCH_DIR, "reads_clr_cli.fastq")
    write_fastq_reads(sub_fq, sub)
    cli_lines, cli_metrics, cli_s = run_cli(sub_fq, genome_fa, "reads_clr_guided_cli",
                                            ["-useGuidedAlign"])
    reset_launch_counts()
    recs, _ = run_mapping(index, sub, cli_params(sub_fq, genome_fa, ["-useGuidedAlign"]),
                          device="cuda")
    torch.cuda.synchronize()
    if cli_lines != [format_m4(r) for r in recs]:
        raise AssertionError("guided CLI output differs from run_mapping on the same reads")
    log(f"guided CLI on the card: {len(sub)} CLR FASTQ reads -> {len(cli_lines)} m4 lines in "
        f"{cli_s:.1f} s (process included), equal to run_mapping; DP launches in the CLI "
        f"{cli_metrics['dpLaunches']}, in run_mapping {dp_launch_counts()}")
    res.update(walk_batch=walk_g, walk_batch_unguided=walk_u, walk_share=share,
               cli={"reads": len(sub), "lines": len(cli_lines), "seconds": cli_s,
                    "dp_launches": cli_metrics["dpLaunches"]})
    return res


def check_matrix(genome_fa: str, reads, index, cli: dict) -> dict:
    """-scoreMatrix through the CLI on phase 4's 256 FASTA reads: the
    default scores as a matrix print phase 4's lines; the transition
    matrix prints run_mapping's lines and runs the matrix kernel."""
    import torch

    from blasr_tpu_torch.ops import dp_launch_counts, reset_launch_counts
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.pipeline.runner import run_mapping

    def flag(mat):
        return [f"-scoreMatrix={','.join(map(str, mat))}"]

    same, same_metrics, same_s = run_cli(cli["path"], genome_fa, "reads_cli_matrix_default",
                                         flag(DEFAULT_MATRIX))
    if same != cli["m4"]:
        raise AssertionError("the default scores as a -scoreMatrix change the CLI's lines")
    if not any(k.endswith("/matrix") for k in same_metrics["dpLaunches"]):
        raise AssertionError(f"the default-score matrix run launched no matrix DP: "
                             f"{same_metrics['dpLaunches']}")
    lines, metrics, secs = run_cli(cli["path"], genome_fa, "reads_cli_matrix",
                                   flag(TRANSITION_MATRIX))
    params = cli_params(cli["path"], genome_fa, flag(TRANSITION_MATRIX))
    if params.score_matrix != TRANSITION_MATRIX:
        raise AssertionError(f"-scoreMatrix parsed as {params.score_matrix}")
    reset_launch_counts()
    recs, _ = run_mapping(index, reads[: cli["reads"]], params, device="cuda")
    torch.cuda.synchronize()
    by = dp_launch_counts()
    launches = sum(n for k, n in by.items() if k.endswith("/matrix"))
    cli_launches = sum(n for k, n in metrics["dpLaunches"].items() if k.endswith("/matrix"))
    if lines != [format_m4(r) for r in recs]:
        raise AssertionError("CLI output with -scoreMatrix differs from run_mapping")
    if launches == 0 or cli_launches == 0:
        raise AssertionError(f"matrix DP kernel not launched: here {by}, CLI "
                             f"{metrics['dpLaunches']}")
    if lines == cli["m4"]:
        raise AssertionError("the transition matrix left every line as it was")
    log(f"-scoreMatrix on the card: the default scores as a matrix print phase 4's "
        f"{len(same)} lines ({same_s:.1f} s); the transition matrix prints {len(lines)} lines "
        f"equal to run_mapping ({secs:.1f} s), {sum(a != b for a, b in zip(lines, cli['m4']))} "
        f"of them changed; DP launches in run_mapping {by}, in the CLI {metrics['dpLaunches']}")
    return {"reads": cli["reads"], "lines": len(lines), "default_lines_equal": True,
            "seconds": [same_s, secs], "launches": launches, "dp_launches": by,
            "cli_dp_launches": metrics["dpLaunches"],
            "default_cli_dp_launches": same_metrics["dpLaunches"]}


def check_config3(genome_fa: str, reads_fa: str, reads, index, refs: dict, out_dir,
                  fasta: dict, cli: dict) -> dict:
    """Config 3 (-bestn 2 -m 5) on the FASTA corpus: one timed run with
    the per-stage clock through run_mapping; every -m 5 line against
    the JAX package's read by read; accuracy equal to the -m 4 run's and to
    the JAX package's; every kernel launched; the walk of one batch of
    513-768 bp reads with and without moves; then the CLI with -bestn 2
    -m 5 on phase 4's 256 reads prints run_mapping's lines."""
    import torch

    from blasr_tpu_torch import bench
    from blasr_tpu_torch.ops import dp_launch_counts, reset_launch_counts
    from blasr_tpu_torch.output.verbose import format_m5
    from blasr_tpu_torch.pipeline.runner import run_mapping

    params = bench.config3_params()
    by_name = {r.name: r for r in reads}
    log("config 3 (-bestn 2 -m 5) on the FASTA corpus through run_mapping:")
    res = map_corpus(index, reads, params,
                     formatter=lambda r: format_m5(r, by_name[r.qname], index),
                     sam_movie=os.path.basename(reads_fa))
    res["records_vs_jax"] = check_records("config3", res, refs, reads_fa, out_dir)
    res["sam_vs_jax"] = check_sam_records("config3_sam", res, refs, reads_fa, out_dir)
    if res["sam_vs_jax"]["secondaries"] != refs["config3_sam"]["secondaries"]:
        raise AssertionError(f"config 3's SAM has {res['sam_vs_jax']['secondaries']} FLAG 256 "
                             f"lines, the JAX package's {refs['config3_sam']['secondaries']}")
    ref = refs["config3"]
    acc = res["accuracy_true_locus"]
    if acc != fasta["accuracy_true_locus"] or acc != ref["accuracy_true_locus"]:
        raise AssertionError(f"config 3 accuracy_true_locus {acc:.4f}: the -m 4 run's is "
                             f"{fasta['accuracy_true_locus']:.4f}, the JAX package's "
                             f"{ref['accuracy_true_locus']:.4f}")
    missing = [k for k, v in res["launches"].items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the config 3 path: {missing}")
    met = res["metrics"]
    walk_m = walk_profile(index, reads, params)
    walk_0 = walk_profile(index, reads, bench.bench_params())
    log(f"config 3: {res['secondaries']} secondaries (JAX package {ref['secondaries']}); "
        f"secondary admission on the host {met['secondary_seconds']:.3f} s of finalize "
        f"{met['finalize_seconds']:.3f} s ({met['secondary_checked']} rank-1 records checked, "
        f"{met['secondary_gated']} dropped by the min_interval gate, "
        f"{met['secondary_replaced']} on the SDP chain's span); DP launches by (W, mode) "
        f"{res['dp_launches']}; walk of one batch of {walk_m['reads']} reads of 513-768 bp with "
        f"moves: {walk_m['launches']} kernel launches, {walk_m['device_ms']:.1f} ms device, "
        f"{walk_m['unprofiled_ms']:.1f} ms wall without the profiler (without moves: "
        f"{walk_0['launches']}, {walk_0['device_ms']:.1f} ms, {walk_0['unprofiled_ms']:.1f} ms)")

    extra = ["-bestn", "2", "-m", "5"]
    lines, metrics, secs = run_cli(cli["path"], genome_fa, "reads_cli_bestn2_m5", extra)
    cparams = cli_params(cli["path"], genome_fa, extra)
    if (cparams.best_n, cparams.emit_moves) != (2, True):
        raise AssertionError(f"-bestn 2 -m 5 parsed as best_n {cparams.best_n}, "
                             f"emit_moves {cparams.emit_moves}")
    sub = reads[: cli["reads"]]
    reset_launch_counts()
    recs, _ = run_mapping(index, sub, cparams, device="cuda")
    torch.cuda.synchronize()
    want = [format_m5(r, by_name[r.qname], index) for r in recs]
    if lines != want:
        raise AssertionError(f"CLI -bestn 2 -m 5 output differs from run_mapping: "
                             f"{sum(a != b for a, b in zip(lines, want))} of {len(want)} lines, "
                             f"{len(lines)} printed")
    log(f"CLI -bestn 2 -m 5 on the card: {len(sub)} FASTA reads -> {len(lines)} m5 lines "
        f"({n_secondaries(recs)} secondaries) in {secs:.1f} s (process included), equal to "
        f"run_mapping; DP launches in the CLI {metrics['dpLaunches']}, in run_mapping "
        f"{dp_launch_counts()}")
    res.update(walk_batch_moves=walk_m, walk_batch_no_moves=walk_0,
               cli={"reads": len(sub), "lines": len(lines), "seconds": secs,
                    "dp_launches": metrics["dpLaunches"]})
    return res


def check_config2(reads_fq: str, clr_reads, index, refs: dict, out_dir, fastq: dict) -> dict:
    """Config 2 (-sam -clipping soft) on the CLR FASTQ corpus at the bench
    operating point with move strings: one timed run of run_mapping with
    the per-stage clock plus write_sam into a StringIO; its SAM lines
    against the JAX package's read by read, the
    header equal; accuracy equal to the -m 4 run's (phase 5); every kernel
    launched, the single-quality DP at W = 32 and, for the escalated
    reads, W = 256; the lines read back through the port's read_sam from
    SAM text and from BAM."""
    import numpy as np

    from blasr_tpu_torch import bench
    from blasr_tpu_torch.io.bam import write_bam_from_sam_lines
    from blasr_tpu_torch.io.sam import read_sam

    params = bench.bench_params(emit_moves=True)
    log("config 2 (-sam -clipping soft) on the CLR FASTQ corpus through run_mapping + write_sam:")
    res = map_corpus(index, clr_reads, params, sam_movie=os.path.basename(reads_fq))
    lines = res["sam_runs"][0]
    res["sam_vs_jax"] = check_sam_records("config2", res, refs, reads_fq, out_dir)
    acc = res["accuracy_true_locus"]
    if acc != fastq["accuracy_true_locus"]:
        raise AssertionError(f"config 2 accuracy_true_locus {acc:.4f}, the -m 4 run's "
                             f"{fastq['accuracy_true_locus']:.4f}")
    missing = [k for k, v in res["launches"].items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the config 2 path: {missing}")
    by = res["dp_launches"]
    if not by.get("W32/single") or not by.get("W256/single") or res["escalated"] == 0:
        raise AssertionError(f"config 2 ran no single-quality DP at W=32 and W=256, or no read "
                             f"escalated: {by}, {res['escalated']} escalated")
    # the lines back through the port's reader, as SAM text and as BAM
    t0 = time.time()
    sam_path = os.path.join(bench.BENCH_DIR, "config2.sam")
    with open(sam_path, "w") as f:
        f.writelines(line + "\n" for line in lines)
    bam_path = os.path.join(bench.BENCH_DIR, "config2.bam")
    header = [ln for ln in lines if ln.startswith("@")]
    body = [ln for ln in lines if not ln.startswith("@")]
    write_bam_from_sam_lines(header, body, bam_path)
    text, binary = read_sam(sam_path), read_sam(bam_path)

    def key(rec):
        return (rec.qname, rec.flag, rec.seq,
                None if rec.qual is None else rec.qual.tobytes(), rec.tags)

    if (text.header_lines != header or binary.header_lines != header
            or [key(r) for r in binary.records] != [key(r) for r in text.records]
            or [(r.qname, str(r.flag), r.seq) for r in text.records]
            != [(f[0], f[1], f[9]) for f in (ln.split("\t") for ln in body)]):
        raise AssertionError("config 2's SAM lines do not read back the same through read_sam")
    round_s = time.time() - t0
    st = res["stage_seconds"]
    log(f"config 2: reads/s with the SAM write "
        + ", ".join(f"{x:.1f}" for x in res["reads_per_s_with_sam"])
        + f" (write {', '.join(f'{x:.3f}' for x in res['sam_write_s'])} s); accuracy {acc:.4f} "
        f"equal to the -m 4 run's; walk stage {st.get('walk', 0):.3f} s (CLR -m 4 "
        f"{fastq['stage_seconds'].get('walk', 0):.3f} s); DP launches by (W, mode) {by}; "
        f"{len(text.records)} lines read back equal from SAM text and BAM ({round_s:.1f} s)")
    res["round_trip_s"] = round_s
    return res


def check_config4(genome_fa: str, reads_fa: str, reads, index, refs: dict, out_dir,
                  cli: dict) -> dict:
    """Config 4 (-bwt -m 4) on the FASTA corpus at bench.config4_params,
    with the suffix-array cells' device tables freed first: the FM index
    built from the genome as the CLI builds it (the port's SA-IS and
    build_fm_index; seconds, and the device bytes of the seven FM arrays),
    then one timed run with the per-stage clock through run_mapping on a
    genome-only index; its -m 4 lines
    against the JAX package's read by read and accuracy equal to its
    figure; every kernel launched. Then find_anchors_fm on the widest batch
    of the corpus as the mapper calls it (both strands, 2B rows) on the
    card and on the CPU, all four outputs equal, and its time on the card;
    then the CLI with -bwt on phase 4's 256 reads twice (the bundle built
    and saved, then loaded), each printing run_mapping's lines."""
    import numpy as np
    import torch

    from blasr_tpu_torch import bench
    from blasr_tpu_torch.index.artifacts import GenomeIndex, build_pos_ok
    from blasr_tpu_torch.index.fm import build_fm_index
    from blasr_tpu_torch.index.suffix_array import build_suffix_array
    from blasr_tpu_torch.io.batching import batch_reads
    from blasr_tpu_torch.ops.fm_search import find_anchors_fm
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.pipeline.mapper import _revcomp_rows, make_device_index
    from blasr_tpu_torch.pipeline.runner import run_mapping

    params = bench.config4_params()
    # the SA cells' direct tables (2.5 GiB) go: this cell's memory is its own
    getattr(index, "_torch_device_index_cache", {}).clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    t0 = time.time()
    sa = build_suffix_array(index.genome)
    sa_s = time.time() - t0
    fm = build_fm_index(index.genome, sa)
    fm_s = time.time() - t0
    del sa
    empty = np.zeros(0, np.int32)
    findex = GenomeIndex(index.genome, empty, empty,
                         build_pos_ok(index.genome, index.seqdb, params.min_match_length),
                         params.min_match_length, index.seqdb)
    t0 = time.time()
    di = make_device_index(findex, params, "cuda", fm=fm)
    torch.cuda.synchronize()
    up_s = time.time() - t0
    fm_bytes = sum(a.numel() * a.element_size() for a in di.arrays)
    log(f"config 4 (-bwt -m 4, B={params.batch_size}) on the FASTA corpus: FM index built in "
        f"{fm_s:.1f} s (suffix array {sa_s:.1f} s), n = {fm.n}; its seven device arrays "
        f"{fm_bytes / 2**20:.1f} MiB, the packed genome {di.genome_pad.numel() * 4 / 2**20:.1f} "
        f"MiB, uploaded in {up_s:.2f} s; {resident / 2**20:.1f} MiB allocated before it")
    res = map_corpus(findex, reads, params, fm=fm)
    res["records_vs_jax"] = check_records("config4", res, refs, reads_fa, out_dir)
    ref = refs["config4"]
    acc = res["accuracy_true_locus"]
    if acc != ref["accuracy_true_locus"]:
        raise AssertionError(f"config 4 accuracy_true_locus {acc:.4f}, the JAX package's "
                             f"{ref['accuracy_true_locus']:.4f}")
    missing = [k for k, v in res["launches"].items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the config 4 path: {missing}")

    # the FM anchors of the widest batch, card against CPU
    batch = max(batch_reads(reads, params.batch_size, params.max_read_len),
                key=lambda b: b.codes.shape[1])
    codes = torch.from_numpy(batch.codes).cuda()
    lengths = torch.from_numpy(batch.lengths.astype(np.int32)).cuda()
    reads2 = torch.cat([codes, _revcomp_rows(codes, lengths)]).contiguous()
    lens2 = torch.cat([lengths, lengths])
    kw = dict(k=di.k, n=di.fm_n, max_hits_per_pos=params.max_anchors_per_position,
              max_anchors_per_read=params.max_anchors_per_read,
              anchor_stride=params.anchor_stride)

    def anchors():
        return find_anchors_fm(reads2, lens2, *di.arrays, **kw)

    gpu = [x.cpu() for x in anchors()]
    t0 = time.time()
    cpu = find_anchors_fm(reads2.cpu(), lens2.cpu(), *(a.cpu() for a in di.arrays), **kw)
    cpu_s = time.time() - t0
    for name, a, b in zip(("t", "q", "nhits", "valid"), cpu, gpu):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"find_anchors_fm's {name} on the card differs from the CPU's")
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    anchor_ms = cuda_ms(anchors, reps=5)
    anchor_peak = torch.cuda.max_memory_allocated() - before
    log(f"  find_anchors_fm on {tuple(reads2.shape)} (both strands, the widest batch): the "
        f"card's t, q, nhits, valid equal the CPU's ({int(gpu[3].sum())} valid anchors; CPU "
        f"{cpu_s:.2f} s); {anchor_ms:.3f} ms a call on the card, working set "
        f"{anchor_peak / 2**20:.0f} MiB")

    # the CLI: build and save the bundle, then load it
    bundle = os.path.join(bench.BENCH_DIR, "genome_cli.btfm.npz")
    if os.path.exists(bundle):
        os.remove(bundle)
    extra = ["-bwt", bundle]
    sub = reads[: cli["reads"]]
    recs, _ = run_mapping(findex, sub, cli_params(cli["path"], genome_fa, extra),
                          device="cuda", fm=fm)
    want = [format_m4(r) for r in recs]
    runs = []
    for tag in ("built", "loaded"):
        existed = os.path.exists(bundle)
        lines, metrics, secs = run_cli(cli["path"], genome_fa, f"reads_cli_bwt_{tag}", extra)
        if existed != (tag == "loaded") or not os.path.exists(bundle):
            raise AssertionError(f"-bwt {bundle}: the bundle was not {tag} as expected")
        if lines != want:
            raise AssertionError(f"CLI -bwt ({tag} bundle) output differs from run_mapping: "
                                 f"{sum(a != b for a, b in zip(lines, want))} of {len(want)} "
                                 f"lines, {len(lines)} printed")
        runs.append({"bundle": tag, "lines": len(lines), "seconds": secs,
                     "index_seconds": metrics["indexLoadSeconds"],
                     "launches": metrics["kernelLaunches"]})
        log(f"  CLI -bwt ({tag} bundle) on {len(sub)} FASTA reads -> {len(lines)} m4 lines in "
            f"{secs:.1f} s (process included; index {metrics['indexLoadSeconds']:.2f} s), "
            f"equal to run_mapping; launches {metrics['kernelLaunches']}")
    res.update(fm_build_s=fm_s, sa_build_s=sa_s, fm_upload_s=up_s, fm_device_bytes=fm_bytes,
               resident_before_bytes=resident, anchors_batch_shape=list(reads2.shape),
               anchors_ms=anchor_ms, anchors_working_bytes=anchor_peak,
               anchors_cpu_s=cpu_s, cli=runs)
    return res


def check_sa_seeds(genome_fa: str, reads_fa: str, reads, index, refs: dict, out_dir,
                   cli: dict) -> dict:
    """Seeds of k = 15 and k = 18 on the FASTA corpus (bench.k15_params,
    bench.k18_params). For each k: the index built by the port's
    build_index_from_arrays (seconds) and uploaded by make_device_index
    (seconds, the device bytes of its four arrays), its kind asserted
    (bisection at k = 15 although direct_lut is set, wide keys at k = 18);
    one timed run with the per-stage clock through run_mapping; its -m 4
    lines against the JAX package's read by read and
    accuracy equal to its figure; every kernel launched; then the anchor
    search on the widest batch of the corpus as the mapper calls it (both
    strands) on the card and on the CPU, all four outputs equal, and its
    time on the card. The index is freed before the next k. Then the CLI
    on phase 4's 256 reads with -minMatch 18 -sa FILE (FILE written here
    by write_sa_file of reference_order_sa) prints the lines of
    run_mapping on build_index_from_sa of FILE, and with -nucmer the lines
    of run_mapping on a k = 30 index at the CLI's parameters."""
    import numpy as np
    import torch

    from blasr_tpu_torch import bench
    from blasr_tpu_torch.index.artifacts import (
        LUT_BITS, build_index_from_arrays, build_index_from_sa)
    from blasr_tpu_torch.index.safile import reference_order_sa, write_sa_file
    from blasr_tpu_torch.io.batching import batch_reads
    from blasr_tpu_torch.ops.anchors import find_anchors_bisect, find_anchors_wide
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.pipeline.mapper import _revcomp_rows, make_device_index
    from blasr_tpu_torch.pipeline.runner import run_mapping

    out = {}
    for cell, params, kind in (("k15", bench.k15_params(), "bisect"),
                               ("k18", bench.k18_params(), "wide")):
        k = params.min_match_length
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        t0 = time.time()
        sidx = build_index_from_arrays(index.genome, index.seqdb, k)
        build_s = time.time() - t0
        t0 = time.time()
        di = make_device_index(sidx, params, "cuda")
        torch.cuda.synchronize()
        up_s = time.time() - t0
        # the kind make_device_index recorded, and the arrays it built: three
        # of G rows and the 2^22 + 1 prefix table, which is the last array of
        # the wide set and the third of the bisection set (run_len last)
        names = {"wide": ("sa_masked", "kmer_hi", "kmer_lo", "lut"),
                 "bisect": ("sa_masked", "sa_kmers", "lut", "run_len")}.get(di.kind)
        rows = [a.numel() for a in di.arrays]
        at = names.index("lut") if names else 0
        if (not params.direct_lut or names is None or di.kind != kind or di.lut_meta[1] <= 0
                or rows[at] != (1 << LUT_BITS) + 1
                or rows[:at] + rows[at + 1:] != [sidx.genome_length] * 3):
            raise AssertionError(f"k={k} took the {di.kind} index (lut_meta {di.lut_meta}, "
                                 f"array rows {rows}), not {kind}")
        array_bytes = {n: a.numel() * a.element_size() for n, a in zip(names, di.arrays)}
        log(f"k={k} ({kind} index, direct_lut={params.direct_lut}) on the FASTA corpus: index "
            f"built in {build_s:.2f} s, uploaded in {up_s:.2f} s (lut_meta {di.lut_meta}); "
            f"device arrays {array_bytes} = {sum(array_bytes.values()) / 2**20:.1f} MiB; "
            f"{resident / 2**20:.1f} MiB allocated before it")
        res = map_corpus(sidx, reads, params)
        res["records_vs_jax"] = check_records(cell, res, refs, reads_fa, out_dir)
        ref = refs[cell]
        if res["accuracy_true_locus"] != ref["accuracy_true_locus"]:
            raise AssertionError(f"k={k} accuracy_true_locus {res['accuracy_true_locus']:.4f}, "
                                 f"the JAX package's {ref['accuracy_true_locus']:.4f}")
        missing = [n for n, v in res["launches"].items() if v <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the k={k} path: {missing}")

        # the anchors of the widest batch, card against CPU
        batch = max(batch_reads(reads, params.batch_size, params.max_read_len),
                    key=lambda b: b.codes.shape[1])
        codes = torch.from_numpy(batch.codes).cuda()
        lengths = torch.from_numpy(batch.lengths.astype(np.int32)).cuda()
        reads2 = torch.cat([codes, _revcomp_rows(codes, lengths)]).contiguous()
        lens2 = torch.cat([lengths, lengths])
        search = find_anchors_wide if di.kind == "wide" else find_anchors_bisect
        kw = dict(k=k, max_hits_per_pos=params.max_anchors_per_position,
                  max_anchors_per_read=params.max_anchors_per_read, lut_meta=di.lut_meta,
                  anchor_stride=params.anchor_stride, expand=params.min_expand)

        def anchors():
            return search(reads2, lens2, *di.arrays, **kw)

        gpu = [x.cpu() for x in anchors()]
        t0 = time.time()
        cpu = search(reads2.cpu(), lens2.cpu(), *(a.cpu() for a in di.arrays), **kw)
        cpu_s = time.time() - t0
        for name, a, b in zip(("t", "q", "nhits", "valid"), cpu, gpu):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"{search.__name__}'s {name} on the card differs from the "
                                     f"CPU's (k={k})")
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        anchor_ms = cuda_ms(anchors, reps=5)
        anchor_peak = torch.cuda.max_memory_allocated() - before
        log(f"  {search.__name__} on {tuple(reads2.shape)} (both strands, the widest batch): "
            f"the card's t, q, nhits, valid equal the CPU's ({int(gpu[3].sum())} valid "
            f"anchors; CPU {cpu_s:.2f} s); {anchor_ms:.3f} ms a call on the card, working set "
            f"{anchor_peak / 2**20:.0f} MiB")
        res.update(kind=kind, lut_meta=list(di.lut_meta), index_build_s=build_s,
                   upload_s=up_s, array_bytes=array_bytes, resident_before_bytes=resident,
                   anchors_batch_shape=list(reads2.shape), anchors_ms=anchor_ms,
                   anchors_working_bytes=anchor_peak, anchors_cpu_s=cpu_s)
        out[cell] = res
        del di, sidx, gpu, codes, lengths, reads2, lens2
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the CLI: -minMatch 18 -sa FILE, then -nucmer
    sub = reads[: cli["reads"]]
    sa_path = os.path.join(bench.BENCH_DIR, "genome.sa")
    t0 = time.time()
    write_sa_file(sa_path, reference_order_sa(index.genome))
    sa_write_s = time.time() - t0
    cli_runs = []
    for tag, extra in (("sa", ["-minMatch", "18", "-sa", sa_path]), ("nucmer", ["-nucmer"])):
        params = cli_params(cli["path"], genome_fa, extra)
        if tag == "sa":
            idx = build_index_from_sa(genome_fa, sa_path, k=params.min_match_length)
        else:
            idx = build_index_from_arrays(index.genome, index.seqdb, params.min_match_length)
        if (tag, params.min_match_length) not in (("sa", 18), ("nucmer", 30)):
            raise AssertionError(f"-{tag}: min_match_length {params.min_match_length}")
        recs, _ = run_mapping(idx, sub, params, device="cuda")
        want = [format_m4(r) for r in recs]
        lines, metrics, secs = run_cli(cli["path"], genome_fa, f"reads_cli_{tag}", extra)
        if lines != want:
            raise AssertionError(f"CLI {' '.join(extra)} output differs from run_mapping: "
                                 f"{sum(a != b for a, b in zip(lines, want))} of {len(want)} "
                                 f"lines, {len(lines)} printed")
        cli_runs.append({"flags": extra[:1] if tag == "nucmer" else extra[:3], "k":
                         params.min_match_length, "max_score": params.max_score,
                         "lines": len(lines), "seconds": secs,
                         "index_seconds": metrics["indexLoadSeconds"],
                         "launches": metrics["kernelLaunches"]})
        log(f"  CLI {' '.join(extra)} on {len(sub)} FASTA reads (k = {params.min_match_length}, "
            f"maxScore {params.max_score}) -> {len(lines)} m4 lines in {secs:.1f} s (process "
            f"included; index {metrics['indexLoadSeconds']:.2f} s), equal to run_mapping; "
            f"launches {metrics['kernelLaunches']}")
        del idx
    out.update(sa_write_s=sa_write_s, cli=cli_runs)
    return out


def check_piecewise(genome_fa: str, index, refs: dict, out_dir) -> dict:
    """Piecewise mapping on the card, once per corpus with no warm-up (the
    same K1 instances ran in phases 4 and 5): config 5 (-alignContigs,
    bench.config5_params) on the two evolved contigs through
    run_mapping_piecewise, its -m 4 and SAM (-clipping soft) lines against
    the JAX package's read by read (tools/jax_piecewise_reference.json
    config5, config5_sam) and its two whole-contig records equal to the
    JAX package's lines; then the long-read corpus (300 reads of 5-24 kb
    and 100 bench reads) through run_mapping at the bench operating point,
    where every read above max_read_len maps piecewise, its -m 4 lines
    read by read (``long``) and accuracy within 0.01 of the JAX package's;
    each run's launches (counts reset just before it), peak memory and
    the host split (the inner runs' dispatch, wait and finalize, the
    secondary admission inside finalize, the stitching with its SDP
    fills). Then the CLI with -alignContigs on ctg2 alone and on 50 long
    reads without it, each printing the lines of the library's run. The
    mapping runs carry the per-stage clock, which synchronises after every
    stage."""
    import io

    import torch

    from blasr_tpu_torch import bench
    from blasr_tpu_torch.io.batching import read_records
    from blasr_tpu_torch.io.fasta import write_fasta
    from blasr_tpu_torch.ops import dp_launch_counts, launch_counts, reset_launch_counts
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.output.sam_writer import write_sam
    from blasr_tpu_torch.pipeline.mapper import StageClock, make_device_index
    from blasr_tpu_torch.pipeline.piecewise import run_mapping_piecewise
    from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping

    t0 = time.time()
    cells = (("config5", bench.ensure_contig_corpus(), bench.config5_params(),
              run_mapping_piecewise),
             ("long", bench.ensure_long_corpus(), bench.bench_params(), run_mapping))
    corpus_s = time.time() - t0
    t0 = time.time()
    make_device_index(index, bench.bench_params(), "cuda")
    torch.cuda.synchronize()
    log(f"piecewise corpora written in {corpus_s:.1f} s; device index (direct 4^14 tables) "
        f"{time.time() - t0:.1f} s")
    out = {}
    for cell, path, params, run in cells:
        reads = read_records(path)
        n_bases = sum(len(r) for r in reads)
        met = MappingMetrics()
        clock = StageClock(torch.device("cuda"))
        torch.cuda.synchronize()
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        recs, unm = run(index, reads, params, device="cuda", metrics=met, clock=clock)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts, by_shape = launch_counts(), dp_launch_counts()
        peak = torch.cuda.max_memory_allocated()
        stage = dict(clock.seconds)
        total_stage = sum(stage.values())
        res = {"reads": len(reads), "bases": n_bases, "walls_s": [wall],
               "reads_per_s": [len(reads) / wall], "bases_per_s": [n_bases / wall],
               "records": len(recs), "unmapped": len(unm), "metrics": met.to_dict(),
               "stage_seconds": stage, "peak_bytes": peak, "launches": counts,
               "dp_launches": by_shape,
               "line_runs": [([(r.qname, format_m4(r)) for r in recs], unm)]}
        log(f"{cell}: {len(reads)} reads, {n_bases} bases in {wall:.2f} s ({len(reads) / wall:.1f} "
            f"reads/s, {n_bases / wall / 1e3:.1f} kb/s; no warm-up, the stage clock on); "
            f"records {len(recs)}, "
            f"unmapped {len(unm)}; segments {met.piecewise_segments}, passed through "
            f"{met.piecewise_pass_through}, stitched records {met.piecewise_stitched}, gap fills "
            f"{met.piecewise_gap_fills}")
        log(f"  host split: dispatch {met.dispatch_seconds:.3f} s wait {met.wait_seconds:.3f} s "
            f"finalize {met.finalize_seconds:.3f} s (secondary admission "
            f"{met.secondary_seconds:.3f} s of it, {met.secondary_checked} checked), stitching "
            f"{met.piecewise_seconds:.3f} s; batches {met.n_batches}, escalated "
            f"{met.escalated_reads}; buckets {met.buckets}")
        log(f"  stage clock: " + ", ".join(
            f"{k} {v:.3f} s ({100 * v / max(total_stage, 1e-9):.1f}%)" for k, v in stage.items()))
        log(f"  peak torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; kernel launches "
            f"{counts}; DP by shape {by_shape}")
        if cell == "config5":
            want = refs["config5"]["lines"]
            got = [line for _, line in res["line_runs"][0][0]]
            if got != want or {r.qname for r in recs} != {"ctg1", "ctg2"}:
                raise AssertionError(f"config 5: {got} are not the JAX package's whole-contig "
                                     f"records {want}")
            t1 = time.time()
            buf = io.StringIO()
            write_sam(recs, reads, index.seqdb, buf, clipping="soft", unmapped=unm,
                      movie_name=os.path.basename(path), genome=index.genome)
            res["sam_write_s"] = time.time() - t1
            res["sam_runs"] = [buf.getvalue().splitlines()]
            log(f"  whole-contig records equal to the JAX package's: {got}; SAM write "
                f"{res['sam_write_s']:.3f} s ({sum(r.path.n_aligned for r in recs)} ops)")
            res["sam_vs_jax"] = check_sam_records("config5_sam", res, refs, path, out_dir)
        else:
            acc = bench.accuracy_true_locus(recs, reads)
            ref_acc = refs["long"]["accuracy_true_locus"]
            res["accuracy_true_locus"] = acc
            log(f"  accuracy_true_locus {acc:.4f} (JAX package on the CPU {ref_acc:.4f})")
            if abs(acc - ref_acc) > CLR_ACCURACY_SLACK:
                raise AssertionError(f"long reads: accuracy_true_locus {acc:.4f}, the JAX "
                                     f"package's {ref_acc:.4f}")
        res["records_vs_jax"] = check_records(cell, res, refs, path, out_dir)
        missing = [k for k, v in counts.items() if v <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {cell} path: {missing}")
        out[cell] = res

    # the CLI: -alignContigs on the 0.8 Mb contig, -m 4 on 50 long reads
    contigs = read_records(cells[0][1])
    long_reads = read_records(cells[1][1])
    runs = []
    for tag, sub, extra, run in (
            ("contig_cli", [r for r in contigs if r.name == "ctg2"], ["-alignContigs"],
             run_mapping_piecewise),
            ("reads_long_cli", long_reads[:50], [], run_mapping)):
        path = os.path.join(bench.BENCH_DIR, f"{tag}.fasta")
        write_fasta(path, [(r.name, r.codes) for r in sub])
        params = cli_params(path, genome_fa, extra)
        if params.piecewise != bool(extra) or params.remove_contained != bool(extra):
            raise AssertionError(f"{tag}: {extra} gave piecewise {params.piecewise}, "
                                 f"remove_contained {params.remove_contained}")
        recs, _ = run(index, sub, params, device="cuda")
        want = [format_m4(r) for r in recs]
        lines, metrics, secs = run_cli(path, genome_fa, tag, extra)
        if lines != want:
            raise AssertionError(f"CLI {' '.join(extra)} on {tag} differs from the library's "
                                 f"run: {sum(a != b for a, b in zip(lines, want))} of "
                                 f"{len(want)} lines, {len(lines)} printed")
        stages = metrics["stages"]
        runs.append({"tag": tag, "flags": extra, "reads": len(sub), "lines": len(lines),
                     "seconds": secs, "index_seconds": metrics["indexLoadSeconds"],
                     "segments": stages["piecewise_segments"],
                     "launches": metrics["kernelLaunches"]})
        log(f"  CLI {' '.join(extra) or '-m 4'} on {len(sub)} {tag} reads -> {len(lines)} m4 "
            f"lines in {secs:.1f} s (process included; index {metrics['indexLoadSeconds']:.2f} "
            f"s; {stages['piecewise_segments']} segments), equal to the library's run; "
            f"launches {metrics['kernelLaunches']}")
    out["cli"] = runs
    return out


def compare_text(label: str, lines, ref: dict, names) -> dict:
    """A file's lines against the JAX reference's digests of it: the reads
    whose lines differ (a per-read digest that differs, or lines on one
    side only; every line counts where the lines name no read), and
    whether the whole text and its sorted lines are the reference's."""
    got = text_digests(lines, names)
    if "digests" in ref:
        keys = set(got["digests"]) | set(ref["digests"])
        diff = sorted(k for k in keys if got["digests"].get(k) != ref["digests"].get(k))
    else:
        diff = [] if got["sha256_sorted"] == ref["sha256_sorted"] else ["(rows differ)"]
    same = got["sha256"] == ref["sha256"]
    log(f"  {label}: {len(lines)} lines (JAX {ref['lines']}), {len(diff)} reads differ"
        f"{': ' + ', '.join(diff[:5]) if diff else ''}; text {'equal' if same else 'differs'}")
    return {"lines": len(lines), "reads_differing": len(diff), "text_equal": same,
            "first_differing": diff[:5]}


def check_cli_host(genome_fa: str, refs: dict, out_dir) -> dict:
    """Phase 14 (A): command A through the CLI on the card, on phase 4's 256
    FASTA reads: CLI_FLAGS with the read selectors (CLI_HOST_SELECTORS),
    compatibility flags that change nothing (CLI_HOST_COMPAT) and the four
    diagnostic writers. Its -out lines and each side file (-fullMetrics
    less its # line of clock readings; -anchors, whose searches run on the
    card) must equal the JAX CLI's (tools/jax_cli_reference.json
    cli_host): 0 differing reads, the whole text equal; the -fullMetrics
    rows name the reads the JAX CLI selected. The process must launch K1
    without quality, K2 and K3."""
    from blasr_tpu_torch.bench import BENCH_DIR

    ref = refs["cli_host"]
    reads_cli = os.path.join(HERE, ref["reads_file"])
    with open(reads_cli, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    if md5 != ref["reads_md5"]:
        raise AssertionError(f"cli_host: reads md5 {md5} != the reference's {ref['reads_md5']}")
    paths = {kind: os.path.join(BENCH_DIR, f"cli_host.{kind}") for kind in CLI_HOST_SIDE_FILES}
    extra = [*CLI_HOST_SELECTORS, *CLI_HOST_COMPAT,
             *[a for kind in CLI_HOST_SIDE_FILES for a in (f"-{kind}", paths[kind])]]
    out_lines, metrics, secs = run_cli(reads_cli, genome_fa, "cli_host", extra)
    texts = {"out": out_lines}
    for kind, path in paths.items():
        with open(path) as f:
            texts[kind] = [ln for ln in f.read().splitlines()
                           if not (kind == "fullMetrics" and ln.startswith("#"))]
    if out_dir:
        for kind, lines in texts.items():
            with open(os.path.join(out_dir, f"cli_host.{kind}"), "w") as f:
                f.writelines(ln + "\n" for ln in lines)
    log(f"phase 14 (A): CLI {' '.join(extra[:len(CLI_HOST_SELECTORS) + len(CLI_HOST_COMPAT)])} "
        f"with the four side files on {ref['reads_file']}: {len(ref['selected'])} reads selected "
        f"(JAX), {secs:.1f} s (process included)")
    files = {kind: compare_text(kind, lines, ref["files"][kind],
                                side_file_names(kind, lines, ref["selected"]))
             for kind, lines in texts.items()}
    rows = [ln.split()[0] for ln in texts["fullMetrics"][1:]]
    bad = [k for k, v in files.items() if v["reads_differing"] or not v["text_equal"]]
    if bad or rows != ref["selected"]:
        raise AssertionError(f"command A's files differ from the JAX CLI's: {bad}; selected "
                             f"{len(rows)} reads against the JAX CLI's {len(ref['selected'])}")
    dp = metrics["dpLaunches"]
    launches = metrics["kernelLaunches"]
    if not any(k.endswith("/none") for k in dp) or any(not k.endswith("/none") for k in dp) or (
            min(launches.values()) <= 0):
        raise AssertionError(f"command A did not launch K1 without quality, K2 and K3: "
                             f"{launches} {dp}")
    log(f"  launches {launches}, DP {dp}")
    return {"seconds": secs, "selected": len(rows), "files": files, "launches": launches,
            "dp_launches": dp, "index_seconds": metrics["indexLoadSeconds"],
            "map_seconds": metrics["mapSeconds"]}


def check_resume(genome_fa: str, reads_fq: str, refs: dict, out_dir) -> dict:
    """Phase 14 (B): -resume on the card. ``CLI_FLAGS -m 4 -resume`` on the
    CLR FASTQ corpus starts in its own process and is killed (SIGKILL) once
    its manifest reports RESUME_KILL_AFTER batches written; the kill must
    land mid-run (that many batches or more, fewer than all, counted with
    batch_reads). The same command then runs to its end. The file's lines
    must be the JAX CLI's uninterrupted run's (tools/jax_cli_reference.json
    resume): the sorted text equal, no read missing, none repeated, 0
    differing. The resumed process must launch K1 with single quality, K2
    and K3."""
    import signal

    from blasr_tpu_torch.bench import BENCH_DIR
    from blasr_tpu_torch.io.batching import batch_reads, read_records
    from blasr_tpu_torch.pipeline.runner import passes_input_filters

    ref = refs["resume"]
    with open(reads_fq, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    if md5 != ref["reads_md5"]:
        raise AssertionError(f"resume: reads md5 {md5} != the reference's {ref['reads_md5']}")
    params = cli_params(reads_fq, genome_fa)
    reads = [r for r in read_records(reads_fq) if passes_input_filters(r, params)]
    total = len(list(batch_reads(reads, params.batch_size, params.max_read_len)))
    out = os.path.join(BENCH_DIR, "resume.m4")
    manifest = out + ".resume.json"
    for path in (out, manifest):
        if os.path.exists(path):
            os.remove(path)

    def cmd(tag):
        return [sys.executable, "-m", "blasr_tpu_torch.cli.blasr", reads_fq, genome_fa,
                *CLI_FLAGS, "-resume", "-out", out,
                "-metrics", os.path.join(BENCH_DIR, f"resume_{tag}.metrics.json")]

    t0 = time.time()
    with open(os.path.join(BENCH_DIR, "resume_killed.stderr"), "w") as err:
        proc = subprocess.Popen(cmd("killed"), cwd=HERE, stdout=subprocess.DEVNULL, stderr=err)
        state = {}
        try:
            while proc.poll() is None and time.time() - t0 < 600:
                try:
                    with open(manifest) as f:
                        state = json.load(f)
                except (OSError, ValueError):
                    state = {}
                if state.get("batches_done", 0) >= RESUME_KILL_AFTER:
                    break
                time.sleep(0.05)
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
            rc_killed = proc.wait(timeout=120)
    killed_s = time.time() - t0
    with open(manifest) as f:
        state = json.load(f)
    file_bytes = os.path.getsize(out)
    log(f"phase 14 (B): -resume on the CLR FASTQ corpus killed (rc {rc_killed}) after "
        f"{killed_s:.1f} s with {state['batches_done']} of {total} batches written, "
        f"{len(state['deferred'])} reads held back for escalation, -out {file_bytes} bytes "
        f"against the manifest's {state['out_bytes']}")
    if rc_killed != -signal.SIGKILL or not RESUME_KILL_AFTER <= state["batches_done"] < total:
        raise AssertionError(f"the kill did not land mid-run: rc {rc_killed}, "
                             f"{state['batches_done']} of {total} batches written")
    t1 = time.time()
    proc = subprocess.run(cmd("resumed"), cwd=HERE, capture_output=True, text=True,
                          timeout=600)
    resumed_s = time.time() - t1
    if proc.returncode != 0:
        raise AssertionError(f"the resumed CLI failed ({proc.returncode}): "
                             f"{proc.stderr[-2000:]}")
    with open(out) as f:
        lines = f.read().splitlines()
    with open(os.path.join(BENCH_DIR, "resume_resumed.metrics.json")) as f:
        metrics = json.load(f)
    with open(manifest) as f:
        final = json.load(f)
    if out_dir:
        with open(os.path.join(out_dir, "resume.m4"), "w") as f:
            f.writelines(ln + "\n" for ln in lines)
    # best_n 1: one line a read at most, so a read named twice is a repeat
    names = side_file_names("out", lines, None)
    got = m4_digests(zip(names, lines))
    missing = sorted(set(ref["digests"]) - set(got))
    repeated = len(names) - len(set(names))
    diff = sorted(n for n in set(got) | set(ref["digests"])
                  if got.get(n) != ref["digests"].get(n))
    same_sorted = sorted_sha256(lines) == ref["sha256_sorted"]
    log(f"  resumed in {resumed_s:.1f} s (process included; {metrics['stages']['n_batches']} "
        f"batches mapped): {len(lines)} lines (JAX {ref['records']}), {len(missing)} reads "
        f"missing, {repeated} repeated, {len(diff)} differ, sorted sha256 "
        f"{'equal' if same_sorted else 'differs'}; manifest {final['batches_done']} batches, "
        f"{len(final['deferred'])} held back")
    if missing or repeated or diff or not same_sorted:
        raise AssertionError(f"the resumed file is not the JAX CLI's uninterrupted run: "
                             f"{len(missing)} missing, {repeated} repeated, {len(diff)} differ "
                             f"{diff[:5]}")
    dp = metrics["dpLaunches"]
    launches = metrics["kernelLaunches"]
    if not any(k.endswith("/single") for k in dp) or any(
            not k.endswith("/single") for k in dp) or min(launches.values()) <= 0:
        raise AssertionError(f"the resumed process did not launch K1 with single quality, K2 "
                             f"and K3: {launches} {dp}")
    log(f"  resumed process launches {launches}, DP {dp}")
    return {"batches": total, "killed_after_s": killed_s, "killed_at_batches": state["batches_done"],
            "held_back_at_kill": len(state["deferred"]), "out_bytes_at_kill": file_bytes,
            "manifest_out_bytes_at_kill": state["out_bytes"], "resumed_s": resumed_s,
            "resumed_batches": metrics["stages"]["n_batches"], "lines": len(lines),
            "missing": len(missing), "repeated": repeated, "reads_differing": len(diff),
            "launches": launches, "dp_launches": dp}


def pass_counts(met: dict) -> dict:
    """What each pass of a run did, from its metrics (``to_dict`` or the
    CLI's -metrics ``stages``): reads re-mapped and reads changed."""
    levels = {int(k): v for k, v in met.get("expand_levels", {}).items()}
    return {"adaptive": [met["adaptive_reads"], met["adaptive_changed"]],
            **{f"expand{e}": levels.get(e, [0, 0]) for e in (1, 2)},
            "escalated": [met["escalated_reads"], met["escalation_won"]],
            "sensitive": [met["sensitive_reads"], met["sensitive_won"]]}


def check_modes(genome_fa: str, reads, index, refs: dict, out_dir) -> dict:
    """Phase 15, the optional mapping modes. (B) each cell of MODES_CELLS
    through run_mapping in this process at the bench operating point, on
    phase 4's 256 FASTA reads or the modes corpus (one run each with the
    stage clock, plain first), its -m 4 lines held to the JAX package's
    read by read (tools/jax_modes_reference.json, 0 may differ);
    adaptive_cd's lines also equal the plain cell's, and its full-depth
    re-map must take at least one read, as must the sensitive retry on the
    modes corpus; the k = 14 device index is shared by every cell (no
    second copy of its tables). (A) the CLI with MODES_CLI_FLAGS on the
    modes corpus (256 CLR FASTQ reads and four planted reads, k = 12 under
    -useSensitiveSearch), its lines held to the JAX CLI's (0 differing
    reads, the text equal); both expand levels and the sensitive retry must
    re-map at least one read. Each run's kernel launches are kept for the
    kernels line (``launches_modes``)."""
    from blasr_tpu_torch import bench
    from blasr_tpu_torch.io.batching import read_records
    from blasr_tpu_torch.pipeline.mapper import make_device_index

    reads_modes = bench.ensure_modes_corpus()
    corpora = {"fasta": (os.path.join(bench.BENCH_DIR, "reads_cli.fasta"), reads[:256]),
               "modes": (reads_modes, read_records(reads_modes))}
    cache = getattr(index, "_torch_device_index_cache", {})
    make_device_index(index, bench.bench_params(), "cuda")
    n_cached = len(cache)
    cells = {}
    for cell, (corpus, overrides) in MODES_CELLS.items():
        path, cell_reads = corpora[corpus]
        log(f"phase 15 (B): {cell} {overrides} on {os.path.relpath(path, HERE)}:")
        res = map_corpus(index, cell_reads, bench.bench_params(**overrides))
        res["records_vs_jax"] = check_records(cell, res, refs, path, out_dir)
        res["passes"] = pass_counts(res["metrics"])
        log(f"  passes (re-mapped, changed): {res['passes']}")
        cells[cell] = res
    if len(cache) != n_cached:
        raise AssertionError(f"the modes built a second device index: {len(cache)} entries "
                             f"against {n_cached}")
    # exact_chain's loop on the first batch: at the bench point (A = 128,
    # C = 4) and at the sensitive retry's anchors and candidates (A = 256, C = 8)
    chain = {}
    for tag, kw in (("A128", {}), ("A256", {"max_anchors_per_read": 256, "n_candidates": 8})):
        chain[tag] = call_profile("chain_weight_device", index, reads[:256],
                                  bench.bench_params(exact_chain=True, **kw))
        log(f"  exact_chain's loop, one batch at {tag}: {chain[tag]}")
    if refs["adaptive"]["digests"] != refs["plain"]["digests"]:
        raise AssertionError("the JAX reference's adaptive_cd lines differ from its plain ones")
    if cells["adaptive"]["passes"]["adaptive"][0] <= 0:
        raise AssertionError("adaptive_cd re-mapped no read")

    if cells["clr_retry"]["passes"]["sensitive"][0] <= 0:
        raise AssertionError("the sensitive retry re-mapped no read of the modes corpus")
    ref = refs["modes_cli"]
    with open(reads_modes, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    if md5 != ref["reads_md5"]:
        raise AssertionError(f"modes_cli: reads md5 {md5} != the reference's {ref['reads_md5']}")
    lines, metrics, secs = run_cli(reads_modes, genome_fa, "modes_cli", MODES_CLI_FLAGS)
    if out_dir:
        with open(os.path.join(out_dir, "m4_modes_cli.m4"), "w") as f:
            f.writelines(ln + "\n" for ln in lines)
    log(f"phase 15 (A): CLI {' '.join(MODES_CLI_FLAGS)} on {ref['reads_file']}: {secs:.1f} s "
        f"(process included; index {metrics['indexLoadSeconds']} s, mapping "
        f"{metrics['mapSeconds']} s)")
    cli = compare_text("modes_cli", lines, ref, side_file_names("out", lines, None))
    passes = pass_counts(metrics["stages"])
    mapped = set(side_file_names("out", lines, None))
    planted = sorted(n for n in mapped if n.startswith("planted/"))
    log(f"  passes (re-mapped, changed): {passes}; planted reads mapped {planted} (JAX "
        f"{ref['planted_mapped']})")
    if cli["reads_differing"] or not cli["text_equal"]:
        raise AssertionError(f"the modes CLI's lines differ from the JAX CLI's: {cli}")
    idle = [p for p in ("expand1", "expand2", "sensitive") if passes[p][0] <= 0]
    if idle:
        raise AssertionError(f"passes that re-mapped no read in the modes CLI run: {idle}")
    launches = {cell: res["launches"] for cell, res in cells.items()}
    launches["modes_cli"] = metrics["kernelLaunches"]
    dp = {cell: res["dp_launches"] for cell, res in cells.items()}
    dp["modes_cli"] = metrics["dpLaunches"]
    plain = {"fasta": cells["plain"]["reads_per_s"][0],
             "modes": cells["clr_plain"]["reads_per_s"][0]}
    log("  reads/s against the plain cell of the same reads (stage clock on in each): "
        + ", ".join(f"{cell} {res['reads_per_s'][0]:.1f} "
                    f"({res['reads_per_s'][0] / plain[MODES_CELLS[cell][0]]:.2f}x)"
                    for cell, res in cells.items()))
    return {"cells": cells, "chain_profile": chain,
            "cli": {**cli, "seconds": secs, "passes": passes,
                                    "planted_mapped": planted,
                                    "index_seconds": metrics["indexLoadSeconds"],
                                    "map_seconds": metrics["mapSeconds"],
                                    "stages": metrics["stages"]},
            "launches": launches, "dp_launches": dp}


def run(out_path: str | None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "blasr_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository (blasr_tpu_torch/ missing)",
              file=sys.stderr)
        return 1
    from blasr_tpu_torch import bench, native
    from blasr_tpu_torch.io.batching import read_records
    from blasr_tpu_torch.ops import _build
    from blasr_tpu_torch.pipeline.mapper import make_device_index

    t_start = time.time()
    phase_times = {}   # phase -> seconds into the run when it started

    def mark(phase: str) -> None:
        phase_times[phase] = time.time() - t_start
        log(f"phase {phase} at {phase_times[phase]:.0f} s")

    # ---- phase 1: card, versions, build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.time()
    _build.load_library()
    log(f"kernel build {time.time() - t0:.1f} s (compilers {_build.BUILD_SECONDS:.1f} s, in "
        f"parallel) -> " + ", ".join(
            os.path.relpath(_build.library_path(s), HERE) for s in _build.CUDA_SOURCES))
    index_path = ("C++ SA-IS (csrc/host_native.cpp, " + os.path.relpath(
        _build.library_path(_build.HOST_SOURCE), HERE) + ")"
        if native.available() else "numpy prefix doubling (no g++: the plain version)")
    log(f"host helpers: {index_path}")

    # ---- phase 2: corpora and index ----
    mark("2")
    refs = load_references()
    out_dir = os.path.dirname(os.path.abspath(out_path)) if out_path else None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    genome_fa, reads_fa = bench.ensure_corpus()
    reads_fq = bench.ensure_fastq_corpus()
    with open(reads_fq, "rb") as f:
        fq_md5 = hashlib.md5(f.read()).hexdigest()
    if fq_md5 != CLR_FASTQ_MD5:
        raise AssertionError(f"CLR FASTQ corpus md5 {fq_md5} != {CLR_FASTQ_MD5}: not the "
                             "corpus of the JAX package's accuracy figure")
    index = bench.load_bench_index(genome_fa)
    reads = bench.load_reads(reads_fa)
    clr_reads = read_records(reads_fq)
    params = bench.bench_params()
    log(f"corpora + k=14 index {time.time() - t0:.1f} s (suffix array by {index_path}): "
        f"genome {index.genome_length} bp, {len(reads)} FASTA reads, {len(clr_reads)} CLR "
        f"FASTQ reads (md5 {fq_md5})")

    # ---- phase 3: kernels against their plain versions ----
    mark("3")
    windows = {L: dp_windows(index.genome, clr_reads, L, seed=100 + 4 * i)
               for i, L in enumerate((1024, 3328))}
    dp_rows = check_dp(windows)
    guided_rows = check_dp_guided(windows)
    matrix_rows = check_dp_matrix(windows)
    del windows
    t0 = time.time()
    di = make_device_index(index, params, "cuda")
    torch.cuda.synchronize()
    log(f"device index (direct 4^14 tables) {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    g_rows = check_gathers(di.genome_pad)
    micro_rows = check_micro_dma()
    micro_launches = micro_dma_path()
    log(f"K2' on the microbenchmark's path: {micro_launches} launches of K2's kernel "
        f"(spans {MICRO_DMA_SPANS})")
    del di

    # ---- phase 4: the FASTA bench corpus, the CLI, a profile ----
    mark("4")
    log("FASTA bench corpus through run_mapping on the card:")
    fasta = map_corpus(index, reads, params, warmup=True)
    fasta["records_vs_jax"] = check_records("fasta", fasta, refs, reads_fa, out_dir)
    cli = check_cli(genome_fa, reads, index)
    if fasta["accuracy_true_locus"] < MIN_ACCURACY:
        raise AssertionError(f"accuracy_true_locus {fasta['accuracy_true_locus']:.4f} < {MIN_ACCURACY}")
    missing = [k for k, v in fasta["launches"].items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the FASTA path: {missing}")
    prof = profile_batch(index, reads, params)

    # ---- phase 5: the CLR FASTQ corpus ----
    mark("5")
    log("CLR FASTQ corpus through run_mapping on the card:")
    fastq = map_corpus(index, clr_reads, params)
    fastq["records_vs_jax"] = check_records("clr", fastq, refs, reads_fq, out_dir)
    min_acc = JAX_CLR_ACCURACY - CLR_ACCURACY_SLACK
    if fastq["accuracy_true_locus"] < min_acc:
        raise AssertionError(f"CLR accuracy_true_locus {fastq['accuracy_true_locus']:.4f} < "
                             f"{min_acc:.3f} (JAX package on the CPU: {JAX_CLR_ACCURACY})")
    missing = [k for k, v in fastq["launches"].items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the FASTQ path: {missing}")
    single = fastq["dp_launches"]
    if single.get("W32/single", 0) == 0 or not any(
            single.get(f"W{w}/single", 0) for w in (128, 256)):
        raise AssertionError(f"single-quality DP kernel not run at W=32 and W>=128: {single}")
    if any(not k.endswith("/single") for k in single):
        raise AssertionError(f"the FASTQ path ran a DP mode other than single: {single}")
    log(f"CLR accuracy {fastq['accuracy_true_locus']:.4f} >= {min_acc:.3f} (JAX package on "
        f"the CPU {JAX_CLR_ACCURACY}); single-quality DP at W=32 and W>=128: {single}")

    # ---- phase 6: the CLI on SAM reads with iq/sq tracks ----
    mark("6")
    sam = check_cli_sam(genome_fa, clr_reads, index)

    # ---- phase 7: guided bands on the CLR FASTQ corpus ----
    mark("7")
    guided = check_guided(genome_fa, reads_fq, clr_reads, index, fastq)
    guided["records_vs_jax"] = check_records("clr_guided", guided, refs, reads_fq, out_dir)

    # ---- phase 8: -scoreMatrix through the CLI ----
    mark("8")
    matrix = check_matrix(genome_fa, reads, index, cli)

    # ---- phase 9: config 3, -bestn 2 -m 5 ----
    mark("9")
    config3 = check_config3(genome_fa, reads_fa, reads, index, refs, out_dir, fasta, cli)

    # ---- phase 10: config 2, -sam -clipping soft on the CLR FASTQ corpus ----
    mark("10")
    config2 = check_config2(reads_fq, clr_reads, index, refs, out_dir, fastq)

    # ---- phase 11: config 4, -bwt -m 4 on the FASTA corpus ----
    mark("11")
    config4 = check_config4(genome_fa, reads_fa, reads, index, refs, out_dir, cli)

    # ---- phase 12: seeds of k = 15 and k = 18, -sa and -nucmer ----
    mark("12")
    sa_seeds = check_sa_seeds(genome_fa, reads_fa, reads, index, refs, out_dir, cli)

    # ---- phase 13: piecewise mapping, config 5 and reads above max_read_len ----
    mark("13")
    piecewise = check_piecewise(genome_fa, index, refs, out_dir)

    # ---- phase 14: the CLI's host surface: selectors, compatibility flags,
    # diagnostic writers, and -resume killed and resumed ----
    mark("14")
    cli_host = check_cli_host(genome_fa, refs, out_dir)
    resume = check_resume(genome_fa, reads_fq, refs, out_dir)
    phase14_s = time.time() - t_start - phase_times["14"]
    log(f"phase 14: {phase14_s:.1f} s")

    # ---- phase 15: the optional mapping modes ----
    mark("15")
    modes = check_modes(genome_fa, reads, index, refs, out_dir)
    phase15_s = time.time() - t_start - phase_times["15"]
    log(f"phase 15: {phase15_s:.1f} s")

    # ---- the kernels line ----
    def dp_row(mode):
        return next(r for r in dp_rows if (r["W"], r["L"], r["mode"]) == (*MAIN_DP_SHAPE, mode))

    # each kernel's launches on its own path: the quality-free DP on the
    # FASTA corpus, the single-quality DP and both gathers on config 2
    dp_launches = {
        "none": fasta["launches"]["banded_dp"],
        "single": sum(config2["dp_launches"].values()),
        "dual": sum(n for k, n in sam["dp_launches"].items() if k.endswith("/dual")),
    }
    # each kernel's launches on each run of phase 15: the quality-free DP on
    # the FASTA cells, the single-quality DP on the CLI's FASTQ reads
    def modes_launches(name, mode=None):
        if mode is None:
            return {cell: n[name] for cell, n in modes["launches"].items()}
        return {cell: sum(v for k, v in dp.items() if k.endswith("/" + mode))
                for cell, dp in modes["dp_launches"].items()
                if any(k.endswith("/" + mode) for k in dp)}

    kernels = []
    for mode in QUAL_MODES:
        row = dp_row(mode)
        src, replaces = KERNEL_META["banded_dp"]
        kernels.append({
            "name": "banded_dp" if mode == "none" else f"banded_dp[qual={mode}]",
            "route": "cuda", "source": src, "replaces": replaces,
            "launches": dp_launches[mode],
            **({"launches_config4": config4["launches"]["banded_dp"],
                "launches_k15": sa_seeds["k15"]["launches"]["banded_dp"],
                "launches_k18": sa_seeds["k18"]["launches"]["banded_dp"],
                "launches_config5": piecewise["config5"]["launches"]["banded_dp"],
                "launches_long": piecewise["long"]["launches"]["banded_dp"],
                "launches_cli_host": cli_host["launches"]["banded_dp"]}
               if mode == "none" else {}),
            **({"launches_resume": resume["launches"]["banded_dp"]} if mode == "single" else {}),
            **({"launches_modes": modes_launches("banded_dp", mode)}
               if mode in ("none", "single") else {}),
            "max_abs_err": max(r["max_abs_err"] for r in dp_rows if r["mode"] == mode),
            "ms": row["ms"], "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
        })
    for name in ("gather_spans", "gather_rows"):
        row = g_rows[name][0]
        src, replaces = KERNEL_META[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": config2["launches"][name],
            "launches_config4": config4["launches"][name],
            "launches_k15": sa_seeds["k15"]["launches"][name],
            "launches_k18": sa_seeds["k18"]["launches"][name],
            "launches_config5": piecewise["config5"]["launches"][name],
            "launches_long": piecewise["long"]["launches"][name],
            "launches_cli_host": cli_host["launches"][name],
            "launches_resume": resume["launches"][name],
            "launches_modes": modes_launches(name),
            "max_abs_err": max(r["max_abs_err"] for r in g_rows[name]),
            "ms": row["ms"], "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "library_device_ms": row["library_device_ms"],
        })
    row = micro_rows[0]
    src, replaces = KERNEL_META["gather_spans[micro_dma]"]
    kernels.append({
        "name": "gather_spans[micro_dma]", "route": "cuda", "source": src, "replaces": replaces,
        # K2's kernel on the microbenchmark's own path, not the CLR run's
        "launches": micro_launches,
        "max_abs_err": max(r["max_abs_err"] for r in micro_rows),
        "ms": row["ms"], "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "library_device_ms": row["library_device_ms"],
    })
    for name, rows, launches in (
            ("banded_dp[guided]", guided_rows,
             sum(n for k, n in guided["dp_launches"].items() if k.endswith("/guided"))),
            ("banded_dp[matrix]", matrix_rows, matrix["launches"])):
        row = next(r for r in rows if (r["W"], r["L"]) == MAIN_DP_SHAPE)
        src, replaces = KERNEL_META[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"], "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
        })
    if any(k["launches"] <= 0 or min(k.get(f"launches_{c}", 1) for c in (
            "config4", "k15", "k18", "config5", "long", "cli_host", "resume")) <= 0
           or min(k.get("launches_modes", {"-": 1}).values()) <= 0
           for k in kernels):
        raise AssertionError(f"a kernel never ran on its path: {kernels}")
    fastq_runs = {"modes_cli", *(c for c, (corpus, _) in MODES_CELLS.items()
                                 if corpus == "modes")}
    if set(modes_launches("banded_dp", "single")) != fastq_runs or set(
            modes_launches("banded_dp", "none")) != set(MODES_CELLS) - fastq_runs:
        raise AssertionError(f"phase 15 ran other DP modes than its paths': {modes['dp_launches']}")
    log(f"total {time.time() - t_start:.0f} s")
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({
                "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                "host_helpers": index_path, "dp": dp_rows, "dp_guided": guided_rows,
                "dp_matrix": matrix_rows, "gathers": g_rows, "micro_dma": micro_rows,
                "micro_dma_launches": micro_launches,
                "fasta": fasta, "cli": {k: v for k, v in cli.items() if k != "m4"},
                "profile": prof, "fastq": fastq, "cli_sam": sam, "guided": guided,
                "matrix": matrix, "config3": config3, "config2": config2, "config4": config4,
                "sa_seeds": sa_seeds, "piecewise": piecewise, "cli_host": cli_host,
                "resume": resume, "phase14_s": phase14_s, "modes": modes,
                "phase15_s": phase15_s, "phase_start_s": phase_times,
                "jax_clr_accuracy_cpu": JAX_CLR_ACCURACY,
                "jax_guided_accuracy_cpu": JAX_GUIDED_ACCURACY,
                "seconds": time.time() - t_start,
            }, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write every measurement as JSON here")
    args = ap.parse_args()
    try:
        import torch  # noqa: F401
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    return run(args.out)


if __name__ == "__main__":
    sys.exit(main())
