#!/usr/bin/env python3
"""Device times of the banded DP kernel in every mode, for an A/B comparison
of two checkouts on one card.

    PYTHONPATH=<checkout> python3 tools/dp_kernel_times.py [--reps N] [--out FILE]

Times ``blasr_tpu_torch.ops.banded_cuda.banded_align`` of whichever
checkout ``PYTHONPATH`` names (the kernel is built from that checkout's
``csrc/``), with arrows, at I = 512 items, W = 32, 64, 128, 256 and
L = 1024, 3328 (T = L + 256), in every mode: quality none, single (uint8)
and dual (uint16 with high bytes >= 128) x the shared schedule and guided
knots (wandering off the shared line as far as the reference's clamp) x
the default scores and a transition-favouring score matrix. The inputs are
seeded random reads with 10% substitutions embedded in random targets and
the drift-slope schedule. Each shape's time is the device's alone: CUDA
events around one replay of a CUDA graph holding ``reps`` calls, the median
of three replays. It uses only the wrapper's signature that every
checkout of the port since guided bands has, so run it in turns over two
checkouts in one call (parent, change, change, parent) to compare them on
the same card; unpack the other commit with ``git archive`` into
``checkouts/`` (ignored by git). Prints one JSON line (and appends it to
``--out``): the card, the checkout's package path, and per shape the
device ms, the ns per anti-diagonal step and the bound of
``chip_smoke.dp_bound`` (the repository root's, whatever the checkout).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# chip_smoke.py (dp_bound) from this repository's root, after the package
# that PYTHONPATH names
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRANSITION_MATRIX = (-5, 6, -2, 6, 0, 6, -5, 6, -2, 0, -2, 6, -5, 6, 0,
                     6, -2, 6, -5, 0, 0, 0, 0, 0, 0)
PAD2, NUM, I = 128, round(65536 / 1.96), 512


def graph_ms(fn, reps: int, rounds: int = 3) -> float:
    """Device ms per call: one CUDA-graph replay of ``reps`` calls, median
    over ``rounds`` replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
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


def inputs(L: int, dev):
    """(query, qlen, target, tlo, thi) and the single and dual quality
    streams of one bucket, on the card."""
    import numpy as np
    import torch

    T = L + 2 * PAD2
    rng = np.random.default_rng(L)
    Q = rng.integers(0, 4, (I, L)).astype(np.uint8)
    Tg = rng.integers(0, 4, (I, T)).astype(np.uint8)
    mut = rng.random((I, L)) < 0.1
    Tg[:, PAD2 : PAD2 + L] = np.where(mut, (Q + 1) % 4, Q)
    qual = rng.integers(3, 40, (I, L)).astype(np.uint8)
    dual = (qual.astype(np.uint16) | (((qual.astype(np.uint16) * 9) % 256) << 8)).view(np.int16)
    base = [torch.from_numpy(Q).to(dev), torch.full((I,), L, dtype=torch.int32, device=dev),
            torch.from_numpy(Tg).to(dev), torch.zeros(I, dtype=torch.int32, device=dev),
            torch.full((I,), T, dtype=torch.int32, device=dev)]
    quals = {"none": None, "single": torch.from_numpy(qual).to(dev),
             "dual": torch.from_numpy(dual).to(dev)}
    return base, quals


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = ap.parse_args()

    import torch

    import blasr_tpu_torch
    from blasr_tpu_torch import bench
    from chip_smoke import dp_bound
    from blasr_tpu_torch.ops.banded_align import AlignScores, make_qoff_num
    from blasr_tpu_torch.ops.banded_cuda import banded_align

    if not torch.cuda.is_available():
        print("dp_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rows = {}
    for L in (1024, 3328):
        base, quals = inputs(L, dev)
        T = L + 2 * PAD2
        S = L + T - 1
        for W in (32, 64, 128, 256):
            qoff = make_qoff_num(L, T, W, PAD2, NUM, device=dev)
            knots = bench.deviating_knots(I, L, T, W, PAD2, NUM, seed=W + L, device=dev)
            for sched in ("shared", "guided"):
                for scores in ("default", "matrix"):
                    sc = AlignScores(matrix=TRANSITION_MATRIX if scores == "matrix" else None)
                    for mode, q in quals.items():
                        def call():
                            if sched == "shared":
                                banded_align(*base, qoff, q, scores=sc, with_traceback=True,
                                             band_width=W)
                            else:
                                banded_align(*base, None, q, knots=knots, scores=sc,
                                             with_traceback=True, band_width=W)

                        ms = graph_ms(call, args.reps)
                        b_ms, b_by = dp_bound(I, L, T, W, mode, guided=sched == "guided",
                                              matrix=scores == "matrix")
                        rows[f"W{W}/L{L}/{mode}/{sched}/{scores}"] = {
                            "device_ms": ms, "ns_per_step": ms * 1e6 / S, "S": S,
                            "bound_ms": b_ms, "bound_by": b_by}
    line = json.dumps({"card": card, "package": blasr_tpu_torch.__file__, "dp": rows})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
