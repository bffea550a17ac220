#!/usr/bin/env python3
"""CUDA-event times of the banded DP kernel's shared-schedule modes, for an
A/B comparison of two checkouts on one card.

    PYTHONPATH=<checkout> python3 tools/dp_kernel_times.py [--reps N]

Times ``blasr_tpu_torch.ops.banded_cuda.banded_align`` of whichever
checkout ``PYTHONPATH`` names (the kernel is built from that checkout's
``csrc/``), with arrows, at I = 512 items, W = 32, 128, 256, L = 1024 and
3328, without quality values and with a single quality stream, on seeded
random reads embedded in random targets with the drift-slope schedule. It
uses only the wrapper's shared-schedule call, which every checkout of the
port has, so run it in turns over two checkouts in one call (parent,
change, change, parent) to compare them on the same card; unpack the
other commit with ``git archive`` into ``checkouts/`` (ignored by git).
Prints one JSON
line: the card, the checkout's package path, and the mean ms per shape.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    import blasr_tpu_torch
    from blasr_tpu_torch.ops.banded_align import make_qoff_num
    from blasr_tpu_torch.ops.banded_cuda import banded_align

    if not torch.cuda.is_available():
        print("dp_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    I, pad2 = 512, 128
    times = {}
    for L in (1024, 3328):
        T = L + 2 * pad2
        rng = np.random.default_rng(L)
        Q = rng.integers(0, 4, (I, L)).astype(np.uint8)
        Tg = rng.integers(0, 4, (I, T)).astype(np.uint8)
        mut = rng.random((I, L)) < 0.1
        Tg[:, pad2 : pad2 + L] = np.where(mut, (Q + 1) % 4, Q)
        qual = rng.integers(3, 40, (I, L)).astype(np.uint8)
        base = [torch.from_numpy(Q).to(dev), torch.full((I,), L, dtype=torch.int32, device=dev),
                torch.from_numpy(Tg).to(dev), torch.zeros(I, dtype=torch.int32, device=dev),
                torch.full((I,), T, dtype=torch.int32, device=dev)]
        for W in (32, 128, 256):
            qoff = make_qoff_num(L, T, W, pad2, round(65536 / 1.96), device=dev)
            for mode, q in (("none", None), ("single", torch.from_numpy(qual).to(dev))):
                def call():
                    banded_align(*base, qoff, q, with_traceback=True, band_width=W)

                call()
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(args.reps):
                    call()
                e1.record()
                torch.cuda.synchronize()
                times[f"W{W}/L{L}/{mode}"] = e0.elapsed_time(e1) / args.reps
    print(json.dumps({"card": card, "package": blasr_tpu_torch.__file__, "ms": times}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
