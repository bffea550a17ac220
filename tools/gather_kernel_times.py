#!/usr/bin/env python3
"""Per-call, device and host times of the span and row gathers, for an A/B
comparison of two checkouts on one card.

    PYTHONPATH=<checkout> python3 tools/gather_kernel_times.py [--reps N] [--rounds N]

Times ``blasr_tpu_torch.ops.gather.gather_spans`` and ``gather_rows`` of
whichever checkout ``PYTHONPATH`` names (the kernels are built from that
checkout's ``csrc/``) and the one PyTorch call that computes each (an
advanced index on the clipped indices, ``index_select`` on the clipped
rows), at the shapes ``chip_smoke.py`` times: the span gather at the DP
buckets' spans 162 and 450 (I = 512, four starts clipped at the ends) and
at the TPU microbenchmark's spans 162 and 482 (``scripts/micro_dma.py``),
the row gather at rows of 256, 128 and 416 words (two rows clipped), and
the span gather on one item of one word (what a launch costs with no
work). Each shape gives, for the wrapper and for the PyTorch call:

- ``ms``: per call, CUDA events around ``--reps`` calls back to back;
- ``host_us``: the host's clock around the same calls (no
  synchronisation inside), the runs of the two taken in turns
  ``--rounds`` times, the median of each;
- ``device_ms``: per call, CUDA events around one replay of a CUDA graph
  that holds ``--reps`` calls, the median of 5 replays (the host's launch
  work is done at capture, so a replay times the device alone).

It also times, in host µs per call over 2000 calls with nothing launched,
the pieces of a launch path: the span launcher's ctypes call with no item
(for launchers that take their arguments as one array of int64 values,
the array's fill and the call), ``torch.cuda.current_stream(i).cuda_stream``
against ``torch._C._cuda_getCurrentRawStream(i)``, the library lookup
(``load_library``) and ``torch.empty(device=)`` against ``new_empty``.

It uses only what every checkout of the port has, so run it in turns over
two checkouts in one call (parent, change, change, parent) to compare them
on the same card; unpack the other commit with ``git archive`` into
``checkouts/`` (ignored by git). Prints one JSON line: the card, the
checkout's package path, the pieces and the times per shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time

ITEMS = 512
WORDS = 600_064  # the span gather's source: micro_dma.py's genome words


def cases(dev) -> dict:
    """{name: (kind, source, index, span)} on seeded random words."""
    import numpy as np
    import torch

    rng = np.random.default_rng(9)
    src = torch.from_numpy(rng.integers(0, 2**31 - 1, WORDS).astype(np.int32)).to(dev)
    out = {}
    for span in (162, 450):
        starts = rng.integers(0, WORDS - span, ITEMS).astype(np.int32)
        starts[:4] = [-3, -span - 7, WORDS - 1, WORDS + 40]
        out[f"K2 span {span}"] = ("spans", src, torch.from_numpy(starts).to(dev), span)
    for span in (162, 482):
        starts = rng.integers(0, WORDS - span - 128, ITEMS).astype(np.int32)
        out[f"K2' span {span}"] = ("spans", src, torch.from_numpy(starts).to(dev), span)
    for Lr in (256, 128, 416):
        src2 = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (ITEMS, Lr)).astype(np.int32))
        rows = rng.integers(0, ITEMS, ITEMS).astype(np.int32)
        rows[:2] = [-1, ITEMS + 3]
        out[f"K3 Lr {Lr}"] = ("rows", src2.to(dev), torch.from_numpy(rows).to(dev), Lr)
    out["K2 I=1 span 1"] = ("spans", src, torch.tensor([5], dtype=torch.int32, device=dev), 1)
    return out


def graph_ms(fn, reps: int) -> float:
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
    for _ in range(5):
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        means.append(e0.elapsed_time(e1) / reps)
    return statistics.median(means)


def interleaved(fns: dict, reps: int, rounds: int) -> dict:
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    ms = {k: [] for k in fns}
    us = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            e0.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            t1 = time.perf_counter()
            e1.record()
            torch.cuda.synchronize()
            ms[k].append(e0.elapsed_time(e1) / reps)
            us[k].append((t1 - t0) / reps * 1e6)
    res = {}
    for k, fn in fns.items():
        res[k + "ms"] = statistics.median(ms[k])
        res[k + "host_us"] = statistics.median(us[k])
        res[k + "device_ms"] = graph_ms(fn, reps)
    return res


def host_us(fn, reps: int = 2000) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def launch_path(dev) -> dict:
    """Host µs per call of the pieces of a launch path, nothing launched."""
    import torch

    from blasr_tpu_torch.ops import _build

    lib = _build.load_library()
    fn = lib.gather_spans_launch
    src = torch.zeros(WORDS, dtype=torch.int32, device=dev)
    starts = torch.zeros(ITEMS, dtype=torch.int32, device=dev)
    out = torch.empty((ITEMS, 162), dtype=torch.int32, device=dev)
    idx = src.get_device()
    raw = torch._C._cuda_getCurrentRawStream
    if len(fn.argtypes) == 1:  # the arguments as one array of int64 values
        buf = (ctypes.c_longlong * 8)()
        addr = ctypes.addressof(buf)

        def call():
            buf[:7] = (src.data_ptr(), WORDS, starts.data_ptr(), out.data_ptr(), 0, 162, raw(idx))
            return fn(addr)
    else:
        def call():
            return fn(src.data_ptr(), WORDS, starts.data_ptr(), out.data_ptr(), 0, 162, raw(idx))

    abi = f"{len(fn.argtypes)} argument(s)"
    pieces = {
        f"launcher ctypes call, no item ({abi})": call,
        "current_stream(i).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_cuda_getCurrentRawStream(i)": lambda: raw(idx),
        "load_library()": _build.load_library,
        "torch.empty(device=)": lambda: torch.empty((ITEMS, 162), dtype=torch.int32, device=dev),
        "new_empty": lambda: src.new_empty((ITEMS, 162)),
    }
    return {name: host_us(f) for name, f in pieces.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=11)
    args = ap.parse_args()

    import torch

    import blasr_tpu_torch
    from blasr_tpu_torch.ops.gather import gather_rows, gather_spans

    if not torch.cuda.is_available():
        print("gather_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    times = {}
    for name, (kind, src, idx, span) in cases(dev).items():
        if kind == "spans":
            pos = torch.clamp(idx.long()[:, None] + torch.arange(span, device=dev)[None, :],
                              0, src.shape[0] - 1)

            def kernel():
                return gather_spans(src, idx, span)

            def library():
                return src[pos]
        else:
            rows_c = torch.clamp(idx.long(), 0, src.shape[0] - 1)

            def kernel():
                return gather_rows(src, idx)

            def library():
                return torch.index_select(src, 0, rows_c)
        if not torch.equal(kernel(), library()):
            raise AssertionError(f"{name}: the kernel disagrees with the PyTorch call")
        times[name] = interleaved({"": kernel, "library_": library}, args.reps, args.rounds)
    print(json.dumps({"card": card, "package": blasr_tpu_torch.__file__,
                      "host_us": launch_path(dev), "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
