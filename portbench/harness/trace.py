"""The traced run's readings: a part of one chunk under torch.profiler
and a part of another under the program's stage clock, so that the
clock's synchronisations do not enter the idle share.

The profiled part gives the device's busy time (the union of its
kernels, copies and fills), the kernel launches, the DP kernel's time
and, from the DP calls' own inputs, the work those needed
(``k1work``); the top device operations and the longest idle gaps,
named by the host operation the profiler shows running in each.
"""

from __future__ import annotations

import bisect
import time

from portbench.harness import k1work

DP_KERNEL = "banded_dp_kernel"


def _qual_mode(qual) -> str:
    if qual is None:
        return "none"
    return "dual" if str(qual.dtype) == "torch.int16" else "single"


def profiled_chunk(run, chunk) -> dict:
    """Map ``chunk`` once without the profiler (its wall time), then under
    it; the readings of the device."""
    from torch.profiler import ProfilerActivity, profile

    from blasr_tpu_torch.pipeline import mapper as mapper_mod

    calls = []
    dp = mapper_mod.banded_align

    def counted(*args, **kw):
        qual = args[6] if len(args) > 6 else kw.get("qual")
        knots = kw.get("knots")
        calls.append((args[1], int(args[0].shape[1]), int(args[2].shape[1]),
                      int(kw.get("band_width", 128)), _qual_mode(qual),
                      kw["scores"].matrix is not None if "scores" in kw else False,
                      bool(kw.get("with_traceback", False)),
                      0 if knots is None else int(knots.shape[1])))
        return dp(*args, **kw)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.cuda else [])
    run._sync()
    t0 = time.perf_counter()
    run._map(chunk, run.MappingMetrics())
    run._sync()
    plain_s = time.perf_counter() - t0
    mapper_mod.banded_align = counted
    try:
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            run._map(chunk, run.MappingMetrics())
            run._sync()
        span_s = time.perf_counter() - t0
    finally:
        mapper_mod.banded_align = dp
    t_read = time.perf_counter()
    dev_ev, cpu_ev = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        (dev_ev if kind.endswith("CUDA") else cpu_ev).append(row)
    out = {"span_s": span_s, "plain_s": plain_s, "k1_calls": len(calls)}
    kernels = [r for r in dev_ev if not r[0].startswith(("Memcpy", "Memset"))]
    out["launches"] = len(kernels)
    if dev_ev:
        busy, gaps = _busy_and_gaps(dev_ev)
        out["busy_s"] = busy
        by_name: dict = {}
        for name, a, b in dev_ev:
            by_name[name] = by_name.get(name, 0) + (b - a)
        out["device_ops"] = [[n[:120], v / 1e9] for n, v in
                             sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
        out["idle_gaps"] = _name_gaps(gaps, cpu_ev)
        k1_ns = sum(b - a for n, a, b in kernels if DP_KERNEL in n)
        cells = ops = nbytes = 0
        for qlen, L, T, W, mode, matrix, tb, nk in calls:
            c, o, by = k1work.call_work(qlen.cpu().tolist(), L, T, W, mode, matrix, tb, nk)
            cells += c
            ops += o
            nbytes += by
        out["k1"] = {"device_s": k1_ns / 1e9, "cells": cells, "ops": ops, "bytes": nbytes}
    out["read_s"] = time.perf_counter() - t_read
    return out


def _busy_and_gaps(dev_ev):
    """Seconds covered by device operations, and the idle gaps between them
    as (start_ns, end_ns)."""
    iv = sorted((a, b) for _, a, b in dev_ev)
    busy = 0
    gaps = []
    cur_a, cur_b = iv[0]
    for a, b in iv[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    return busy / 1e9, gaps


def _name_gaps(gaps, cpu_ev, top: int = 10, look: int = 4000):
    """The idle time summed by the innermost host operation running at each
    gap's middle, over the ``look`` longest gaps; the ``top`` names."""
    cpu = sorted(cpu_ev, key=lambda r: r[1])
    starts = [r[1] for r in cpu]
    total: dict = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:look]:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        name, width = "host, outside any traced op", None
        for j in range(i - 1, max(-1, i - 200), -1):
            n, s, e = cpu[j]
            if e >= mid and (width is None or e - s < width):
                name, width = n, e - s
        total[name] = total.get(name, 0) + (b - a)
    return [[n[:120], v / 1e9] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def clocked_chunk(run, chunk) -> dict:
    """Map ``chunk`` with the program's stage clock: seconds per stage."""
    import torch

    from blasr_tpu_torch.pipeline.mapper import StageClock

    clock = StageClock(torch.device(run.device))
    run._map(chunk, run.MappingMetrics(), clock=clock)
    return dict(clock.seconds)
