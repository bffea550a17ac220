"""The device's idle time in a traced part, put down to the program's own
spans (``blasr_tpu_torch.pipeline.trace.StageClock(device, sync=False)``),
and the passes that read it.

``profiled_spans`` maps a part under torch.profiler with the tracer on and
hands each idle gap between device operations (``trace._busy_and_gaps``)
to ``idle_by_span``: every stretch of a gap goes to the innermost span
that covers it, clipped at span edges, or to ``OUTSIDE``. ``spanned_pass``
maps the part with the tracer on and no profiler: the host's waits for
the device (``ops.counters()``) over the part's DP calls, each span's self
seconds, and the wall time against an untraced pass of the same reads.
"""

from __future__ import annotations

import bisect
import time

OUTSIDE = "outside any program span"


def _depths(spans) -> list[int]:
    depth = []
    for s in spans:
        depth.append(0 if s.parent < 0 else depth[s.parent] + 1)
    return depth


def span_intervals(clock) -> list[tuple[int, int, int, str]]:
    """(start, end, depth, name) of the tracer's closed spans on the
    profiler's clock, Unix-epoch nanoseconds (torch 2.11 and 2.13)."""
    return [(clock.to_wall_ns(s.start_ns), clock.to_wall_ns(s.end_ns), d, s.name)
            for s, d in zip(clock.spans, _depths(clock.spans)) if s.end_ns > s.start_ns]


def idle_by_span(gaps, intervals) -> dict[str, float]:
    """Seconds of the idle ``gaps`` ((start_ns, end_ns)) under each span
    name of ``intervals`` ((start, end, depth, name)): each stretch goes to
    the innermost span covering it (the deepest; among equals the latest
    to start), the rest to ``OUTSIDE``."""
    cuts = sorted({t for a, b, _, _ in intervals for t in (a, b)})
    # the innermost span of each elementary stretch [cuts[i], cuts[i + 1])
    order = sorted(intervals)
    owner, active, j = [], [], 0
    for lo in cuts[:-1]:
        while j < len(order) and order[j][0] <= lo:
            active.append(order[j])
            j += 1
        active = [iv for iv in active if iv[1] > lo]
        best = max(active, key=lambda iv: (iv[2], iv[0]), default=None)
        owner.append(OUTSIDE if best is None else best[3])
    out: dict[str, float] = {}

    def add(name, ns):
        if ns > 0:
            out[name] = out.get(name, 0.0) + ns * 1e-9

    for a, b in gaps:
        i = bisect.bisect_right(cuts, a) - 1
        t = a
        while t < b:
            if i < 0:
                nxt = cuts[0] if cuts else b
                name = OUTSIDE
            elif i >= len(owner):
                nxt, name = b, OUTSIDE
            else:
                nxt, name = cuts[i + 1], owner[i]
            end = min(b, nxt)
            add(name, end - t)
            t = end
            i += 1
    return out


def profiled_spans(run, chunk) -> dict:
    """Map ``chunk`` under torch.profiler with the tracer on, no
    synchronisation: launches, DP calls, busy seconds, the idle time by
    span, and the first and last device event against the outermost spans
    (on the profiler's clock)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blasr_tpu_torch import ops
    from blasr_tpu_torch.pipeline.trace import StageClock
    from portbench.harness.trace import _busy_and_gaps

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.cuda else [])
    clock = StageClock(torch.device(run.device), sync=False)
    dp0 = ops.launch_counts()["banded_dp"]
    run._sync()
    with profile(activities=acts) as prof:
        run._map(chunk, run.MappingMetrics(), clock=clock)
        run._sync()
    dp_calls = ops.launch_counts()["banded_dp"] - dp0
    dev_ev = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            dev_ev.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    out = {"launches": sum(1 for n, _, _ in dev_ev if not n.startswith(("Memcpy", "Memset"))),
           "dp_calls": dp_calls}
    if not dev_ev:
        return out
    busy, gaps = _busy_and_gaps(dev_ev)
    ivs = span_intervals(clock)
    idle = idle_by_span(gaps, ivs)
    runs = [(a, b) for a, b, d, _ in ivs if d == 0]
    out.update(busy_s=busy, idle_s=sum(b - a for a, b in gaps) * 1e-9, idle_by_span=idle,
               events_ns=[min(a for _, a, _ in dev_ev), max(b for _, _, b in dev_ev)],
               run_ns=[min(a for a, _ in runs), max(b for _, b in runs)] if runs else None)
    return out


def spanned_pass(run, chunk) -> dict:
    """Map ``chunk`` untraced, then with the tracer on (no profiler, no
    synchronisation), then untraced and traced again: the wall seconds of
    each, the host's waits for the device by site over the traced passes'
    DP calls, and each span's self seconds in the last traced pass."""
    import torch

    from blasr_tpu_torch import ops
    from blasr_tpu_torch.pipeline.trace import StageClock

    walls = {"plain_s": [], "spanned_s": []}
    for traced in (False, True, True, False):
        clock = StageClock(torch.device(run.device), sync=False) if traced else None
        if traced:
            ops.reset_launch_counts()
        run._sync()
        t0 = time.perf_counter()
        run._map(chunk, run.MappingMetrics(), clock=clock)
        run._sync()
        walls["spanned_s" if traced else "plain_s"].append(time.perf_counter() - t0)
        if traced:
            counts, launches, last = ops.counters(), ops.launch_counts(), clock
    syncs = counts["syncs"]
    dp_calls = launches["banded_dp"]
    return {**walls, "syncs": syncs, "dp_calls": dp_calls,
            "syncs_per_batch": sum(syncs.values()) / dp_calls if dp_calls else None,
            "bytes": dict(last.counters),
            "self_s": {k: v["self_seconds"] for k, v in last.summary().items()}}
