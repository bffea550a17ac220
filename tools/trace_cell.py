"""The traced part of a benchmark cell with the program's tracer on: where
the device's idle time falls among the program's spans, what the tracer
costs, and every place the host waits for the device.

    python3 tools/trace_cell.py --workload ecoli_m4.fasta_1k --seeds 7,8,9 \
        --out DIR/trace_cell.json [--sync-sites]

On a CUDA device, per seed: the cell's set-up, pool and warm-up as
``portbench/run.py`` makes them, then on the part the traced run profiles
(``CellRun.trace_part`` of chunk 0): the untraced and traced passes of
``harness/spans.spanned_pass``, the profiled pass as the benchmark makes
it (``harness/trace.profiled_chunk``, tracer off) and the same pass with
the tracer on (``harness/spans.profiled_spans``). Then eight pairs of
untraced and traced passes in alternating order give the tracer's cost,
and each profiled pass runs twice. ``--sync-sites`` maps the part once
more, on the first seed, under
``torch.cuda.set_sync_debug_mode("warn")`` and lists each warning's
place in the program beside the program's own counts of its waits.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import traceback
import warnings

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync_sites(run, part) -> dict:
    """Each synchronising operation's place in the program (its innermost
    frames in ``blasr_tpu_torch``) with its count over one pass of
    ``part``, and the program's counted waits over the same pass."""
    import torch

    from blasr_tpu_torch import ops

    sites: collections.Counter = collections.Counter()
    others: collections.Counter = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        frames = [f for f in stack if "blasr_tpu_torch" in f.filename] or stack[-4:]
        place = " <- ".join(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"
                            for f in frames[::-1][:3])
        if "synchroniz" in str(message):
            sites[place] += 1
        else:
            others[f"{str(message)[:160]} at {place}"] += 1

    ops.reset_launch_counts()
    run._sync()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run._map(part, run.MappingMetrics())
        finally:
            torch.cuda.set_sync_debug_mode(0)
    run._sync()
    return {"warned": dict(sites.most_common()), "warnings": sum(sites.values()),
            "other_warnings": dict(others),
            "counted": ops.counters()["syncs"], "dp_calls": ops.launch_counts()["banded_dp"]}


def tracer_cost(run, part, pairs: int = 8) -> dict:
    """Wall seconds of ``part`` mapped untraced and with the tracer on (no
    synchronisation), in ``pairs`` pairs whose order alternates; the median
    of the traced over the untraced time."""
    import statistics

    import torch

    from blasr_tpu_torch.pipeline.trace import StageClock

    ratios = []
    for i in range(pairs):
        t = {}
        for traced in ((False, True) if i % 2 == 0 else (True, False)):
            clock = StageClock(torch.device(run.device), sync=False) if traced else None
            run._sync()
            t0 = time.perf_counter()
            run._map(part, run.MappingMetrics(), clock=clock)
            run._sync()
            t[traced] = time.perf_counter() - t0
        ratios.append(round(t[True] / t[False], 4))
    return {"ratios": ratios, "median_ratio": statistics.median(ratios)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma separated")
    ap.add_argument("--out", required=True)
    ap.add_argument("--sync-sites", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import spans, trace
    from portbench.harness.cell import CellRun
    from portbench.harness.spec import Bench

    if not torch.cuda.is_available():
        log("no CUDA device: the tracer's readings are the card's")
        return 3
    run = CellRun(Bench(args.workload), "cuda", T_START)
    run.setup()
    result = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__, "seeds": {}}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run.make_pool(seed)
        run.warmup()
        part = run.trace_part(run.chunks[0])
        got = {"spanned": spans.spanned_pass(run, part), "cost": tracer_cost(run, part),
               "profiled_off": [], "profiled_on": []}
        for _ in range(2):
            off = trace.profiled_chunk(run, part)
            row = {k: off.get(k) for k in ("launches", "k1_calls", "busy_s", "plain_s", "span_s")}
            row["idle_pct"] = (100.0 * (1 - off["busy_s"] / off["plain_s"])
                               if "busy_s" in off else None)
            got["profiled_off"].append(row)
            got["profiled_on"].append(spans.profiled_spans(run, part))
        if args.sync_sites and i == 0:
            got["sync_sites"] = sync_sites(run, part)
        result["seeds"][seed] = got
        sp, cost = got["spanned"], got["cost"]
        log(f"seed {seed}: tracer cost {100 * cost['median_ratio'] - 100:.2f}% over "
            f"{len(cost['ratios'])} pairs (ratios {cost['ratios']}); syncs {sp['syncs']} "
            f"over {sp['dp_calls']} DP calls; launches off "
            f"{[r['launches'] for r in got['profiled_off']]} on "
            f"{[r['launches'] for r in got['profiled_on']]}")
        for on in got["profiled_on"]:
            idle = on.get("idle_by_span", {})
            total = sum(idle.values()) or 1.0
            log(f"  idle by span (% of {total:.4f} s): "
                + json.dumps({k: round(100 * v / total, 2) for k, v in
                              sorted(idle.items(), key=lambda kv: -kv[1])})
                + f"; device events {on.get('events_ns')} against the run span "
                f"{on.get('run_ns')}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
