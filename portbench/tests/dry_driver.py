"""Drives runs of a cell past the harness's look for a chip, for the tests
on the CPU and for reading the planted faults on the card:

    python dry_driver.py ROOT WORKLOAD MODE... [--device D] [--seeds A,B] [--seconds S]

MODE is one of plain, trace, control, drop_half, unmapped_half, alter.
Prints one JSON object {mode: [result line object of each seed], ...,
"loaded": [forbidden modules loaded]}.

ROOT holds BENCHMARK.json and portbench/; the program is imported from
the PYTHONPATH. ``drop_half`` leaves out the records of every other read
of each mapped chunk without reporting them unmapped; ``unmapped_half``
reports those reads unmapped instead; ``alter`` adds 1 to every record's
score where run_mapping produces it."""

import argparse
import json
import sys
import time

ap = argparse.ArgumentParser()
ap.add_argument("root")
ap.add_argument("workload")
ap.add_argument("modes", nargs="+")
ap.add_argument("--device", default="cpu")
ap.add_argument("--seeds", default=str(2**31 + 12345))
ap.add_argument("--seconds", type=float, default=0.1)
args = ap.parse_args()
sys.path.insert(0, args.root)

import portbench.run as R  # noqa: E402
from portbench.harness.cell import CellRun  # noqa: E402
from portbench.harness.spec import Bench  # noqa: E402

FAULTS = ("drop_half", "unmapped_half", "alter")


def faulty(kind):
    from blasr_tpu_torch.pipeline.runner import run_mapping

    def mapped(index, reads, params, **kw):
        records, unmapped = run_mapping(index, reads, params, **kw)
        if kind in ("drop_half", "unmapped_half"):
            drop = {r.name for i, r in enumerate(reads) if i % 2}
            kept = [u for u in unmapped if u not in drop]
            if kind == "unmapped_half":
                kept += [r.name for r in reads if r.name in drop]
            return [r for r in records if r.qname not in drop], kept
        for r in records:
            r.score += 1
        return records, unmapped

    return mapped


out = {}
for mode in args.modes:
    t0 = time.perf_counter()
    run = CellRun(Bench(args.workload), args.device, t0, control=mode == "control",
                  map_fn=faulty(mode) if mode in FAULTS else None)
    run.setup()
    out[mode] = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        origin = t0 if i == 0 else time.perf_counter()
        out[mode].append(R.run_seed(run, seed, args.seconds, mode == "trace", origin))
out["loaded"] = R.forbidden_modules()
print(json.dumps(out))
