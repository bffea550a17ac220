"""The benchmark of blasr_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload ecoli_m4.fasta_1k --seed 7 --seconds 20 --trace 0

from the root of a checkout, on a machine with the cell's CUDA devices.
The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and last ``checks``: each number compared with its
limit, which the last lines of standard error repeat). ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer ones.

Options for measuring the benchmark itself, never given by its checks:
``--seeds A,B,...`` maps further seeds after ``--seed`` in the same
process (one set-up, a result line each); ``--control`` runs the cell
with its control's flags (``checks/<workload>.json``), which the check
has to find not correct.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, "portbench", ".cache")
# every build and kernel cache of a run stays inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
# one host thread for PyTorch's and the BLAS libraries' pools: the run is one
# process whose host loop paces the device, and idle pool threads would
# contend with it for the machine's cores
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

FORBIDDEN = ("jax", "jaxlib", "flax", "blasr_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_seed(run, seed: int, seconds: float, trace: bool, t_origin: float) -> dict:
    """Pool, warm-up, window, the traced chunks and the check of one seed;
    the result line's object."""
    from portbench.harness import trace as trace_mod
    from portbench.harness.peaks import H100_SXM
    from portbench.harness.spec import load_reader

    run.make_pool(seed)
    run.warmup()
    setup_s = time.perf_counter() - t_origin
    log("setup parts (s): " + json.dumps({k: round(v, 4) for k, v in run.setup_parts.items()})
        + f" total {setup_s:.4f}")
    w = run.window(seconds)
    log(f"window: {w.chunks} chunks, {w.reads} reads, {w.bases} bases in {w.seconds:.4f} s "
        f"(chunks {', '.join(f'{c:.3f}' for c in w.chunk_s)} s)")
    device = {"platform": "gpu" if run.cuda else "cpu",
              "kind": run.torch.cuda.get_device_name(0) if run.cuda else "cpu",
              "count": int(run.bench.cell["chips"]),
              "memory_peak_bytes": w.peak_bytes}
    result = {"correct": False, "attempted": w.reads, "failed": w.missing}
    breakdown = None
    if trace:
        prof = trace_mod.profiled_chunk(run, run.trace_part(run.chunks[0]))
        clock = trace_mod.clocked_chunk(run, run.trace_part(run.chunks[1 % len(run.chunks)]))
        met = w.metrics
        records = {
            "setup": {"index_s": run.index_s},
            "window": {"seconds": w.seconds, "reads": w.reads,
                       "finalize_s": met.finalize_seconds, "secondary_s": met.secondary_seconds,
                       "piecewise_s": met.piecewise_seconds, "write_s": w.write_s,
                       "escalated_reads": met.escalated_reads},
            "clock": clock,
            "profile": prof,
            "peaks": H100_SXM,
        }
        metrics = {}
        for m in run.bench.per_layer():
            v = load_reader(m["name"])(records)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if "busy_s" in prof:
            device["busy_s"] = prof["busy_s"]
            device["window_s"] = prof["span_s"]
            breakdown = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
        log(f"traced chunk: {prof['launches']} launches, {prof['k1_calls']} DP calls, "
            f"span {prof['span_s']:.4f} s ({prof['plain_s']:.4f} s unprofiled), "
            f"trace read in {prof['read_s']:.4f} s; "
            f"stage clock {json.dumps({k: round(v, 4) for k, v in clock.items()})}")
    else:
        metrics = run.end_to_end(w, setup_s)
    if run.cuda:
        device["power_limit"] = power_limit()
        run.torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ok, numbers, details = run.check(w, seed)
    log(f"check: {details['sampled_records']} records sampled, "
        f"{details['below_optimum']} scored below their span's optimum, "
        f"{time.perf_counter() - t_check:.4f} s")
    for note in details["odd_records"][:5]:
        log("record off: " + json.dumps(note))
    result.update(correct=ok, metrics=metrics, device=device)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seeds", default="", help="further seeds, comma separated")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from portbench.harness.cell import CellRun
    from portbench.harness.spec import Bench

    bench = Bench(args.workload)
    need = int(bench.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"{args.workload} needs {need} CUDA device(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count = {torch.cuda.device_count()}")
        return 3
    run = CellRun(bench, "cuda", T_START, control=args.control)
    run.setup()
    seeds = [args.seed] + [int(s) for s in args.seeds.split(",") if s.strip()]
    for i, seed in enumerate(seeds):
        origin = T_START if i == 0 else time.perf_counter()
        result = run_seed(run, seed, args.seconds, bool(args.trace), origin)
        bad = forbidden_modules()
        if bad:
            log("modules of JAX or the JAX package are loaded: " + ", ".join(bad))
            return 4
        for k, c in result["checks"].items():
            log(f"{k} {c['value']} limit {c['limit']}")
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
