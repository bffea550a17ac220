"""Device compute of the port: anchoring, candidates, banded DP, walk, MAPQ.

The five hand-written CUDA kernels of the mapping path are reached through
``banded_cuda.banded_align``, ``gather.gather_spans``, ``gather.gather_rows``,
``traceback_device.walk_arrows_device`` and ``mapqv.map_qv_reference``; each
wrapper counts its kernel launches (``launch_counts``). Each place where the
mapping path makes the host wait for the device counts its waits, and the DP
wrapper keeps the largest arrow tensor it made (``counters``). The -bestn
secondary path counts its records and its refinement's DP calls
(``SECONDARY``). All are always on, one integer add where the work happens,
and ``reset_launch_counts`` zeroes them.
"""

import threading

# the counters are read-modify-writes, and the sharded path launches from
# one thread per shard
COUNT_LOCK = threading.Lock()
# name -> function of each place where the mapping path makes the host wait
# for the device, registered by ``sync_site`` as its module is imported
SYNC_SITES: dict = {}
# the -bestn secondary path (``pipeline/secondary.py``): rank >= 1 records
# checked, dropped by the min_interval gate, dropped by the cut before the
# refinement (no SDP chain, or an SDP score above -maxScore), that took the
# SDP chain's span, that the refinement aligned, dropped by -maxScore on
# the refined score (or left with no alignment), the refinement's DP calls
# (one a batch that has such records), and the checked records whose
# admission ran in C++ (``native``; equal to ``checked`` unless the host
# library could not be built)
SECONDARY = dict.fromkeys(
    ("checked", "gated", "cut_sdp", "replaced", "refined", "cut_refined", "refine_calls",
     "native"), 0)


def count_secondary(name: str, n: int = 1) -> None:
    with COUNT_LOCK:
        SECONDARY[name] += n


def sync_site(name: str):
    """Register the decorated function as the sync site ``name``: it counts
    the waits it makes in ``fn.syncs``."""
    def register(fn):
        fn.syncs = 0
        SYNC_SITES[name] = fn
        return fn
    return register


def kernel_wrappers() -> dict:
    """Name -> wrapper of every kernel on the mapping path."""
    from blasr_tpu_torch.ops import banded_cuda, gather, mapqv, traceback_device

    return {
        "banded_dp": banded_cuda.banded_align,
        "gather_spans": gather.gather_spans,
        "gather_rows": gather.gather_rows,
        "traceback_walk": traceback_device.walk_arrows_device,
        "mapqv": mapqv.map_qv_reference,
    }


def reset_launch_counts() -> None:
    from blasr_tpu_torch.ops.banded_cuda import banded_align

    for fn in kernel_wrappers().values():
        fn.launches = 0
        for by in ("launches_by_shape", "launches_by_path"):
            counts = getattr(fn, by, {})
            for key in counts:
                counts[key] = 0
    for fn in SYNC_SITES.values():
        fn.syncs = 0
    for key in SECONDARY:
        SECONDARY[key] = 0
    banded_align.max_arrow_bytes = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def dp_launch_counts() -> dict:
    """The DP kernel's launches per band width and quality mode, and with
    guided knots or a score matrix, as ``{"W32/single": n, "W32/guided": m,
    ...}`` (keys launched at least once; a guided or matrix launch counts
    under its quality mode too)."""
    from blasr_tpu_torch.ops.banded_cuda import banded_align

    return {f"W{w}/{m}": n for (w, m), n in banded_align.launches_by_shape.items() if n}


def counters() -> dict:
    """The host's waits for the device by site (``syncs``), the largest
    (S, I, W) arrow tensor a DP call made (``max_arrow_bytes``) and the
    secondary path's counts (``secondary``, as ``SECONDARY`` names them)."""
    from blasr_tpu_torch.ops.banded_cuda import banded_align

    return {"syncs": {name: fn.syncs for name, fn in SYNC_SITES.items()},
            "max_arrow_bytes": banded_align.max_arrow_bytes,
            "secondary": dict(SECONDARY)}
