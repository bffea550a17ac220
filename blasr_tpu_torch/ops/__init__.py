"""Device compute of the port: anchoring, candidates, banded DP, walk, MAPQ.

The three hand-written CUDA kernels of the mapping path are reached through
``banded_cuda.banded_align``, ``gather.gather_spans`` and
``gather.gather_rows``; each wrapper counts its kernel launches.
"""

import threading

# the counters are read-modify-writes, and the sharded path launches from
# one thread per shard
COUNT_LOCK = threading.Lock()


def kernel_wrappers() -> dict:
    """Name -> wrapper of every kernel on the mapping path."""
    from blasr_tpu_torch.ops import banded_cuda, gather

    return {
        "banded_dp": banded_cuda.banded_align,
        "gather_spans": gather.gather_spans,
        "gather_rows": gather.gather_rows,
    }


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        for by in ("launches_by_shape", "launches_by_path"):
            counts = getattr(fn, by, {})
            for key in counts:
                counts[key] = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def dp_launch_counts() -> dict:
    """The DP kernel's launches per band width and quality mode, and with
    guided knots or a score matrix, as ``{"W32/single": n, "W32/guided": m,
    ...}`` (keys launched at least once; a guided or matrix launch counts
    under its quality mode too)."""
    from blasr_tpu_torch.ops.banded_cuda import banded_align

    return {f"W{w}/{m}": n for (w, m), n in banded_align.launches_by_shape.items() if n}
