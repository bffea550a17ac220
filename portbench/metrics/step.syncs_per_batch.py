"""The host's waits for the device per batch: every wait the program
counts (``blasr_tpu_torch.ops.counters()["syncs"]``: the walk's activity
checks, the copies to the device from pageable memory, the fetch of each
batch's result) over the DP kernel's launches, one a batch mapped. Both
are the process's counts up to the traced run's readings: the warm-up,
the window and the traced parts. None where the program keeps no such
counts or launched no DP kernel (the CPU's plain path)."""


def read(rec):
    from blasr_tpu_torch import ops

    counters = getattr(ops, "counters", None)
    if counters is None:
        return None
    dp_calls = ops.launch_counts().get("banded_dp", 0)
    if not dp_calls:
        return None
    return sum(counters()["syncs"].values()) / dp_calls
