"""The share of time in which no kernel, copy or fill ran on the device,
with the profiler off: the device's busy time in the profiler's trace
of the traced part over that part's wall time mapped once just before
without the profiler (the profiler slows the host, not the kernels).
Two passes of the same reads: a busy time above the unprofiled wall
time reads below 0, and shows that the two passes differ."""


def read(rec):
    p = rec.get("profile") or {}
    if "busy_s" not in p or p["plain_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["plain_s"])
