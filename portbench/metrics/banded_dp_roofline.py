"""The banded DP kernel's share of its roofline: the least time the chip
could take for the work the profiled chunk's DP inputs need (operations
over the INT32 peak or bytes over HBM bandwidth, ``harness/k1work.py``)
over the kernel's device time in the profiler's trace."""


def read(rec):
    p = rec.get("profile") or {}
    k1 = p.get("k1")
    if not k1 or k1["device_s"] <= 0 or k1["ops"] <= 0:
        return None
    peaks = rec["peaks"]
    least = max(k1["ops"] / peaks["int32_ops_per_s"], k1["bytes"] / peaks["hbm_bytes_per_s"])
    return 100.0 * least / k1["device_s"]
