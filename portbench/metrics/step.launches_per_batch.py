"""CUDA kernel launches in the profiled chunk over its DP calls (one a
batch mapped, re-mapping passes included)."""


def read(rec):
    p = rec.get("profile") or {}
    if not p.get("launches") or not p.get("k1_calls"):
        return None
    return p["launches"] / p["k1_calls"]
