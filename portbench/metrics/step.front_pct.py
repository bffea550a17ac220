"""Anchoring, candidate selection and the DP's set-up (the stage clock's
anchors, candidates and setup stages) as a share of the clocked chunk's
stage time."""


def read(rec):
    c = rec.get("clock") or {}
    total = sum(c.values())
    if total <= 0:
        return None
    return 100.0 * sum(c.get(s, 0.0) for s in ("anchors", "candidates", "setup")) / total
