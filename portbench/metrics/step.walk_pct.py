"""The traceback walk (the stage clock's walk stage) as a share of the
clocked chunk's stage time."""


def read(rec):
    c = rec.get("clock") or {}
    total = sum(c.values())
    return 100.0 * c.get("walk", 0.0) / total if total > 0 else None
