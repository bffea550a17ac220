"""The host run loop's finalize time (``MappingMetrics.finalize_seconds``:
wire buffers to records, the secondary admission inside) as a share of
the measured window."""


def read(rec):
    w = rec["window"]
    return 100.0 * w["finalize_s"] / w["seconds"] if w["seconds"] > 0 else None
