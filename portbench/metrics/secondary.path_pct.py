"""The -bestn secondary path (``MappingMetrics.secondary_seconds``: the
host's SDP admission of each rank >= 1 record and the refinement of those
on the SDP chain's span) as a share of the measured window."""


def read(rec):
    w = rec["window"]
    return 100.0 * w["secondary_s"] / w["seconds"] if w["seconds"] > 0 else None
