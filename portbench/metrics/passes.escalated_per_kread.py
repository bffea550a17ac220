"""Reads that band escalation re-mapped through the wide band
(``MappingMetrics.escalated_reads``) per 1000 reads of the window."""


def read(rec):
    w = rec["window"]
    return 1000.0 * w["escalated_reads"] / w["reads"] if w["reads"] else None
