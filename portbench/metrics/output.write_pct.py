"""The CLI's writer (-m 4 or SAM into memory), timed by the harness
around each call, as a share of the measured window."""


def read(rec):
    w = rec["window"]
    return 100.0 * w["write_s"] / w["seconds"] if w["seconds"] > 0 else None
