"""Seconds to load (or build and cache) the genome's index and upload it
as the device index, ending in a synchronise (harness clock in set-up)."""


def read(rec):
    return rec["setup"]["index_s"]
