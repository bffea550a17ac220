"""The banded DP kernel's share of its roofline in the SAM cell: the
profiled part's DP calls, the phred-scaled narrow band of each batch and
the guided refinement of its secondaries, counted by
``harness/k1work.py``; the reader of ``banded_dp_roofline``."""

from portbench.harness.spec import load_reader


def read(rec):
    return load_reader("banded_dp_roofline")(rec)
