"""Anchor-count statistics (role of common/statistics/:
AnchorDistributionTable + LookupAnchorDistribution, used by the
reference's -computeAlignProbability / cluster significance paths).

The reference ships a large precomputed table of expected anchor counts
and their spread for (read length, accuracy, k); here they are computed
in closed form: each of the (L - k + 1) read positions seeds an anchor
iff its k-mer is error-free, probability ~ p^k (per-base accuracy p).
Adjacent windows overlap, so the variance uses the standard stationary
m-dependent sum formula with cov(X_i, X_j) = p^(k + |i-j|) - p^(2k).

The port's copy of ``blasr_tpu/statistics.py``, whole.
"""

from __future__ import annotations

import math


def expected_anchors(read_length: int, accuracy: float, k: int) -> float:
    n = max(read_length - k + 1, 0)
    return n * accuracy**k


def anchor_stddev(read_length: int, accuracy: float, k: int) -> float:
    n = max(read_length - k + 1, 0)
    if n == 0:
        return 0.0
    p = accuracy
    pk = p**k
    var = n * pk * (1 - pk)
    # overlapping-window covariances, lag 1..k-1
    for d in range(1, min(k, n)):
        cov = p ** (k + d) - pk * pk
        var += 2 * (n - d) * cov
    return math.sqrt(max(var, 0.0))


def anchor_zscore(
    n_anchors: int, read_length: int, accuracy: float, k: int
) -> float:
    """How (un)usual an observed anchor count is — the significance signal
    behind the reference's cluster filtering (LookupAnchorDistribution)."""
    mu = expected_anchors(read_length, accuracy, k)
    sd = anchor_stddev(read_length, accuracy, k)
    if sd == 0:
        return 0.0
    return (n_anchors - mu) / sd
