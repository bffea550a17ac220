"""MAPQ inputs for the tests of ``ops/mapqv.py`` on the CPU and on the card,
and for ``chip_smoke.py``'s kernel check: numpy arrays in the argument
order of ``map_qv_reference`` (scores, valid, q_lo, q_hi, n_match,
n_mismatch, n_ins, n_del). Nothing here imports JAX."""

import numpy as np


def random_case(CD: int, seed: int, B: int = 256) -> tuple:
    """B reads of CD candidates whose placements are near-duplicates of an
    earlier candidate's in 60% of the cells (so partitions, containment and
    both nMatch * 1.2 gates engage), candidate 1's score tied with
    candidate 0's in 30% of the reads, about a tenth of the candidates
    invalid and the first four reads with no valid candidate."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 300, (B, CD)).astype(np.int32)
    hi = lo + rng.integers(50, 900, (B, CD)).astype(np.int32)
    rows = np.arange(B)
    for c in range(1, CD):
        near = rng.random(B) < 0.6
        src = rng.integers(0, c, B)
        lo[:, c] = np.where(near, lo[rows, src] + rng.integers(-8, 8, B), lo[:, c])
        hi[:, c] = np.where(near, hi[rows, src] + rng.integers(-8, 8, B), hi[:, c])
    nm = ((hi - lo) * rng.uniform(0.6, 0.95, (B, CD))).astype(np.int32)
    nx = rng.integers(0, 30, (B, CD)).astype(np.int32)
    ni = rng.integers(0, 60, (B, CD)).astype(np.int32)
    nd = rng.integers(0, 40, (B, CD)).astype(np.int32)
    sc = (-5 * nm + 6 * nx + 5 * (ni + nd)).astype(np.int32)
    if CD > 1:
        sc[:, 1] = np.where(rng.random(B) < 0.3, sc[:, 0], sc[:, 1])
    valid = (sc < 0) & (rng.random((B, CD)) < 0.9)
    valid[:4] = False
    return sc, valid, lo, hi, nm, nx, ni, nd


# one read of four candidates per branch of map_qv_float: the candidates'
# (valid, lo, hi, n_match, n_mismatch, n_ins), scores from these at the
# default costs, and the mapping quality each candidate must get (None: any value
# strictly between 0 and 254). An invalid candidate takes partition 0's
# log10 sum and size, as the plain version gathers them.
BRANCH_ROWS = {
    # one valid candidate: its partition has one member
    "psize_1": ([(1, 0, 1000, 900, 3, 0), (0, 0, 1000, 900, 3, 0), (0, 0, 1000, 900, 3, 0),
                 (0, 0, 1000, 900, 3, 0)], [254, 254, 254, 254]),
    # four disjoint candidates: four partitions of one
    "disjoint": ([(1, 0, 500, 450, 1, 0), (1, 1000, 1500, 450, 2, 0),
                  (1, 2000, 2500, 450, 3, 0), (1, 3000, 3500, 450, 4, 0)], [254, 254, 254, 254]),
    # the second of two equal placements is 30 log10 units worse: sub < -20
    # (0); the first's 1 - 10^sub rounds to 0 (one_minus <= 0, 254)
    "sub_below_minus_20": ([(1, 0, 1000, 900, 0, 0), (1, 0, 1000, 900, 20, 0),
                            (0, 0, 1000, 900, 3, 0), (0, 0, 1000, 900, 3, 0)], [254, 0, 0, 0]),
    # a member outside the log10 sum (its nMatch * 1.2 below the
    # partition's largest) with a better probability than the sum: sub > 0,
    # one_minus < 0 (254)
    "one_minus_negative": ([(1, 0, 1100, 1000, 5, 0), (1, 0, 1100, 500, 0, 0),
                            (0, 0, 1000, 900, 3, 0), (0, 0, 1000, 900, 3, 0)],
                           [254, 254, 254, 254]),
    # no valid candidate: every partition is empty
    "none_valid": ([(0, 0, 1000, 900, 3, 0), (0, 5, 1000, 900, 2, 0), (0, 0, 990, 900, 3, 0),
                    (0, 0, 1000, 800, 1, 0)], [254, 254, 254, 254]),
    # invalid candidates between two valid, overlapping ones: the score
    # order puts them last and the scatter brings each value back
    "invalid_between": ([(1, 0, 1000, 900, 2, 0), (0, 0, 1000, 900, 0, 0),
                         (1, 3, 1002, 900, 2, 1), (0, 0, 1000, 900, 1, 0)], [None, 254, None, 254]),
    # probabilities 38 log10 units apart: exp((mn - mx) ln 10) = exp(-87.498)
    # and 10^sub = 10^-38 are subnormal, flushed to 0
    "subnormal": ([(1, 0, 1000, 900, 0, 0), (1, 0, 1000, 900, 0, 76), (0, 0, 1000, 900, 3, 0),
                   (0, 0, 1000, 900, 3, 0)], [254, 0, 0, 0]),
}


def branch_cases() -> tuple[tuple, np.ndarray, list]:
    """(inputs, wanted, names): one read a row of ``BRANCH_ROWS``, the
    mapping quality each candidate must get (-1 where any value strictly
    between 0 and 254 is right) and the rows' names."""
    names = list(BRANCH_ROWS)
    cells = np.array([BRANCH_ROWS[n][0] for n in names], dtype=np.int64)   # (B, 4, 6)
    valid = cells[..., 0].astype(bool)
    lo, hi, nm, nx, ni = (cells[..., k].astype(np.int32) for k in range(1, 6))
    nd = np.zeros_like(nx)
    sc = (-5 * nm + 6 * nx + 5 * ni).astype(np.int32)
    wanted = np.array([[-1 if q is None else q for q in BRANCH_ROWS[n][1]] for n in names],
                      dtype=np.int32)
    return (sc, valid, lo, hi, nm, nx, ni, nd), wanted, names
