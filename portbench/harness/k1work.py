"""The work of one banded DP call (K1), counted from what its inputs need.

A cell is one query base against one target base inside the band: an
item of query length n against a window of T target bases needs the
n + T - 1 anti-diagonal steps up to its last base (at most the batch's
L + T - 1), each of W cells. Rows that pad a batch (query length 0)
need no work and are not counted.

Integer operations per cell of the stated recurrence (minimised score,
local, linear and affine gaps), whatever kernel computes it:

    substitution: q == t (1), either is N (2 compares + 1 or), two
        selects among match / mismatch / N (2)                        6
    diagonal: min(H_diag, 0) + sub                                     2
    insertion and deletion by the base: H_up + ins, H_left + del       2
    affine deletion E = min(E_left, H_left + open) + extend            3
    affine insertion F = min(F_up, H_up + open) + extend               3
    H = min of the five, then min(H, 0)                                5
    inside the window: q < qlen, t >= tlo, t < thi, t >= 0 (4) and
        their and (3); H, E, F masked outside (3)                     10
    running best: compare and select                                   2
                                                                    ----
                                                                      33

A call that keeps the traceback adds what a walk back through the
matrix needs of each cell, and no more: the source of H by four
compare-selects (8), the stop select (1), whether E and F opened or
extended (2), the three packed into one word by two shifts and two ors
(4): +15. Anything else a kernel keeps in its word (a kernel's own run
lengths or mismatch counts, which the recurrence does not need) is not
charged.

A phred stream scales the mismatch and the insertion cost of each cell:
clip to [4, 30] (2), multiply, add, divide, max with 1 (4), twice: +12;
the dual stream splits its two bytes first: +2 more. A score matrix
replaces the substitution's six operations by an index (q * 5 + t with
t clipped: 3), its validity (3), a select and a load (2): +2.

Bytes: each input read once (query and target codes, one byte a base;
query length and target bounds, 4 bytes each an item; the band schedule,
4 bytes a step, or the guided knots; the phred stream, 1 or 2 bytes a
base) and each output written once (the traceback words, 2 bytes a cell;
the best score and its cell, 12 bytes an item).
"""

from __future__ import annotations

OPS_BASE = 33
OPS_TRACEBACK = 15
OPS_QUAL = {"none": 0, "single": 12, "dual": 14}
OPS_MATRIX = 2


def call_work(qlens, L: int, T: int, W: int, qual_mode: str, matrix: bool,
              traceback: bool, knots_per_item: int = 0) -> tuple[int, int, int]:
    """(cells, operations, bytes) of one call: ``qlens`` the items' query
    lengths (a sequence of ints)."""
    S = L + T - 1
    real = [int(q) for q in qlens if int(q) > 0]
    n = len(real)
    cells = sum(min(S, q + T - 1) for q in real) * W
    ops = cells * (OPS_BASE + (OPS_TRACEBACK if traceback else 0) + OPS_QUAL[qual_mode]
                   + (OPS_MATRIX if matrix else 0))
    qbytes = {"none": 0, "single": 1, "dual": 2}[qual_mode]
    bytes_in = n * (L + T + 12 + L * qbytes + 4 * knots_per_item)
    bytes_in += 0 if knots_per_item else 4 * S
    bytes_out = n * 12 + (2 * cells if traceback else 0)
    return cells, ops, bytes_in + bytes_out

