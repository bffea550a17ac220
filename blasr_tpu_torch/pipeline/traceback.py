"""Alignment paths as the host consumes them, free of any device framework.

Port of ``AlignmentPath`` and the ``OP_*`` codes of
``blasr_tpu.pipeline.traceback``. A path built from the device walk carries
its coordinates and stats, and optionally the walk's 2-bit packed move
string (END->START order); ``ops`` unpacks it on first access. A path built
from a secondary's SDP blocks carries its ops directly.
"""

from __future__ import annotations

import numpy as np

from blasr_tpu_torch.native import unpack_moves

OP_M, OP_I, OP_D = 1, 2, 3


class AlignmentPath:
    """One banded alignment in local window coordinates; half-open spans
    query [q_start, q_end), target [t_start, t_end)."""

    __slots__ = (
        "q_start", "q_end", "t_start", "t_end", "score",
        "n_match", "n_mismatch", "n_ins", "n_del", "_ops",
        "packed", "packed_nops",
    )

    def __init__(
        self, q_start: int, q_end: int, t_start: int, t_end: int,
        ops: "np.ndarray | None", score: int,
        n_match: int = 0, n_mismatch: int = 0, n_ins: int = 0, n_del: int = 0,
        packed: "np.ndarray | None" = None, packed_nops: int = 0,
    ):
        self.q_start = q_start
        self.q_end = q_end
        self.t_start = t_start
        self.t_end = t_end
        self._ops = ops
        self.score = score
        self.n_match = n_match
        self.n_mismatch = n_mismatch
        self.n_ins = n_ins
        self.n_del = n_del
        self.packed = packed
        self.packed_nops = packed_nops

    @property
    def ops(self) -> np.ndarray:
        if self._ops is None:
            if self.packed is None:
                raise ValueError(
                    "this path carries no move string (mapped with emit_moves off)"
                )
            self._ops = unpack_moves(self.packed, self.packed_nops)
        return self._ops

    @property
    def n_aligned(self) -> int:
        if self._ops is None:
            return self.packed_nops
        return len(self._ops)

    @property
    def pct_similarity(self) -> float:
        n = self.n_match + self.n_mismatch + self.n_ins + self.n_del
        return 100.0 * self.n_match / n if n else 0.0

    def cigar_runs(self) -> list[tuple[str, int]]:
        """Run-length encoded ops as (op_char, length), M/I/D."""
        ops = np.asarray(self.ops)
        if ops.size == 0:
            return []
        chars = {OP_M: "M", OP_I: "I", OP_D: "D"}
        ends = np.flatnonzero(np.diff(ops)) + 1
        bounds = np.concatenate(([0], ends, [ops.size]))
        return [
            (chars[int(ops[bounds[i]])], int(bounds[i + 1] - bounds[i]))
            for i in range(len(bounds) - 1)
        ]
