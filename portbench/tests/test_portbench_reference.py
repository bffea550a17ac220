"""The plain reference: the span optimum against a cell-by-cell Gotoh
recurrence, the CIGAR score by hand, the output parsers, and imports."""

import json
import os
import subprocess
import sys

import numpy as np

from portbench.reference.align import base_costs, cigar_score, span_optimum
from portbench.reference.outputs import parse_m4, parse_sam, read_name

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCORING = dict(match=-5, mismatch=6, n_score=0, insertion=5, deletion=5,
               affine_open=50, affine_extend=0, qv_scaled=True)


def gotoh(q, t, qual):
    """Global score, both ends fixed, one cell at a time."""
    x, ic = base_costs(SCORING, len(q), qual)
    m, n, inf = len(q), len(t), 1 << 29
    H = [[inf] * (n + 1) for _ in range(m + 1)]
    E = [[inf] * (n + 1) for _ in range(m + 1)]
    F = [[inf] * (n + 1) for _ in range(m + 1)]
    H[0][0] = 0
    for i in range(m + 1):
        for j in range(n + 1):
            if i == 0 and j == 0:
                continue
            best = inf
            if j:
                E[i][j] = min(E[i][j - 1], H[i][j - 1] + 50)
                best = min(best, H[i][j - 1] + 5, E[i][j])
            if i:
                F[i][j] = min(F[i - 1][j], H[i - 1][j] + 50)
                best = min(best, H[i - 1][j] + int(ic[i - 1]), F[i][j])
            if i and j:
                a, b = int(q[i - 1]), int(t[j - 1])
                s = -5 if a == b and a < 4 else (0 if a >= 4 or b >= 4 else int(x[i - 1]))
                best = min(best, H[i - 1][j - 1] + s)
            H[i][j] = best
    return H[m][n]


def test_span_optimum_equals_gotoh():
    rng = np.random.default_rng(0)
    items = []
    for k in range(24):
        q = rng.integers(0, 5 if k % 5 == 0 else 4, int(rng.integers(1, 40))).astype(np.uint8)
        if k % 3 == 0:   # a long gap inside a match: the affine gap wins
            t = np.concatenate([q[: len(q) // 2], rng.integers(0, 4, 20), q[len(q) // 2:]])
        else:
            t = rng.integers(0, 4, int(rng.integers(1, 40)))
        qual = rng.integers(2, 40, len(q)) if k % 2 else None
        items.append((q, t.astype(np.uint8), qual))
    assert span_optimum(items, SCORING, block=7) == [gotoh(*it) for it in items]


def test_cigar_score_by_hand():
    q = np.array([0, 1, 2, 3, 3, 0], np.uint8)
    t = np.array([0, 1, 2, 0], np.uint8)
    # three matches, two insertions at 5 each, one match
    assert cigar_score([("=", 3), ("I", 2), ("=", 1)], q, t, None, SCORING) == -20 + 10
    # a 12-base deletion costs the affine gap, 50, not 60
    assert cigar_score([("=", 1), ("D", 12)], q[:1], np.zeros(13, np.uint8), None, SCORING) == 45
    # phred 30 doubles the mismatch: 12
    assert cigar_score([("X", 1)], q[:1], np.array([1], np.uint8), [30], SCORING) == 12
    assert cigar_score([("=", 2)], q[:1], t[:1], None, SCORING) is None


def test_parsers():
    m4 = "sim/3|ref|10|20|1/0_12 chr -40 90.0 0 1 11 12 1 5 15 100 254\n"
    r = parse_m4(m4)["sim/3|ref|10|20|1"][0]
    assert (r["strand"], r["tstart"], r["tend"], r["score"]) == (1, 85, 95, -40)
    sam = "@HD\tVN:1.5\nr/1|ref|0|4|0/0_4\t16\tchr\t7\t254\t1S2=1X\t*\t0\t3\tACGT\t*\tAS:i:-4\n"
    s = parse_sam(sam)["r/1|ref|0|4|0"][0]
    assert (s["pos"], s["strand"], s["cigar"], s["score"]) == (6, 1, [("S", 1), ("=", 2), ("X", 1)], -4)
    assert read_name("a/b/0_5") == "a/b" and read_name("a/b") == "a/b"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.align, portbench.reference.outputs\n"
            "import json; print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'blasr_tpu', 'blasr_tpu_torch'))))"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
