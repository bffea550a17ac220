"""The reference genome stand-in: a random genome with duplicated blocks.

A copy of the port's ``sim.simulate_genome`` (the same seed gives the
same genome, byte for byte), kept here so that the yardstick does not
move with the program.
"""

from __future__ import annotations

import numpy as np


def simulate_genome(length: int, seed: int = 0, repeat_fraction: float = 0.05) -> np.ndarray:
    """Random genome with a sprinkling of duplicated 2 kb blocks (repeats)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, length).astype(np.uint8)
    n_rep = int(length * repeat_fraction) // 2000
    for _ in range(max(0, n_rep)):
        src = int(rng.integers(0, length - 2000))
        dst = int(rng.integers(0, length - 2000))
        g[dst : dst + 2000] = g[src : src + 2000]
    return g


def from_config(spec: dict) -> np.ndarray:
    """The genome a configuration's ``genome`` block names."""
    return simulate_genome(int(spec["length"]), seed=int(spec["seed"]),
                           repeat_fraction=float(spec["repeat_fraction"]))
