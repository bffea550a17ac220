"""The port's retry passes against the JAX package on the CPU.

An 80 kb random genome with an exact 2 kb repeat and a near one (2% of
its bases substituted), a k = 11 index with the direct 4^k tables, and 20
reads of 150-250 bases in batches of 8: twelve with a substitution every
19 bases, four from the repeats (their second admitted window flags them
for adaptive_cd's full-depth re-map), two with a substitution every 11
bases (no exact 11-mer, so unmapped until the expand cascade's 10-base
seeds) and two at about 77% similarity (exact for 120 bases, then 7
substitutions in every 16: the sensitive retry's trigger, and band
escalation's). Each pass must give the JAX package's -m 4 lines and
unmapped names exactly and re-map at least one read; adaptive_cd's lines
must also equal the plain run's. The corpus, ``jax_run`` and
``jax_mapper_module`` serve test_torch_modes_ranking.py and
test_torch_modes_stream.py too. Tolerance 0."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from blasr_tpu.index.artifacts import build_index_from_arrays
from blasr_tpu.io.batching import Read
from blasr_tpu.io.seqdb import SeqDB
from blasr_tpu.output.m4 import format_m4 as jax_format_m4
from blasr_tpu.params import MappingParams
from blasr_tpu.pipeline.runner import run_mapping as jax_run_mapping
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping

torch.set_num_threads(1)

K = 11
BASE = MappingParams(
    batch_size=8, max_read_len=256, n_candidates=4, n_dp_candidates=2,
    anchor_stride=4, max_anchors_per_read=128, narrow_band=32, narrow_band_max=256,
    min_match_length=K, direct_lut=True, emit_moves=False, best_n=1,
)
EXACT_REPEAT = (10_000, 50_000, 2_000)      # source, copy, length
NEAR_REPEAT = (30_000, 65_000, 2_000)


def modes_genome(seed: int = 41) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, 80_000).astype(np.uint8)
    src, dst, n = EXACT_REPEAT
    g[dst : dst + n] = g[src : src + n]
    src, dst, n = NEAR_REPEAT
    g[dst : dst + n] = g[src : src + n]
    sub = dst + rng.choice(n, n // 50, replace=False)
    g[sub] = (g[sub] + 1) % 4
    return g


def modes_reads(g: np.ndarray, seed: int = 42) -> list:
    """(name, codes) of the 20 reads, in this order: twelve plain, four from
    the repeats, two dense, two noisy."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        n = 150 + 7 * i
        s = int(rng.integers(0, 9_000))                     # outside the repeats
        s += 15_000 if i % 3 else 70_000
        r = g[s : s + n].copy()
        r[5::19] = (r[5::19] + 1) % 4
        if i % 2:
            r = (3 - r)[::-1].copy()
        out.append((f"plain/{i}", r))
    for i, (src, _, _) in enumerate((EXACT_REPEAT, EXACT_REPEAT, NEAR_REPEAT, NEAR_REPEAT)):
        s = src + 300 + 600 * (i % 2)
        r = g[s : s + 200].copy()
        r[9::23] = (r[9::23] + 1) % 4
        out.append((f"repeat/{i}", r))
    for i in range(2):
        s = 20_000 + 30_000 * i + 4_000
        r = g[s : s + 230].copy()
        r[6::K] = (r[6::K] + 1) % 4                          # no exact 11-mer
        out.append((f"dense/{i}", r))
    for i in range(2):
        s = 22_000 + 30_000 * i + 4_000
        r = g[s : s + 250].copy()
        for b in range(120, 250, 16):                        # 7 substitutions in 16
            r[b + 1 : b + 15 : 2] = (r[b + 1 : b + 15 : 2] + 1 + i) % 4
        out.append((f"noisy/{i}", r))
    return out


@pytest.fixture(scope="module")
def corpus():
    g = modes_genome()
    index = build_index_from_arrays(g, SeqDB(["ref"], np.array([0, len(g)], np.int64),
                                             ["0" * 32]), k=K)
    reads = [Read(n, c, None, i) for i, (n, c) in enumerate(modes_reads(g))]
    return index, reads


def jax_mapper_module():
    """A copy of ``blasr_tpu.pipeline.mapper`` made at run time with one
    name changed: its target-window phase loop (mapper.py:736) rebinds
    ``cand``, the Candidates tuple that -pvaltype 2/3 read their window
    corners from at mapper.py:971, so the package raises AttributeError
    there; the copy names the loop's value ``cand_w``. The JAX package's
    file is left as it is."""
    import inspect
    import types

    from blasr_tpu.pipeline import mapper

    src = inspect.getsource(mapper)
    loop = ("        cand = (wu >> sh) | (wnext << jnp.uint32(32 - 4 * _p))\n"
            "        aligned = jnp.where((phase == _p)[:, None], cand, aligned)\n")
    assert src.count(loop) == 1
    fixed = src.replace(loop, loop.replace("cand", "cand_w"))
    name = "blasr_tpu.pipeline.mapper_pvaltype"
    if name not in sys.modules:
        module = types.ModuleType(name)
        module.__file__ = mapper.__file__
        sys.modules[name] = module      # its dataclasses look their module up
        exec(compile(fixed, mapper.__file__, "exec"), module.__dict__)
    return sys.modules[name]


def jax_run(index, reads, params, **kw):
    """The JAX package's run_mapping; at -pvaltype 2/3 through
    ``jax_mapper_module``."""
    if params.pval_type in (0, 1):
        return jax_run_mapping(index, reads, params, **kw)
    from blasr_tpu.pipeline import runner

    fixed = jax_mapper_module()
    saved = runner.Mapper, runner.unpack_result
    runner.Mapper, runner.unpack_result = fixed.Mapper, fixed.unpack_result
    try:
        return jax_run_mapping(index, reads, params, **kw)
    finally:
        runner.Mapper, runner.unpack_result = saved


def _both(index, reads, params):
    """(JAX lines, JAX unmapped, port lines, port unmapped, port metrics)."""
    jrec, junm = jax_run(index, reads, params)
    met = MappingMetrics()
    trec, tunm = run_mapping(index, reads, params, device="cpu", metrics=met)
    return ([jax_format_m4(r) for r in jrec], junm, [format_m4(r) for r in trec], tunm, met)


PASSES = {
    "adaptive": dict(adaptive_cd=True),
    "expand": dict(max_expand=2),
    "sensitive": dict(sensitive_retry=True),
}


@pytest.mark.parametrize("name", list(PASSES))
def test_pass_lines_equal_jax(corpus, name):
    index, reads = corpus
    jl, ju, tl, tu, met = _both(index, reads, dataclasses.replace(BASE, **PASSES[name]))
    assert tl == jl and tu == ju
    assert met.escalated_reads >= 2                   # the noisy reads
    if name == "adaptive":
        assert met.adaptive_reads >= 4 and met.adaptive_changed >= 1
    if name == "expand":
        assert met.expand_levels[1][0] >= 2 and sum(n for _, n in met.expand_levels.values()) >= 2
        assert not {"dense/0", "dense/1"} & set(tu)
    if name == "sensitive":
        assert met.sensitive_reads >= 2


def test_adaptive_cd_prints_the_plain_lines(corpus):
    index, reads = corpus
    plain = [format_m4(r) for r in run_mapping(index, reads, BASE, device="cpu")[0]]
    met = MappingMetrics()
    recs, _ = run_mapping(index, reads, dataclasses.replace(BASE, adaptive_cd=True),
                          device="cpu", metrics=met)
    assert [format_m4(r) for r in recs] == plain
    # the first pass's cells at the full depth, as the JAX runner counts them
    assert met.last_run_dp_cells == (2 * 256 + BASE.target_pad - 1) * 32 * 2 * 8 * 3
