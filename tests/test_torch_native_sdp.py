"""The -bestn secondary admission in C++ against its plain versions.

``native.sdp_interval_align`` and ``native.reference_anchor_list``
(``csrc/host_native.cpp``) against ``secondary_refine``'s functions of
those names (``native.*_plain``): the same score and blocks, the same
anchors, on the secondary tests' SDP shapes, on seeded windows over a
genome with duplicated 2 kb blocks and on a small genome with its suffix
array. Then ``secondary._admit_secondary`` record for record at
``-bestn 10`` on the repeat corpus with the C++ and with the plain path
(the latter chosen by making the host library read as not built), and the
``native`` counter; and that the run loop reaches the tail through
``pipeline/secondary.py`` alone."""

import dataclasses

import numpy as np
import pytest

from blasr_tpu_torch import native, ops
from blasr_tpu_torch.index.artifacts import GenomeIndex, build_index_from_arrays
from blasr_tpu_torch.io.seqdb import SeqDB
from blasr_tpu_torch.pipeline import runner, secondary
from blasr_tpu_torch.pipeline import secondary_refine as tsr
from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping

from conftest import mutate_read
from test_torch_secondary import BESTN2, SDP_CASES, _sdp_pair, repeat_corpus

BESTN10 = dataclasses.replace(BESTN2, best_n=10, n_candidates=10, n_dp_candidates=10)


def _pair(case: str):
    """``_sdp_pair``'s cases, a CLR-like read (8% insertions), and a read
    whose middle 300 bases carry a substitution every 9th base after a
    200-base insertion: no word-11 match there, so the gap between the
    chain's blocks is filled by the global sweep at word 7 and its own gaps
    by the gap SW."""
    if case in SDP_CASES:
        return _sdp_pair(case)
    rng = np.random.default_rng(99)
    t = rng.integers(0, 4, 1500).astype(np.uint8)
    if case == "clr":
        q = mutate_read(rng, t, 150, 1200, sub=0.01, ins=0.08, dele=0.04)
        return q, t, dict(indel_rate=0.9, affine_open=50, affine_extend=0)
    q = t[100:1300].copy()
    q[300:600:9] = (q[300:600:9] + 1) % 4
    q = np.concatenate([q[:200], rng.integers(0, 4, 200).astype(np.uint8), q[200:]])
    return q, t, dict(indel_rate=0.9, affine_open=50, affine_extend=0)


def _both(q, t, **kw):
    ps, pb = native.sdp_interval_align_plain(q, t, **kw)
    ns, nb = native.sdp_interval_align(q, t, **kw)
    assert ns == ps and nb == [list(b) for b in pb]
    return ns, nb


@pytest.fixture(autouse=True)
def _host_library():
    assert native.available()                    # built by g++, which the tests need


@pytest.mark.parametrize("prefix_len", [0, 50])
@pytest.mark.parametrize("case", SDP_CASES + ["clr", "recursion"])
def test_native_sdp_equals_plain(case, prefix_len):
    q, t, kw = _pair(case)
    _, blocks = _both(q, t, **{**kw, "prefix_len": prefix_len})
    if case != "junk":
        assert blocks                            # a chain was found


def test_native_sdp_runs_the_recursion(monkeypatch):
    """The ``recursion`` pair reaches the global sweep and the gap SW in
    the plain version; the C++ gives its result there."""
    calls = dict.fromkeys(("_sdp_chain_global", "_sw_global"), 0)
    for name in calls:
        fn = getattr(tsr, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tsr, name, counted)
    q, t, kw = _pair("recursion")
    _both(q, t, **kw)
    assert calls["_sdp_chain_global"] > 0 and calls["_sw_global"] > 0


@pytest.mark.parametrize("seed", range(4))
def test_native_sdp_on_repeat_windows(seed):
    """Seeded read windows over a genome with duplicated 2 kb blocks: CCS-
    to CLR-like errors, insertion bursts, N bases, both admission passes'
    settings and the recursion's knobs."""
    rng = np.random.default_rng(seed)
    G = 40_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    for _ in range(5):
        src, dst = rng.integers(0, G - 2_000, 2)
        genome[dst : dst + 2_000] = genome[src : src + 2_000]
    genome[rng.random(G) < 0.001] = 4
    for _ in range(12):
        n = int(rng.integers(200, 2_000))
        start = int(rng.integers(400, G - n - 400))
        err = float(rng.choice([0.003, 0.01, 0.04]))
        q = mutate_read(rng, genome, start, n, sub=err, ins=2 * err, dele=err)
        if rng.random() < 0.3:
            mid = len(q) // 2
            q = np.concatenate([q[:mid], rng.integers(0, 4, 250).astype(np.uint8), q[mid:]])
        t = genome[start - int(rng.integers(0, 400)) : start + n + int(rng.integers(0, 400))]
        kw = dict(indel_rate=0.9, prefix_len=int(rng.choice([0, 50])),
                  word=int(rng.choice([11, 9])), recurse=int(rng.choice([0, 1, 2])),
                  no_recurse_under=int(rng.choice([200, 1000])), cap=int(rng.choice([0, 4])))
        _both(q, t, **kw)


@pytest.mark.parametrize("min_match,deficit", [(12, 0), (12, 5), (14, 0), (14, 5)])
def test_native_anchor_list_equals_plain(min_match, deficit):
    """With and without the index's key-prefix table (``GenomeIndex.lut()``,
    which the runner passes)."""
    rng = np.random.default_rng(min_match + deficit)
    G = 30_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[20_000:21_500] = genome[2_000:3_500]          # a repeat
    genome[9_000:9_040] = 0                              # a run of A
    index = build_index_from_arrays(genome, SeqDB(["a"], np.array([0, G]), ["0" * 32]), k=10)
    np.testing.assert_array_equal(index.sa, native.sais(genome))
    for start, n in ((1_800, 1_000), (8_700, 600), (25_000, 1_200)):
        q = mutate_read(rng, genome, start, n, sub=0.03, ins=0.03, dele=0.02)
        q[::97] = 4
        for sa in (index.sa, index.sa.astype(np.int32)):
            for strand, q_or in enumerate((q, tsr.revcomp_codes(q))):
                args = (q_or, genome, sa, index.sa_kmers, index.k)
                kw = dict(min_match=min_match, length_deficit=deficit)
                want = native.reference_anchor_list_plain(*args, **kw)
                for lut in (None, index.lut()[0]):
                    got = native.reference_anchor_list(*args, **kw, lut=lut)
                    for a, b in zip(want, got):
                        np.testing.assert_array_equal(a, b)
                        assert b.dtype == np.int64
                assert strand == 1 or len(got[0]) > 3


def test_admission_native_equals_plain_and_counts(monkeypatch):
    """``secondary._admit_secondary`` at -bestn 10 on the repeat corpus's
    first two batches: each record's (path, score, guide) from the C++ path,
    replayed through the plain path, is the same; ``native`` counts every
    checked record of the C++ path and none of the plain one."""
    index, reads = repeat_corpus()
    admit = secondary._admit_secondary
    seen = []

    def recorded(state, b, i2, path, met):
        out = admit(state, b, i2, path, met)
        seen.append(((state.mapper, state.batch, state.res), (b, i2, path), out))
        return out

    monkeypatch.setattr(secondary, "_admit_secondary", recorded)
    ops.reset_launch_counts()
    met = MappingMetrics()
    run_mapping(index, reads[:16], BESTN10, device="cpu", metrics=met)
    counts = ops.counters()["secondary"]
    assert counts["native"] == counts["checked"] == met.secondary_checked == len(seen) >= 8
    assert met.secondary_gated >= 1 and met.secondary_replaced >= 1
    assert any(out is not None and out[2] is None for *_, out in seen)  # the DP's path kept

    monkeypatch.setattr(native._build, "load_host_library", lambda: None)
    for batch_args, args, out in seen:
        assert admit(secondary._BatchState(*batch_args), *args, MappingMetrics()) == out
    counts = ops.counters()["secondary"]
    assert counts["checked"] == 2 * len(seen) and counts["native"] == len(seen)


def test_secondary_tail_is_one_module_and_the_prefix_table_the_index():
    """The run loop reaches the -bestn secondary tail through
    ``pipeline/secondary.py`` alone: ``pipeline/runner.py`` imports neither
    ``native`` nor ``secondary_refine``. A -bestn 10 run on the repeat
    corpus leaves the index with only the attributes its class declares,
    and ``GenomeIndex.lut()`` returns the same arrays on every call."""
    import ast

    with open(runner.__file__) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported |= {f"{node.module}.{a.name}" for a in node.names} | {node.module}
    for name in imported:
        assert not name.endswith((".native", ".secondary_refine")), name
    assert "blasr_tpu_torch.pipeline.secondary" in imported

    jindex, reads = repeat_corpus()
    s = jindex.seqdb
    index = build_index_from_arrays(jindex.genome, SeqDB(list(s.names), s.starts, list(s.md5s)),
                                    k=jindex.k)
    met = MappingMetrics()
    run_mapping(index, reads[:16], BESTN10, device="cpu", metrics=met)
    assert met.secondary_gated >= 1                     # the anchor list ran
    declared = {f.name for f in dataclasses.fields(GenomeIndex)}
    assert set(vars(index)) <= declared, set(vars(index)) - declared
    first, again = index.lut(), index.lut()
    assert all(a is b for a, b in zip(first, again))
