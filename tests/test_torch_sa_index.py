"""Seeds of k >= 15 and the bisection index of the port against the JAX
package.

The bounded binary searches against ``np.searchsorted(side='left')``;
``GenomeIndex.lut()``; the bisection ``find_anchors`` (k 8, 12, 15) and
``find_anchors_wide`` (k 16, 18, 24, 30) bit for bit at strides 1 and 4
and expand 0, 1 and 2, on a two-contig genome with an N island and
planted repeats (a block copied ten times, so positions with more hits
than ``max_hits_per_pos`` occur, and many tied priorities);
``make_device_index``'s three suffix-array branches and its cache key;
map_batch wire bytes and run_mapping -m 4 lines at k 12 (auto bisection
on a small genome), 15, 16 and 18; reference-format ``.sa`` files across
the packages; and the CLI's ``-sa``, ``-minMatch 18`` and ``-nucmer``
lines against the JAX CLI's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasr_tpu.cli import blasr as jcli
from blasr_tpu.index import artifacts as jart
from blasr_tpu.index import safile as jsafile
from blasr_tpu.io.batching import Read, batch_reads
from blasr_tpu.io.seqdb import SeqDB as JSeqDB
from blasr_tpu.ops import anchors as janc
from blasr_tpu.output.m4 import format_m4 as jax_format_m4
from blasr_tpu.params import MappingParams as JMappingParams
from blasr_tpu.pipeline import mapper as jmap
from blasr_tpu.pipeline.runner import run_mapping as jax_run_mapping
from blasr_tpu_torch.cli import blasr as tcli
from blasr_tpu_torch.index import artifacts as tart
from blasr_tpu_torch.index import safile as tsafile
from blasr_tpu_torch.interop import device_index_from_numpy
from blasr_tpu_torch.io.fasta import write_fasta
from blasr_tpu_torch.io.seqdb import SeqDB
from blasr_tpu_torch.ops import anchors as tanc
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.params import MappingParams
from blasr_tpu_torch.pipeline import mapper as tmap
from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping

from conftest import mutate_read

torch.set_num_threads(1)

NARROW_K = (8, 12, 15)
WIDE_K = (16, 18, 24, 30)


def _genome(G: int = 30_000, seed: int = 1) -> np.ndarray:
    """Random bases with an N island, a 300 bp block copied ten times and a
    500 bp block copied three times."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, G).astype(np.uint8)
    for j in range(10):
        s = 10_000 + 400 * j
        g[s : s + 300] = g[2_000:2_300]
    for s in (20_000, 24_000):
        g[s : s + 500] = g[6_000:6_500]
    g[15_000:15_040] = 4
    return g


GENOME = _genome()
STARTS = np.array([0, 17_000, len(GENOME)], np.int64)


@pytest.fixture(scope="module")
def indexes():
    """k -> (JAX GenomeIndex, port GenomeIndex), built by each package."""
    out = {}
    for k in NARROW_K + WIDE_K + (11,):
        ji = jart.build_index_from_arrays(GENOME, JSeqDB(["a", "b"], STARTS, ["0" * 32] * 2), k)
        ti = tart.build_index_from_arrays(GENOME, SeqDB(["a", "b"], STARTS, ["0" * 32] * 2), k)
        out[k] = (ji, ti)
    return out


@pytest.fixture(scope="module")
def batch():
    """Six reads of one 512 bp bucket: one in the ten-copy block, one over
    the N island, one with N bases, one 17 bp, one empty, one random."""
    rng = np.random.default_rng(2)
    B, L = 6, 512
    codes = np.full((B, L), 4, np.uint8)
    lengths = np.zeros(B, np.int32)
    for b, start in enumerate((1_950, 14_800, 6_100, 30, None, None)):
        if b == 4:
            continue
        if b == 5:
            r = rng.integers(0, 4, 400).astype(np.uint8)
        else:
            r = mutate_read(rng, GENOME, start, 17 if b == 3 else int(rng.integers(300, 500)))[:L]
        codes[b, : len(r)] = r
        lengths[b] = len(r)
    codes[2, ::41] = 4
    return codes, lengths


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_bounded_search_equals_searchsorted(wide):
    """Sorted keys with long runs of duplicates; query ranges that bracket
    the answer (as the prefix table's buckets do), empty ranges, and keys
    below the first and past the last."""
    rng = np.random.default_rng(3)
    G = 5_000
    keys = np.sort(rng.integers(0, 400, G)).astype(np.int64)
    if wide:
        keys = (keys << 6) | rng.integers(0, 64, G)
        keys.sort()
    probe = np.concatenate([rng.integers(-5, (keys[-1] + 5), 300), keys[rng.integers(0, G, 100)],
                            [keys[0], keys[-1], keys[-1] + 1, -1]]).astype(np.int64)
    ans = np.searchsorted(keys, probe, side="left")
    slack = rng.integers(0, 40, (2, len(probe)))
    lo0 = np.maximum(ans - slack[0], 0).astype(np.int32)
    hi0 = np.minimum(ans + slack[1], G).astype(np.int32)
    # empty ranges start at the answer, as an empty prefix bucket does
    empty = np.arange(len(probe)) % 7 == 0
    lo0[empty] = hi0[empty] = ans[empty]
    steps = int(np.ceil(np.log2(int((hi0 - lo0).max()) + 1)))
    if wide:
        arrs = ((keys >> 6).astype(np.int32), (keys & 63).astype(np.int32))
        qs = ((probe >> 6).astype(np.int32), (probe & 63).astype(np.int32))
        ref = janc._bounded_search_wide(*(jnp.asarray(a) for a in (*arrs, *qs, lo0, hi0)), steps)
        got = tanc._bounded_search_wide(*(torch.from_numpy(a) for a in (*arrs, *qs, lo0, hi0)),
                                        steps)
    else:
        arr, q = keys.astype(np.int32), probe.astype(np.int32)
        ref = janc._bounded_search(*(jnp.asarray(a) for a in (arr, q, lo0, hi0)), steps)
        got = tanc._bounded_search(*(torch.from_numpy(a) for a in (arr, q, lo0, hi0)), steps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    # a key past the last one may step beyond G (both packages; the
    # callers test lo < G)
    inside = ans < G
    np.testing.assert_array_equal(got.numpy()[inside], ans[inside])
    assert (got.numpy()[~inside] >= G).all()
    assert (~inside).any() and (ans == 0).any() and (empty & inside).any()


@pytest.mark.parametrize("k", [8, 11, 12, 15, 16, 18, 30])
def test_lut_equals_jax(indexes, k):
    ji, ti = indexes[k]
    np.testing.assert_array_equal(ji.sa_kmers, ti.sa_kmers)
    (jl, js, jm), (tl, ts, tm) = ji.lut(), ti.lut()
    assert jl.dtype == tl.dtype == np.int32
    np.testing.assert_array_equal(jl, tl)
    assert (js, jm) == (ts, tm)
    bits = min(tart.LUT_BITS, 30 if 2 * k > 31 else 2 * k)
    assert len(tl) == (1 << bits) + 1 and tl[-1] == len(GENOME)


def _device_indexes(indexes, k, direct_lut=False):
    ji, ti = indexes[k]
    p = dict(max_read_len=512, min_match_length=k, direct_lut=direct_lut)
    jdi = jmap.make_device_index(ji, JMappingParams(**p))
    tdi = tmap.make_device_index(ti, MappingParams(**p), "cpu")
    return jdi, tdi


@pytest.mark.parametrize("expand", [0, 1, 2])
@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("k", NARROW_K + WIDE_K)
def test_find_anchors_equal_jax(indexes, batch, k, stride, expand):
    codes, lengths = batch
    jdi, tdi = _device_indexes(indexes, k)
    kw = dict(k=k, max_hits_per_pos=8, max_anchors_per_read=128, lut_meta=jdi.lut_meta,
              anchor_stride=stride, expand=expand)
    jc, jl = jnp.asarray(codes), jnp.asarray(lengths)
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lengths)
    if k > 15:
        ref = janc.find_anchors_wide(jc, jl, *jdi.arrays, **kw)
        got = tanc.find_anchors_wide(tc, tl, *tdi.arrays, **kw)
    else:
        sa, sk, lut, run_len = jdi.arrays
        ref = janc.find_anchors(jc, jl, sa, sk, None, lut, run_len, **kw)
        got = tanc.find_anchors_bisect(tc, tl, *tdi.arrays, **kw)
    for name, a, b in zip(("t", "q", "nhits", "valid"), ref, got):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape == (len(codes), 128) and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    valid = got[3].numpy()
    assert valid.sum() > 0
    assert not valid[4].any()                                 # the empty read


def test_repeats_exceed_max_hits(indexes):
    """The ten-copy block gives keys with more than max_hits_per_pos (8)
    genome hits at every k, and a read inside it still anchors elsewhere."""
    for k in NARROW_K + WIDE_K:
        _, ti = indexes[k]
        _, counts = np.unique(ti.sa_kmers, return_counts=True)
        assert counts.max() >= 10, k


@pytest.mark.parametrize("k,direct_lut,G,kind", [
    (12, None, 30_000, "bisect"),          # auto: a genome under 2^20 bases
    (12, True, 30_000, "direct"),
    (12, False, 30_000, "bisect"),
    (15, True, 30_000, "bisect"),          # 2k > 28: bisection although direct_lut is set
    (15, None, 30_000, "bisect"),
    (18, True, 30_000, "wide"),
    (30, None, 30_000, "wide"),
    (8, None, 1 << 20, "direct"),          # auto: 2^20 bases and 2k <= 28
])
def test_make_device_index_equals_jax(k, direct_lut, G, kind):
    genome = GENOME if G == len(GENOME) else _genome(G, seed=5)
    starts = np.array([0, G // 2, G], np.int64)
    ji = jart.build_index_from_arrays(genome, JSeqDB(["a", "b"], starts, ["0" * 32] * 2), k)
    ti = tart.build_index_from_arrays(genome, SeqDB(["a", "b"], starts, ["0" * 32] * 2), k)
    p = dict(max_read_len=512, min_match_length=k, direct_lut=direct_lut)
    jdi = jmap.make_device_index(ji, JMappingParams(**p))
    tdi = tmap.make_device_index(ti, MappingParams(**p), "cpu")
    jarrays = tuple(np.asarray(a) for a in jdi.arrays)
    conv = device_index_from_numpy(
        np.asarray(jdi.genome_pad), jarrays, np.asarray(jdi.starts), pad=jdi.pad, k=jdi.k,
        genome_len=jdi.genome_len, kind=jdi.kind, lut_meta=jdi.lut_meta)
    for di in (tdi, conv):
        assert (di.kind, di.k, di.pad, di.genome_len, di.lut_meta) == (
            kind, k, jdi.pad, jdi.genome_len, tuple(jdi.lut_meta))
        np.testing.assert_array_equal(np.asarray(jdi.genome_pad), di.genome_pad.numpy())
        np.testing.assert_array_equal(np.asarray(jdi.starts), di.starts.numpy())
        assert len(di.arrays) == len(jarrays) == 4
        for j, t in zip(jarrays, di.arrays):
            np.testing.assert_array_equal(j, t.numpy().view(j.dtype))
    shift, max_steps = tdi.lut_meta
    assert (max_steps == 0) == (kind == "direct")
    if kind != "direct":
        assert all(a.dtype == torch.int32 for a in tdi.arrays)
        lut, ls, lm = ti.lut()
        assert (ls, lm) == (shift, max_steps)
        np.testing.assert_array_equal(tdi.arrays[3 if kind == "wide" else 2].numpy(), lut)
    if kind == "bisect":
        run_len = tdi.arrays[3].numpy()
        sk = ti.sa_kmers
        # run_len[i] rows from i on share sa_kmers[i], and the next differs
        end = np.arange(len(sk)) + run_len
        inside = end < len(sk)
        assert (run_len >= 1).all() and (sk[end - 1] == sk).all()
        assert (sk[end[inside]] != sk[inside]).all() and not inside.all()


def test_device_index_cache_keys_direct_lut(indexes):
    """One GenomeIndex mapped with direct_lut=True, then None (bisection on
    this small genome), then False: the direct tables are not handed back
    for bisection. On a genome of 2^20 bases True and None build the same
    direct tables and share one entry."""
    _, ti = indexes[12]
    p = MappingParams(max_read_len=512, min_match_length=12, direct_lut=True)
    direct = tmap.make_device_index(ti, p, "cpu")
    auto = tmap.make_device_index(ti, dataclasses.replace(p, direct_lut=None), "cpu")
    off = tmap.make_device_index(ti, dataclasses.replace(p, direct_lut=False), "cpu")
    assert direct.lut_meta == (0, 0) and auto.lut_meta[1] > 0 and off.lut_meta == auto.lut_meta
    assert auto is not direct and off is auto
    assert tmap.make_device_index(ti, p, "cpu") is direct     # still cached
    G = 1 << 20
    big = tart.build_index_from_arrays(_genome(G, seed=5), SeqDB(["a"], np.array([0, G]),
                                                                  ["0" * 32]), 8)
    p8 = MappingParams(max_read_len=512, min_match_length=8, direct_lut=True)
    d8 = tmap.make_device_index(big, p8, "cpu")
    assert d8.lut_meta == (0, 0)
    assert tmap.make_device_index(big, dataclasses.replace(p8, direct_lut=None), "cpu") is d8
    assert tmap.make_device_index(big, dataclasses.replace(p8, direct_lut=False),
                                  "cpu").lut_meta[1] > 0


def test_wide_index_rejects_k_past_30(indexes):
    """An index the port cannot serve raises, as the JAX package's does."""
    for mod, db in ((tart, SeqDB), (jart, JSeqDB)):
        with pytest.raises(ValueError, match="k=31"):
            mod.build_index_from_arrays(GENOME, db(["a", "b"], STARTS, ["0" * 32] * 2), 31)
    with pytest.raises(ValueError, match="wide keys"):
        tanc.find_anchors_wide(torch.zeros((1, 64), dtype=torch.uint8),
                               torch.zeros(1, dtype=torch.int32), *([torch.zeros(4, dtype=torch.int32)] * 4),
                               k=15, lut_meta=(8, 1))


@pytest.fixture(scope="module")
def corpus():
    """A 100 kb two-contig genome with a planted 2 kb repeat and 16 reads of
    300-900 bp at 6% error, so that seeds of 18 bases occur (every fifth
    with an insertion burst, so band escalation runs)."""
    from blasr_tpu.core.encode import revcomp_codes

    rng = np.random.default_rng(9)
    G = 100_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[70_000:72_000] = genome[10_000:12_000]
    reads = []
    for i in range(16):
        start = int(rng.integers(0, G - 1000)) if i else 10_200
        r = mutate_read(rng, genome, start, int(rng.integers(300, 900)),
                        sub=0.01, ins=0.03, dele=0.02)
        if i % 5 == 4:
            mid = len(r) // 2
            r = np.concatenate([r[:mid], rng.integers(0, 4, 90).astype(np.uint8), r[mid:]])
        if rng.integers(0, 2):
            r = revcomp_codes(r)
        reads.append(Read(f"read{i}", r, None, i))
    starts = np.array([0, 60_000, G], np.int64)
    return genome, starts, reads


def _params(k):
    return MappingParams(batch_size=8, max_read_len=1024, n_candidates=4, n_dp_candidates=2,
                         anchor_stride=4, max_anchors_per_read=128, narrow_band=32,
                         narrow_band_max=1024, min_match_length=k, direct_lut=None,
                         emit_moves=False, best_n=1)


def _corpus_indexes(corpus, k):
    genome, starts, _ = corpus
    ji = jart.build_index_from_arrays(genome, JSeqDB(["a", "b"], starts, ["0" * 32] * 2), k)
    ti = tart.build_index_from_arrays(genome, SeqDB(["a", "b"], starts, ["0" * 32] * 2), k)
    return ji, ti


@pytest.mark.parametrize("k", [12, 15, 16, 18])
def test_map_batch_wire_bytes_equal_jax(corpus, k):
    _, _, reads = corpus
    ji, ti = _corpus_indexes(corpus, k)
    params = _params(k)
    jm = jmap.Mapper(ji, JMappingParams(**dataclasses.asdict(params)))
    tm = tmap.Mapper(ti, params, device="cpu")
    assert tm.device_index.lut_meta[1] > 0                   # never the direct tables here
    n = 0
    for b in batch_reads(reads, params.batch_size, params.max_read_len):
        jr = jm.map_batch(b.codes, b.lengths)
        tr = tm.map_batch(b.codes, b.lengths)
        assert (jr.i2, jr.p, jr.b, jr.rcols) == (tr.i2, tr.p, tr.b, tr.rcols)
        np.testing.assert_array_equal(np.asarray(jr.wire), tr.wire.numpy())
        n += 1
    assert n >= 2


@pytest.mark.parametrize("k", [12, 15, 16, 18])
def test_run_mapping_m4_equals_jax(corpus, k):
    _, _, reads = corpus
    ji, ti = _corpus_indexes(corpus, k)
    params = _params(k)
    jrec, junm = jax_run_mapping(ji, reads, JMappingParams(**dataclasses.asdict(params)))
    met = MappingMetrics()
    trec, tunm = run_mapping(ti, reads, params, device="cpu", metrics=met)
    assert [format_m4(r) for r in trec] == [jax_format_m4(r) for r in jrec]
    assert tunm == junm
    assert len(trec) >= 12 and met.escalated_reads > 0


def test_sa_files_load_across_packages(tmp_path):
    """A .sa written by either package (reference order, with and without
    the prefix lookup table) loads in the other; build_index_from_sa gives
    the same index in both, and the keys of build_index_from_arrays."""
    genome = GENOME[:12_000]
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, [("a", genome[:7_000]), ("b", genome[7_000:])])
    rows = tsafile.reference_order_sa(genome)
    np.testing.assert_array_equal(rows, jsafile.reference_order_sa(genome))
    assert len(rows) == len(genome) + 1 and rows[-1] == len(genome)
    for writer, reader, name in ((tsafile, jsafile, "port"), (jsafile, tsafile, "jax")):
        for lpl in (0, 4):
            path = str(tmp_path / f"{name}{lpl}.sa")
            writer.write_sa_file(path, rows, genome=genome, lookup_prefix_len=lpl)
            np.testing.assert_array_equal(reader.read_sa_file(path, genome_len=len(genome)),
                                          rows[:-1])
            a, b = tsafile.read_sa_lookup(path), jsafile.read_sa_lookup(path)
            assert (a is None) == (b is None) == (lpl == 0)
            if a is not None:
                assert a[0] == b[0] == lpl
                np.testing.assert_array_equal(a[1], b[1])
                np.testing.assert_array_equal(a[2], b[2])
            for k in (12, 18):
                ti = tart.build_index_from_sa(fa, path, k=k)
                ji = jart.build_index_from_sa(fa, path, k=k)
                for f in ("genome", "sa", "sa_kmers", "pos_ok"):
                    x, y = getattr(ti, f), getattr(ji, f)
                    assert x.dtype == y.dtype, f
                    np.testing.assert_array_equal(x, y, f)
                full = tart.build_index_from_arrays(genome, ti.seqdb, k)
                np.testing.assert_array_equal(ti.sa_kmers, full.sa_kmers)
    assert open(str(tmp_path / "port4.sa"), "rb").read() == open(str(tmp_path / "jax4.sa"),
                                                                  "rb").read()
    with open(str(tmp_path / "bad.sa"), "wb") as f:
        f.write(b"\0" * 16)
    for mod in (tsafile, jsafile):
        with pytest.raises(ValueError, match="magic"):
            mod.read_sa_file(str(tmp_path / "bad.sa"))


@pytest.fixture(scope="module")
def cli_corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sa_cli")
    rng = np.random.default_rng(12)
    genome = rng.integers(0, 4, 40_000).astype(np.uint8)
    fa = str(tmp / "g.fa")
    write_fasta(fa, [("c1", genome[:25_000]), ("c2", genome[25_000:])])
    reads = []
    for i in range(6):
        s = int(rng.integers(0, 39_000))
        r = genome[s : s + 600].copy()
        r[::43] = (r[::43] + 1) % 4
        reads.append((f"q{i}", r))
    write_fasta(str(tmp / "r.fa"), reads)
    tsafile.write_sa_file(str(tmp / "g.sa"), tsafile.reference_order_sa(genome))
    return tmp


@pytest.mark.parametrize("flags", [
    pytest.param(["-minMatch", "18", "-sa", "{sa}"], id="sa-k18"),
    pytest.param(["-minMatch", "15", "-sa", "{sa}"], id="sa-k15"),
    pytest.param(["-minMatch", "18"], id="k18"),
    pytest.param(["-nucmer"], id="nucmer"),
    pytest.param(["-minMatch", "16", "-sa", "{sa}", "-bwt", "{bwt}"], id="bwt-over-sa"),
])
def test_cli_lines_equal_jax(cli_corpus, flags):
    tmp = cli_corpus
    flags = [f.format(sa=tmp / "g.sa", bwt=tmp / "g.btfm.npz") for f in flags]
    common = [str(tmp / "r.fa"), str(tmp / "g.fa"), "-m", "4", "-batchSize", "4",
              "-maxReadLen", "1024", *flags]
    jout, tout = tmp / "jax.m4", tmp / "port.m4"
    assert jcli.main([*common, "-out", str(jout)]) == 0
    assert tcli.main([*common, "-device", "cpu", "-out", str(tout)]) == 0
    lines = tout.read_text().splitlines()
    assert lines == jout.read_text().splitlines()
    assert len(lines) >= 5
