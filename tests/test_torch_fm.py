"""The -bwt (FM-index) anchoring path of the port against the JAX package.

``ops/fm_search``'s backward search, locate and anchor selection bit for
bit on seeded genomes (an 8000 bp genome with an N island, and one whose
n = G + 1 is a multiple of the 128-byte rank row), at anchor strides 1 and
4 and k 12 and 16; the popcount helper against ``np.bitwise_count``; the
FM device index and its numpy interop; map_batch wire bytes, run_mapping
records (best_n 1 and 2: FM-only indexes skip the secondary admission's
anchor gate) and the ``-bwt`` CLI's lines (bundle built, then loaded)
against the JAX package's."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasr_tpu.cli import blasr as jcli
from blasr_tpu.index import fm as jfm
from blasr_tpu.index.artifacts import GenomeIndex as JGenomeIndex
from blasr_tpu.index.artifacts import build_pos_ok as jbuild_pos_ok
from blasr_tpu.index.suffix_array import build_suffix_array as jbuild_sa
from blasr_tpu.io.batching import Read, batch_reads
from blasr_tpu.io.seqdb import SeqDB as JSeqDB
from blasr_tpu.output.m4 import format_m4 as jax_format_m4
from blasr_tpu.ops import fm_search as jfs
from blasr_tpu.pipeline import mapper as jmap
from blasr_tpu.pipeline.runner import run_mapping as jax_run_mapping
from blasr_tpu_torch.cli import blasr as tcli
from blasr_tpu_torch.index import fm as tfm
from blasr_tpu_torch.index.artifacts import GenomeIndex, build_index_from_arrays, build_pos_ok
from blasr_tpu_torch.interop import device_index_from_numpy
from blasr_tpu_torch.io.fasta import write_fasta
from blasr_tpu_torch.io.seqdb import SeqDB
from blasr_tpu_torch.ops import fm_search as tfs
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.pipeline import mapper as tmap
from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping

from conftest import mutate_read
from test_torch_slice import BASE

torch.set_num_threads(1)

GENOMES = ("n_island_8000", "rows_1023")


def _genome(name: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if name == "n_island_8000":                  # tests/test_fm.py's fixture
        g = rng.integers(0, 4, 8000).astype(np.uint8)
        g[500:520] = 4
        return g
    return rng.integers(0, 4, 1023).astype(np.uint8)   # n = 1024 = 8 rows


@pytest.fixture(scope="module", params=GENOMES)
def fm_case(request):
    """(genome, FMIndex, JAX args, port args, reads, lengths, pos_ok)."""
    g = _genome(request.param)
    fm = tfm.build_fm_index(g, jbuild_sa(g))
    arrs = (fm.bwt_rows, fm.occ_bins, fm.C.astype(np.int32), fm.ssa_mask,
            fm.ssa_base, fm.ssa_vals.astype(np.int32))
    jargs = tuple(jnp.asarray(a) for a in arrs)
    targs = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)
    targs = targs[:3] + (torch.from_numpy(fm.ssa_mask.astype(np.int64)),) + targs[4:]
    rng = np.random.default_rng(len(g))
    B, L = 6, 300
    codes = np.full((B, L), 4, np.uint8)
    lengths = np.array([300, 300, 251, 17, 0, 160], np.int32)
    for b in range(B):
        s = int(rng.integers(0, len(g) - L))
        codes[b, : lengths[b]] = g[s : s + lengths[b]]
    codes[1, ::37] = 4                           # N bases in a read
    codes[5] = rng.integers(0, 4, L)             # mostly unseen k-mers
    codes[5, 160:] = 4
    pos_ok = rng.random(len(g)) > 0.1
    return g, fm, jargs, targs, codes, lengths, pos_ok


def test_popcount32_equals_bitwise_count():
    rng = np.random.default_rng(0)
    words = np.concatenate([
        rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32),
        rng.integers(0, 2**16, 100).astype(np.uint32),            # low half only
        rng.integers(0, 2**16, 100).astype(np.uint32) << 16,      # high half only
        np.array([0, 0xFFFFFFFF, 1 << 31, 0x80000001, 0xFFFF, 0xFFFF0000], np.uint32),
    ])
    got = tfs.popcount32(torch.from_numpy(words.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(words).astype(np.int64))


@pytest.mark.parametrize("k", [12, 16])
@pytest.mark.parametrize("stride", [1, 4])
def test_fm_count_kmers_equal_jax(fm_case, k, stride):
    g, fm, jargs, targs, codes, lengths, _ = fm_case
    jlo, jhi = jfs.fm_count_kmers(*jargs[:3], jnp.asarray(codes), jnp.asarray(lengths),
                                  k, fm.n, stride=stride)
    tlo, thi = tfs.fm_count_kmers(*targs[:3], torch.from_numpy(codes),
                                  torch.from_numpy(lengths), k, fm.n, stride=stride)
    np.testing.assert_array_equal(np.asarray(jlo), tlo.numpy())
    np.testing.assert_array_equal(np.asarray(jhi), thi.numpy())
    assert tlo.dtype == thi.dtype == torch.int32
    # the intervals are the host oracle's
    for b, p in ((0, 0), (0, 3 * stride), (2, 200), (1, 0)):
        i = p // stride
        want = tfm.count_host(fm, codes[b, p : p + k])
        bad = p + k > lengths[b] or (codes[b, p : p + k] >= 4).any()
        assert (int(tlo[b, i]), int(thi[b, i])) == ((want[0], want[0]) if bad else want)


def test_fm_locate_equal_jax_on_every_row(fm_case):
    g, fm, jargs, targs, *_ = fm_case
    rows = np.arange(fm.n, dtype=np.int32)
    want = np.asarray(jfs.fm_locate(*jargs, jnp.asarray(rows)))
    got = tfs.fm_locate(*targs, torch.from_numpy(rows))
    np.testing.assert_array_equal(want, got.numpy())
    assert sorted(got.numpy().tolist()) == list(range(fm.n))   # a permutation of 0..G
    for r in (0, 1, fm.n - 1, fm.n // 2):
        assert int(got[r]) == jfm.locate_host(fm, r)


@pytest.mark.parametrize("k", [12, 16])
@pytest.mark.parametrize("stride", [1, 4])
def test_find_anchors_fm_equal_jax(fm_case, k, stride):
    g, fm, jargs, targs, codes, lengths, pos_ok = fm_case
    kw = dict(k=k, n=fm.n, max_hits_per_pos=8, max_anchors_per_read=128,
              anchor_stride=stride)
    want = jfs.find_anchors_fm(jnp.asarray(codes), jnp.asarray(lengths), *jargs,
                               jnp.asarray(pos_ok), **kw)
    got = tfs.find_anchors_fm(torch.from_numpy(codes), torch.from_numpy(lengths), *targs,
                              torch.from_numpy(pos_ok), **kw)
    for w, t in zip(want, got):
        assert t.shape == (codes.shape[0], 128)
        np.testing.assert_array_equal(np.asarray(w), t.numpy())
    assert got[3].sum() > 100                   # anchors were found


def test_fm_anchor_sets_equal_the_sa_paths():
    """The invariant of tests/test_fm.py in the port: FM anchoring finds
    the (t, q) hit set of the suffix array's direct tables when every hit
    fits under the caps."""
    from blasr_tpu_torch.index.artifacts import build_index_from_arrays
    from blasr_tpu_torch.ops.anchors import find_anchors

    rng = np.random.default_rng(4)
    g = rng.integers(0, 4, 8000).astype(np.uint8)
    g[6000:6400] = g[1000:1400]                   # a repeat: two hits a k-mer
    index = build_index_from_arrays(g, SeqDB(["a"], np.array([0, len(g)]), ["0" * 32]), k=12)
    fm = tfm.build_fm_index(g, jbuild_sa(g))
    B, L = 3, 96
    codes = np.stack([g[s : s + L] for s in (1100, 4000, 6100)])
    lengths = np.full(B, L, np.int32)
    kw = dict(k=12, max_hits_per_pos=8, max_anchors_per_read=256)
    di = tmap.make_device_index(index, BASE, "cpu")
    sa_valid, ctab16, lut_full, lut_valid = di.arrays
    sa = find_anchors(torch.from_numpy(codes), torch.from_numpy(lengths), sa_valid, lut_full,
                      lut_valid, ctab16, **kw)
    fdi = tmap.make_device_index(index, BASE, "cpu", fm=fm)
    fa = tfs.find_anchors_fm(torch.from_numpy(codes), torch.from_numpy(lengths), *fdi.arrays,
                             n=fm.n, **kw)
    for b in range(B):
        s1 = {(int(t), int(q)) for t, q, v in zip(sa[0][b], sa[1][b], sa[3][b]) if v}
        s2 = {(int(t), int(q)) for t, q, v in zip(fa[0][b], fa[1][b], fa[3][b]) if v}
        assert s1 == s2 and len(s1) >= L - 12
    assert sum(len({int(t) for t, v in zip(fa[0][b], fa[3][b]) if v}) for b in (0, 2)) > 2 * (L - 11)


def _planted_genome(G: int, seed: int) -> np.ndarray:
    """A random genome with three planted repeat copies (3-8%
    substitutions), so best_n 2 has secondaries."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, G).astype(np.uint8)
    for j, (ln, d) in enumerate([(1200, 0.03), (900, 0.05), (1000, 0.08)]):
        src, dst = 2_000 + j * 8_000, 27_000 + j * 7_000
        seg = g[src : src + ln].copy()
        m = rng.random(ln) < d
        seg[m] = (seg[m] + rng.integers(1, 4, m.sum())) % 4
        g[dst : dst + ln] = seg
    return g


@pytest.fixture(scope="module")
def fm_corpus():
    """A 50 kb two-contig genome with planted repeats and an N run, its FM
    index, the genome-only indexes of both packages (no suffix array, as
    ``-bwt`` builds them) and 16 noisy reads, six over the repeats' sources
    and one with an insertion burst that the narrow band clips."""
    rng = np.random.default_rng(21)
    G = 50_000
    genome = _planted_genome(G, 21)
    genome[40_000:40_050] = 4
    starts = np.array([0, 30_000, G], np.int64)
    names, md5s = ["chrA", "chrB"], ["0" * 32] * 2
    k = BASE.min_match_length
    empty = np.zeros(0, np.int32)
    tindex = GenomeIndex(genome, empty, empty, build_pos_ok(genome, SeqDB(names, starts, md5s), k),
                         k, SeqDB(names, starts, md5s))
    jindex = JGenomeIndex(genome, empty, empty,
                          jbuild_pos_ok(genome, JSeqDB(names, starts, md5s), k), k,
                          JSeqDB(names, starts, md5s))
    fm = tfm.build_fm_index(genome, jbuild_sa(genome))
    reads = []
    for i in range(16):
        start = 2_000 + (i % 3) * 8_000 + 100 if i < 6 else int(rng.integers(0, G - 1100))
        r = mutate_read(rng, genome, start, int(rng.integers(400, 900)))
        if i == 9:
            mid = len(r) // 2
            r = np.concatenate([r[:mid], rng.integers(0, 4, 90).astype(np.uint8), r[mid:]])
        if rng.integers(0, 2):
            r = r[::-1].copy()
            r[r < 4] = 3 - r[r < 4]
        reads.append(Read(f"read{i}", r, None, i))
    return genome, fm, tindex, jindex, reads


def _jax_fm(fm):
    return jfm.FMIndex(fm.bwt_rows, fm.occ_bins, fm.C, fm.ssa_mask, fm.ssa_base,
                       fm.ssa_vals, fm.n)


def test_fm_device_index_equals_jax_and_interop_maps_the_same(fm_corpus):
    genome, fm, tindex, jindex, reads = fm_corpus
    jdi = jmap.make_device_index(jindex, BASE, fm=_jax_fm(fm))
    tdi = tmap.make_device_index(tindex, BASE, "cpu", fm=fm)
    jarrays = tuple(np.asarray(a) for a in jdi.arrays)
    conv = device_index_from_numpy(
        np.asarray(jdi.genome_pad), jarrays, np.asarray(jdi.starts), pad=jdi.pad, k=jdi.k,
        genome_len=jdi.genome_len, kind=jdi.kind, lut_meta=jdi.lut_meta, fm_n=jdi.fm_n)
    for di in (tdi, conv):
        assert (di.kind, di.fm_n, di.lut_meta, di.pad, di.k, di.genome_len) == (
            "fm", fm.n, None, jdi.pad, jdi.k, jdi.genome_len)
        np.testing.assert_array_equal(np.asarray(jdi.genome_pad), di.genome_pad.numpy())
        for j, t in zip(jarrays, di.arrays):
            np.testing.assert_array_equal(j.astype(np.int64), t.numpy().astype(np.int64))
    assert [str(t.dtype) for t in tdi.arrays] == [
        "torch.uint8", "torch.int32", "torch.int32", "torch.int64", "torch.int32",
        "torch.int32", "torch.bool"]
    # cached per fm object; the SA kind of the same index is another entry
    assert tmap.make_device_index(tindex, BASE, "cpu", fm=fm) is tdi
    assert tmap.make_device_index(tindex, BASE, "cpu", fm=tfm.FMIndex(*dataclasses.astuple(fm))) \
        is not tdi
    tm = tmap.Mapper(tindex, BASE, device="cpu", fm=fm)
    b = next(iter(batch_reads(reads, BASE.batch_size, BASE.max_read_len)))
    own = tm.map_batch(b.codes, b.lengths).wire
    tm.device_index = conv
    assert torch.equal(tm.map_batch(b.codes, b.lengths).wire, own)


def test_fm_device_index_takes_any_k_and_the_bisection_setting(fm_corpus):
    """The FM branch takes any k and any direct_lut; without fm the same
    genome at k = 16 gets the suffix-array branch's wide-key index."""
    genome, fm, tindex, _, _ = fm_corpus
    idx16 = dataclasses.replace(tindex, k=16)
    di = tmap.make_device_index(idx16, dataclasses.replace(BASE, direct_lut=False), "cpu", fm=fm)
    assert di.kind == "fm" and di.k == 16
    sa16 = build_index_from_arrays(genome, tindex.seqdb, 16)
    wide = tmap.make_device_index(sa16, BASE, "cpu")
    assert wide.kind == "wide" and wide.k == 16 and wide.lut_meta[1] > 0
    assert [a.shape[0] for a in wide.arrays[:3]] == [len(genome)] * 3


@pytest.mark.parametrize("W", [32, 64])
def test_map_batch_wire_bytes_equal_jax_with_fm(fm_corpus, W):
    genome, fm, tindex, jindex, reads = fm_corpus
    params = dataclasses.replace(BASE, narrow_band=W)
    jm = jmap.Mapper(jindex, params, fm=_jax_fm(fm))
    tm = tmap.Mapper(tindex, params, device="cpu", fm=fm)
    n = 0
    for b in batch_reads(reads, params.batch_size, params.max_read_len):
        jr = jm.map_batch(b.codes, b.lengths)
        tr = tm.map_batch(b.codes, b.lengths)
        np.testing.assert_array_equal(np.asarray(jr.wire), tr.wire.numpy())
        n += 1
    assert n >= 2


@pytest.mark.parametrize("best_n", [1, 2])
def test_run_mapping_records_equal_jax_with_fm(fm_corpus, best_n):
    genome, fm, tindex, jindex, reads = fm_corpus
    params = dataclasses.replace(BASE, best_n=best_n, emit_moves=best_n > 1)
    jrec, junm = jax_run_mapping(jindex, reads, params, fm=_jax_fm(fm))
    met = MappingMetrics()
    trec, tunm = run_mapping(tindex, reads, params, device="cpu", metrics=met, fm=fm)
    assert [format_m4(r) for r in trec] == [jax_format_m4(r) for r in jrec]
    assert tunm == junm and len(trec) >= 14
    assert met.escalated_reads > 0              # the wide-band retry ran on FM anchors
    if best_n == 2:
        # secondaries went through the admission without the anchor gate
        assert len(trec) > len(reads) and met.secondary_checked > 0
        assert met.secondary_gated == 0


@pytest.mark.parametrize("bundle", ["built_then_loaded", "loaded_from_jax"])
def test_bwt_cli_lines_equal_jax(tmp_path, bundle):
    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, 30_000).astype(np.uint8)
    write_fasta(str(tmp_path / "g.fa"), [("c1", genome[:18_000]), ("c2", genome[18_000:])])
    reads = []
    for i in range(6):
        s = int(rng.integers(0, 29_000))
        r = genome[s : s + 600].copy()
        r[::31] = (r[::31] + 1) % 4
        reads.append((f"q{i}", r))
    write_fasta(str(tmp_path / "r.fa"), reads)
    common = [str(tmp_path / "r.fa"), str(tmp_path / "g.fa"), "-m", "4", "-minMatch", "10",
              "-batchSize", "4", "-maxReadLen", "1024"]
    jfile, tfile = tmp_path / "jax.btfm.npz", tmp_path / "port.btfm.npz"
    if bundle == "built_then_loaded":
        # each package builds and saves its own bundle, then loads it
        runs = [("jax", jfile), ("port", tfile), ("jax", jfile), ("port", tfile)]
    else:
        # each package loads the other's bundle
        runs = [("jax", jfile), ("port", tfile), ("jax", tfile), ("port", jfile)]
    lines = []
    for i, (pkg, path) in enumerate(runs):
        existed = path.exists()
        out = tmp_path / f"{i}.m4"
        if pkg == "jax":
            assert jcli.main([*common, "-bwt", str(path), "-out", str(out)]) == 0
        else:
            assert tcli.main([*common, "-bwt", str(path), "-device", "cpu", "-out", str(out)]) == 0
        assert path.exists() and existed == (i >= 2)
        lines.append(out.read_text().splitlines())
    assert len(lines[0]) == 6 and all(ln == lines[0] for ln in lines)
    a, b = np.load(jfile), np.load(tfile)
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key])


def test_bwt_cli_default_bundle_path_and_reference_bwt(tmp_path):
    """``-bwt`` with no FILE caches ``<genome>.btfm.npz``; a reference
    ``.bwt`` (tests/data/ref_golden.bwt, written by the reference's sa2bwt)
    is checked against the FASTA, refused when it does not match, and
    otherwise maps as the JAX CLI does."""
    rng = np.random.default_rng(6)
    genome = rng.integers(0, 4, 12_000).astype(np.uint8)
    write_fasta(str(tmp_path / "g.fa"), [("c1", genome)])
    write_fasta(str(tmp_path / "r.fa"), [("q0", genome[3_000:3_500])])
    opts = ["-m", "4", "-minMatch", "10", "-batchSize", "4", "-maxReadLen", "1024"]
    common = [str(tmp_path / "r.fa"), str(tmp_path / "g.fa"), *opts, "-device", "cpu"]
    assert tcli.main([*common, "-bwt", "-out", str(tmp_path / "a.m4")]) == 0
    assert os.path.exists(str(tmp_path / "g.fa") + tcli.FM_SUFFIX)
    assert tcli.FM_SUFFIX == ".btfm.npz"
    line = (tmp_path / "a.m4").read_text().split()
    assert line[0].startswith("q0/") and line[1] == "c1" and line[9:11] == ["3000", "3500"]
    data = os.path.join(os.path.dirname(__file__), "data")
    golden = os.path.join(data, "ref_golden.bwt")
    with pytest.raises(SystemExit, match="does not match"):
        tcli.main([*common, "-bwt", golden, "-out", str(tmp_path / "b.m4")])
    z = np.load(os.path.join(data, "ref_golden_genome.npz"))
    write_fasta(str(tmp_path / "golden.fa"), [("c1", z["c1"]), ("c2", z["c2"])])
    write_fasta(str(tmp_path / "rg.fa"), [(f"g{i}", z[c][s : s + 700]) for i, (c, s) in
                                          enumerate((("c1", 1_000), ("c2", 5_000), ("c1", 20_000)))])
    args = [str(tmp_path / "rg.fa"), str(tmp_path / "golden.fa"), *opts, "-bwt", golden]
    assert jcli.main([*args, "-out", str(tmp_path / "jg.m4")]) == 0
    assert tcli.main([*args, "-device", "cpu", "-out", str(tmp_path / "tg.m4")]) == 0
    lines = (tmp_path / "tg.m4").read_text().splitlines()
    assert len(lines) == 3 and lines == (tmp_path / "jg.m4").read_text().splitlines()
