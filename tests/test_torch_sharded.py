"""The port's sharded index and host parts against the JAX package.

An 80 kb two-contig genome cut into 3 or 4 shards (k = 13, the shapes of
``tests/test_sharded.py``) and 12 reads of up to 500 bases: ``make_shards``, ``build_shard_index``'s
arrays, the shard caches and routing sketches across the packages,
``route_reads``, and ``run_mapping_sharded``'s records (broadcast
concurrent and serial, routed, ``lazy_load`` from a cache the JAX
package wrote) and ``ShardedServer`` over repeated calls with
``max_resident``, each equal to the JAX package's -m 4 lines on the same
reads. The host parts: every format's part files and the merged file
byte-equal to the JAX package's; ``init_distributed`` without an
environment. Shards map on the CPU here (``devices=["cpu"]``); a CUDA
device this machine lacks raises."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from blasr_tpu.index.artifacts import GenomeIndex as JGenomeIndex
from blasr_tpu.index.artifacts import build_index_from_arrays as jbuild_index
from blasr_tpu.io.seqdb import SeqDB
from blasr_tpu.output.m4 import format_m4 as jformat_m4
from blasr_tpu.output import sam_writer as jsam
from blasr_tpu.parallel import multihost as jmh
from blasr_tpu.parallel import sharded as jsh
from blasr_tpu.params import MappingParams as JParams
from blasr_tpu.sim import simulate_genome, simulate_reads
from blasr_tpu_torch.index.artifacts import GenomeIndex
from blasr_tpu_torch.index.artifacts import build_index_from_arrays
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.output import sam_writer as tsam
from blasr_tpu_torch.parallel import multihost as tmh
from blasr_tpu_torch.parallel import sharded as tsh
from blasr_tpu_torch.params import MappingParams

torch.set_num_threads(1)

K = 13
KW = dict(batch_size=8, max_read_len=1024, n_candidates=2, best_n=1, min_match_length=K)
PARAMS = MappingParams(**KW)
JPARAMS = JParams(**KW)
CPU = ["cpu"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    g = simulate_genome(80_000, seed=21, repeat_fraction=0.0)
    seqdb = SeqDB(["cA", "cB"], np.array([0, 50_000, 80_000], np.int64), ["0" * 32] * 2)
    reads = _short_reads(g, 12, seed=3)
    gpath = str(d / "g.fa")
    open(gpath, "w").write(">g\n")              # a stand-in for the cache's mtime check
    return g, seqdb, reads, gpath


def _short_reads(g, n, seed):
    """``n`` simulated reads of at most 500 bases: two length buckets, so
    the JAX side compiles few programs."""
    reads, _ = simulate_reads(g, 4 * n, mean_len=300, seed=seed)
    return [r for r in reads if len(r) <= 500][:n]


def _lines(recs, fmt=format_m4):
    return [fmt(r) for r in recs]


@pytest.fixture(scope="module")
def jax_runs(corpus):
    g, seqdb, reads, _ = corpus
    out = {}
    for name, kw in (("broadcast", {}), ("routed", dict(route=True))):
        recs, unm = jsh.run_mapping_sharded(g, seqdb, reads, JPARAMS, n_shards=4, k=K,
                                            devices=jax.devices()[:4], concurrent=False, **kw)
        out[name] = (_lines(recs, jformat_m4), unm)
    return out


@pytest.mark.parametrize("G,n,ovl", [(1000, 4, 100), (80_000, 3, 1280), (1001, 7, 0),
                                     (10, 4, 3)])
def test_make_shards_equal_jax(G, n, ovl):
    assert tsh.make_shards(G, n, ovl) == [tsh.ShardSpec(*dataclasses.astuple(s))
                                          for s in jsh.make_shards(G, n, ovl)]


def test_build_shard_index_and_caches_equal_jax(corpus, tmp_path):
    """Each shard's arrays and segment database; a cache either package
    wrote loads in the other (uncompressed with ``compress=False``)."""
    g, seqdb, _, gpath = corpus
    for s, spec in enumerate(tsh.make_shards(len(g), 4, 1280)):
        jspec = jsh.make_shards(len(g), 4, 1280)[s]
        ji = jsh.build_shard_index(g, seqdb, jspec, K)
        ti = tsh.build_shard_index(g, seqdb, spec, K)
        for f in ("genome", "sa", "sa_kmers", "pos_ok"):
            a, b = getattr(ji, f), getattr(ti, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (s, f)
        assert (ji.k, ji.seqdb.names, list(ji.seqdb.md5s)) == (ti.k, ti.seqdb.names,
                                                               list(ti.seqdb.md5s))
        assert np.array_equal(ji.seqdb.starts, ti.seqdb.starts)
        jp, tp = str(tmp_path / f"j{s}.npz"), str(tmp_path / f"t{s}.npz")
        ji.save(jp, compress=False)
        ti.save(tp, compress=False)
        for loaded in (GenomeIndex.load(jp), JGenomeIndex.load(tp)):
            assert np.array_equal(loaded.sa, ti.sa) and np.array_equal(loaded.pos_ok, ti.pos_ok)
    assert tsh.shard_cache_path(gpath, 4, K, 2, 1280) == jsh.shard_cache_path(gpath, 4, K, 2, 1280)
    assert tsh.sketch_cache_path(gpath, 4, 1, 1280) == jsh.sketch_cache_path(gpath, 4, 1, 1280)


def test_sketches_and_routes_equal_jax(corpus):
    g, _, reads, _ = corpus
    rng = np.random.default_rng(5)
    for k in (5, 14, 21):
        keys = rng.integers(0, 1 << (2 * k), 500).astype(np.int64)
        assert np.array_equal(tsh._canonical_keys(keys, k), jsh._canonical_keys(keys, k))
        assert np.array_equal(tsh._revcomp_keys(keys, k), jsh._revcomp_keys(keys, k))
    specs = tsh.make_shards(len(g), 3, 1280)
    tsk = [tsh.build_shard_sketch(g[s.block_lo : s.block_hi], k=10) for s in specs]
    jsk = [jsh.build_shard_sketch(g[s.block_lo : s.block_hi], k=10) for s in specs]
    assert all(a.tobytes() == b.tobytes() for a, b in zip(tsk, jsk))
    short = [dataclasses.replace(r, codes=r.codes[:60]) for r in reads[:2]]
    troutes = tsh.route_reads(list(reads) + short, tsk, k=10)
    jroutes = jsh.route_reads(list(reads) + short, jsk, k=10)
    assert [list(r) for r in troutes] == [list(r) for r in jroutes]
    assert sum(len(r) for r in troutes[:-2]) < 2 * len(reads)     # the router prunes
    assert list(troutes[-1]) == [0, 1, 2]                          # too short: every shard


@pytest.mark.parametrize("mode", ["broadcast-concurrent", "broadcast-serial", "routed",
                                  "routed-lazy-from-jax-cache"])
def test_run_mapping_sharded_equals_jax(corpus, jax_runs, mode, tmp_path):
    g, seqdb, reads, _ = corpus
    # two device names of the CPU, so the concurrent mode runs a thread each
    kw = dict(n_shards=4, k=K, devices=["cpu", "cpu:0"])
    if mode == "broadcast-serial":
        kw["concurrent"] = False
    if mode.startswith("routed"):
        kw["route"] = True
    if mode.endswith("jax-cache"):
        gpath = str(tmp_path / "g.fa")
        open(gpath, "w").write(">g\n")
        overlap = PARAMS.max_read_len + PARAMS.target_pad
        specs = jsh.make_shards(len(g), 4, overlap)
        jsh.build_or_load_shards(g, seqdb, specs, K, gpath, overlap)
        kw.update(lazy_load=True, genome_path=gpath)
        assert all(os.path.exists(jsh.shard_cache_path(gpath, 4, K, s, overlap))
                   for s in range(4))
    recs, unm = tsh.run_mapping_sharded(g, seqdb, reads, PARAMS, **kw)
    want = jax_runs["broadcast" if mode.startswith("broadcast") else "routed"]
    assert (_lines(recs), unm) == want
    assert len(recs) >= len(reads) - 2


def test_sharded_server_equals_jax(corpus):
    """Repeated map() calls, routed, with at most two shards' device
    indexes kept between calls (the last two the LRU order used)."""
    g, seqdb, _, _ = corpus
    jsrv = jsh.ShardedServer(g, seqdb, JPARAMS, n_shards=4, k=K, max_resident=2)
    tsrv = tsh.ShardedServer(g, seqdb, PARAMS, n_shards=4, k=K, devices=CPU, max_resident=2)
    for seed in (91, 92):
        reads = _short_reads(g, 6, seed)
        a, ua = tsrv.map(reads)
        b, ub = jsrv.map(reads)
        assert (_lines(a), ua) == (_lines(b, jformat_m4), ub)
        resident = [s for s, ix in enumerate(tsrv.indexes)
                    if "_torch_device_index_cache" in ix.__dict__]
        assert resident == sorted(tsrv._lru[-2:])
    with pytest.raises(ValueError, match="overlap"):
        tsrv.map(reads, dataclasses.replace(PARAMS, max_read_len=512))


@pytest.fixture(scope="module")
def part_corpus():
    g = simulate_genome(50_000, seed=81, repeat_fraction=0.0)
    seqdb = SeqDB(["ref"], np.array([0, len(g)], np.int64), ["0" * 32])
    reads = [r for r in simulate_reads(g, 40, mean_len=400, seed=82)[0]
             if 350 <= len(r) <= 500][:8]
    return jbuild_index(g, seqdb, k=K), build_index_from_arrays(g, seqdb, k=K), reads


@pytest.mark.parametrize("fmt", ["m4", "sam", "m0", "m1", "m2", "m3", "m5"])
def test_host_parts_and_merge_equal_jax(part_corpus, tmp_path, fmt):
    jindex, tindex, reads = part_corpus
    kw = dict(batch_size=8, max_read_len=512, n_candidates=2, best_n=1, min_match_length=K)
    extra = dict(movie_name="reads.fa") if fmt == "sam" else {}
    for pid in range(2):
        jmh.run_mapping_host_part(jindex, reads, JParams(**kw), str(tmp_path / "j"), pid, 2,
                                  fmt=fmt, **extra)
        tmh.run_mapping_host_part(tindex, reads, MappingParams(**kw), str(tmp_path / "t"),
                                  pid, 2, fmt=fmt, device="cpu", **extra)
        assert (open(tmh.part_path(str(tmp_path / "t"), pid)).read()
                == open(jmh.part_path(str(tmp_path / "j"), pid)).read())
    header = None
    if fmt == "sam":
        header = tsam.sam_header(tindex.seqdb, "blasr_tpu", ["reads.fa"])
        assert header == jsam.sam_header(jindex.seqdb, "blasr_tpu", ["reads.fa"])
    n_t = tmh.merge_host_parts(str(tmp_path / "t"), str(tmp_path / "t.out"), 2, header)
    n_j = jmh.merge_host_parts(str(tmp_path / "j"), str(tmp_path / "j.out"), 2, header)
    assert n_t == n_j >= 7
    assert open(tmp_path / "t.out").read() == open(tmp_path / "j.out").read()
    with pytest.raises(FileNotFoundError):
        tmh.merge_host_parts(str(tmp_path / "t"), str(tmp_path / "x.out"), 3)


def test_escapes_and_init_distributed(monkeypatch):
    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert tmh.init_distributed() == jmh.init_distributed() == (0, 1)
    for s in ("a\nb", "back\\slash\\n", "", "x\\\ny\n"):
        assert tmh._esc(s) == jmh._esc(s) and tmh._unesc(tmh._esc(s)) == s
    assert tmh.host_shard(list(range(7)), 1, 3) == jmh.host_shard(list(range(7)), 1, 3)


def test_missing_cuda_device_raises(corpus, part_corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a card")
    g, seqdb, reads, _ = corpus
    with pytest.raises(RuntimeError, match="cuda"):
        tsh.run_mapping_sharded(g, seqdb, reads[:2], PARAMS, n_shards=2, k=K,
                                devices=["cuda:0"])
    with pytest.raises(ValueError, match="CUDA device"):
        tsh.run_mapping_sharded(g, seqdb, reads[:2], PARAMS, n_shards=2, k=K)
    _, tindex, preads = part_corpus
    with pytest.raises(RuntimeError, match="cuda"):
        tmh.run_mapping_host_part(tindex, preads, PARAMS, str(tmp_path / "p"))
