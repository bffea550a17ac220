"""The port's copies of the JAX package's host modules against their
originals, and the C++ host helpers against their plain versions.

The port imports nothing of ``blasr_tpu``; these tests hold each copy it
keeps (params, sim, io, index, cli flags, native, the secondary admission,
the verbose and SAM writers, BAM, the FM index, the reference .bwt
reader, the reference .sa file, the prefix table and the index built
around a .sa, the CLI's diagnostic writers and its read selection, the
FM inversion, the seed grid filter, the shredder and the error model
built from SAM) equal to the module it was copied from, on the same
inputs or, for those copied whole (the host tools among them), line for
line."""

import ast
import dataclasses
import fcntl
import gzip
import os

import numpy as np
import pytest

from blasr_tpu import params as jparams
from blasr_tpu import sim as jsim
from blasr_tpu.cli import blasr as jcli
from blasr_tpu.index import artifacts as jart
from blasr_tpu.index import bwtfile as jbwt
from blasr_tpu.index import fm as jfm
from blasr_tpu.index import suffix_array as jsa
from blasr_tpu.io import batching as jbat
from blasr_tpu.io import seqdb as jseqdb
from blasr_tpu_torch import native, params, sim
from blasr_tpu_torch.cli import args as targs
from blasr_tpu_torch.core import encode
from blasr_tpu_torch.index import artifacts, bwtfile, fm, suffix_array
from blasr_tpu_torch.io import batching, seqdb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_jax_native_once() -> None:
    """Build the JAX package's C++ library once for all test processes.

    ``blasr_tpu.native`` compiles ``libblasr_native.so`` in place on first
    use, under a lock that only guards threads; parallel test workers that
    reach it together can load a half-written file and then run without it
    for the rest of the test run. Every worker collects this module before
    any test runs, so building here under a file lock, one worker after
    another, leaves a whole library for all of them."""
    from blasr_tpu import native as jnative

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "blasr_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            jnative.available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


build_jax_native_once()


def test_mapping_params_fields_and_defaults_equal_jax():
    jf = {f.name: f for f in dataclasses.fields(jparams.MappingParams)}
    tf = {f.name: f for f in dataclasses.fields(params.MappingParams)}
    assert list(jf) == list(tf)
    for name, f in jf.items():
        assert (tf[name].default, tf[name].default_factory) == (f.default, f.default_factory), name
    for kw in ({}, dict(narrow_band=0), dict(narrow_band=0, guided_band=True),
               dict(max_read_len=3328, narrow_band_max=3328, narrow_band=32)):
        jp, tp = jparams.MappingParams(**kw), params.MappingParams(**kw)
        for L in (256, 1024, 1536, 1537, 2048, 3328, 8192):
            assert jp.band_width_for(L) == tp.band_width_for(L)
        assert (jp.dp_candidates, jp.target_len, jp.num_dp_steps) == (
            tp.dp_candidates, tp.target_len, tp.num_dp_steps)
    for bad in (dict(band_width=100), dict(narrow_band=48), dict(min_match_length=31),
                dict(best_n=3, n_dp_candidates=2), dict(best_n=7)):
        for cls in (jparams.MappingParams, params.MappingParams):
            with pytest.raises(ValueError):
                cls(**bad).validate()


def test_cli_flags_and_params_equal_jax():
    jp, tp = jcli.build_arg_parser(), targs.build_arg_parser()
    assert [(a.option_strings, a.dest, a.default) for a in jp._actions] == [
        (a.option_strings, a.dest, a.default) for a in tp._actions]
    for argv in ([], ["-bestn", "2", "-nCandidates", "8", "-bandSize", "16", "-ignoreQualities"],
                 ["-minAvgQual", "12.5", "-indel", "4", "-match", "-3", "-sam",
                  "-samqv", "InsertionQV", "SubstitutionQV", "-useSensitiveSearch"]):
        full = ["r.fq", "g.fa", *argv]
        assert dataclasses.asdict(jcli.params_from_args(jp.parse_args(full))) == (
            dataclasses.asdict(targs.params_from_args(tp.parse_args(full))))


def test_sim_corpus_bytes_equal_jax():
    jg = jsim.simulate_genome(60_000, seed=7)
    tg = sim.simulate_genome(60_000, seed=7)
    assert jg.tobytes() == tg.tobytes()
    jr, jt = jsim.simulate_reads(jg, 20, mean_len=500, seed=11)
    tr, tt = sim.simulate_reads(tg, 20, mean_len=500, seed=11)
    assert jt == tt
    assert [(r.name, r.codes.tobytes()) for r in jr] == [(r.name, r.codes.tobytes()) for r in tr]
    for model in ("published_clr", "default"):
        jr, jt = jsim.simulate_reads_alchemy(jg, getattr(jsim.ErrorModel, model)(), 12, seed=13)
        tr, tt = sim.simulate_reads_alchemy(tg, getattr(sim.ErrorModel, model)(), 12, seed=13)
        assert jt == tt
        assert [(r.name, r.codes.tobytes(), r.qual.tobytes()) for r in jr] == [
            (r.name, r.codes.tobytes(), r.qual.tobytes()) for r in tr]
    assert sim.parse_truth(tr[3].name) == jsim.parse_truth(tr[3].name)


@pytest.mark.parametrize("rates,seed", [((0.02, 0.005, 0.005), 1), ((0.1, 0.05, 0.08), 2),
                                        ((0.0, 0.0, 0.0), 3)])
def test_evolve_sequence_bytes_equal_jax(rates, seed):
    """evolve_sequence, which writes config 5's contigs: the same bytes and
    counts as the JAX package's, N bases left unsubstituted."""
    g = jsim.simulate_genome(50_000, seed=7)
    g[1000:1200] = 4
    jout, jstats = jsim.evolve_sequence(g, *rates, seed=seed)
    tout, tstats = sim.evolve_sequence(g, *rates, seed=seed)
    assert tout.dtype == jout.dtype and tout.tobytes() == jout.tobytes() and tstats == jstats


def _sam_line(name, flag, codes, qual, tags):
    return "\t".join([
        name, str(flag), "chr1", "11", "60", f"{len(codes)}M", "*", "0", "0",
        encode.codes_to_seq(codes), (qual + 33).tobytes().decode(), *tags,
    ])


@pytest.fixture
def read_files(tmp_path):
    rng = np.random.default_rng(2)
    recs = [(f"r{i}", rng.integers(0, 5, int(rng.integers(40, 90))).astype(np.uint8))
            for i in range(6)]
    quals = [rng.integers(2, 60, len(c)).astype(np.uint8) for _, c in recs]
    fa = tmp_path / "r.fasta"
    fa.write_text("".join(f">{n} desc\n{encode.codes_to_seq(c)[:30]}\n{encode.codes_to_seq(c)[30:]}\n"
                          for n, c in recs))
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"@{n}\n{encode.codes_to_seq(c)}\n+\n{(q + 33).tobytes().decode()}\n"
                          for (n, c), q in zip(recs, quals)))
    with gzip.open(tmp_path / "r.fastq.gz", "wt") as f:
        f.write(fq.read_text())
    lines = ["@HD\tVN:1.5", "@SQ\tSN:chr1\tLN:1000"]
    for i, ((n, c), q) in enumerate(zip(recs, quals)):
        iq = ((q * 3) % 90).astype(np.uint8)
        tags = [f"iq:Z:{(iq + 33).tobytes().decode()}", f"sq:Z:{(q[::-1] + 33).tobytes().decode()}",
                f"st:Z:{encode.codes_to_seq(c)}", "NM:i:3"]
        if i == 2:
            tags = tags[1:]                      # no iq track
        flag = 16 if i % 2 else 0
        lines.append(_sam_line(f"{n}/0_{len(c)}" if i == 3 else n, flag, c, q, tags))
    lines.append(_sam_line("r1", 256, recs[1][1], quals[1], []))   # secondary: skipped
    (tmp_path / "r.sam").write_text("\n".join(lines) + "\n")
    fofn = tmp_path / "r.fofn"
    fofn.write_text("r.fasta\nr.fastq\n")
    return tmp_path


@pytest.mark.parametrize("name", ["r.fasta", "r.fastq", "r.fastq.gz", "r.sam", "r.fofn"])
def test_read_records_equal_jax(read_files, name):
    path = str(read_files / name)
    jr, tr = jbat.read_records(path), batching.read_records(path)
    assert len(jr) == len(tr) > 0
    for a, b in zip(jr, tr):
        assert (a.name, a.index) == (b.name, b.index)
        np.testing.assert_array_equal(a.codes, b.codes)
        assert (a.qual is None) == (b.qual is None)
        if a.qual is not None:
            np.testing.assert_array_equal(a.qual, b.qual)
        assert (a.qvs or {}).keys() == (b.qvs or {}).keys()
        for k in a.qvs or {}:
            np.testing.assert_array_equal(a.qvs[k], b.qvs[k])
    if name == "r.sam":
        assert any(r.qvs and "iq" in r.qvs for r in tr)
        rev = tr[1]                              # FLAG 16: back to read orientation
        assert encode.codes_to_seq(rev.qvs["st"]) == encode.codes_to_seq(rev.codes)


def test_bam_input_raises(tmp_path):
    """A .bam read file that is not BGZF raises in both packages alike."""
    bad = tmp_path / "r.bam"
    bad.write_text("r1\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t*\n")
    for pkg in (jbat, batching):
        with pytest.raises(ValueError, match="bad BGZF member"):
            pkg.read_records(str(bad))


@pytest.mark.parametrize("mode", ["none", "single", "dual"])
def test_batch_reads_packing_equal_jax(mode):
    rng = np.random.default_rng(4)
    jreads, treads = [], []
    for i in range(23):
        n = int(rng.integers(100, 700))
        codes = rng.integers(0, 5, n).astype(np.uint8)
        qual = rng.integers(0, 60, n).astype(np.uint8)
        qvs = None
        if mode == "single" and i % 3 == 0:
            qual = None                          # a row without quality values
        if mode == "none":
            qual = None
        if mode == "dual":
            qvs = [{"iq": qual[::-1].copy(), "sq": (qual + 100).astype(np.uint8)},
                   {"sq": qual.copy()}, {"iq": (qual + 130).astype(np.uint8)}, None][i % 4]
            qual = None if i % 5 == 0 else qual
        jreads.append(jbat.Read(f"q{i}", codes, qual, i, qvs=qvs))
        treads.append(batching.Read(f"q{i}", codes, qual, i, qvs=qvs))
    jb = list(jbat.batch_reads(jreads, 8, 640))
    tb = list(batching.batch_reads(treads, 8, 640))
    assert len(jb) == len(tb) >= 3
    for a, b in zip(jb, tb):
        for f in ("codes", "lengths", "indices"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.names == b.names
        if mode == "none":
            assert a.qual is None and b.qual is None
        else:
            assert b.qual.dtype == (np.uint16 if mode == "dual" else np.uint8)
            np.testing.assert_array_equal(a.qual, b.qual)


def test_suffix_array_and_index_equal_jax(tmp_path):
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    codes[100:400] = codes[1000:1300]            # a repeat
    np.testing.assert_array_equal(jsa.build_suffix_array(codes), suffix_array.build_suffix_array(codes))
    genome = rng.integers(0, 5, 20_000).astype(np.uint8)
    starts = np.array([0, 7000, 20_000], np.int64)
    ji = jart.build_index_from_arrays(genome, jseqdb.SeqDB(["a", "b"], starts, ["x", "y"]), k=12)
    ti = artifacts.build_index_from_arrays(genome, seqdb.SeqDB(["a", "b"], starts, ["x", "y"]), k=12)
    for f in ("genome", "sa", "sa_kmers", "pos_ok"):
        a, b = getattr(ji, f), getattr(ti, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    # load_index from a FASTA, and the cache file the JAX package writes
    from blasr_tpu.io.fasta import write_fasta

    fa = str(tmp_path / "g.fa")
    write_fasta(fa, [("a", genome[:7000]), ("b", genome[7000:])])
    jl = jart.load_index(fa, k=12)
    tl = artifacts.load_index(fa, k=12)
    assert tl.seqdb.names == jl.seqdb.names and tl.seqdb.md5s == jl.seqdb.md5s
    np.testing.assert_array_equal(tl.sa, jl.sa)


def test_prefix_table_and_sa_input_equal_jax(tmp_path):
    """``GenomeIndex.lut`` (narrow and wide keys) and ``build_index_from_sa``
    on a reference-order ``.sa`` written by the JAX package."""
    from blasr_tpu.index import safile as jsafile
    from blasr_tpu.io.fasta import write_fasta

    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 9_000).astype(np.uint8)
    genome[4_000:4_600] = genome[1_000:1_600]
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, [("a", genome[:5_000]), ("b", genome[5_000:])])
    sa_path = str(tmp_path / "g.sa")
    jsafile.write_sa_file(sa_path, jsafile.reference_order_sa(genome))
    for k in (13, 20):
        ji, ti = jart.build_index_from_sa(fa, sa_path, k), artifacts.build_index_from_sa(fa, sa_path, k)
        for f in ("genome", "sa", "sa_kmers", "pos_ok"):
            assert getattr(ji, f).dtype == getattr(ti, f).dtype, f
            np.testing.assert_array_equal(getattr(ji, f), getattr(ti, f), f)
        (jl, js, jm), (tl, ts, tm) = ji.lut(), ti.lut()
        np.testing.assert_array_equal(jl, tl)
        assert (js, jm) == (ts, tm) and jart.LUT_BITS == artifacts.LUT_BITS


def test_native_helpers_equal_their_plain_versions():
    assert native.available()                    # built by g++, which the tests need
    rng = np.random.default_rng(8)
    for n in (0, 1, 2, 17, 5000):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        np.testing.assert_array_equal(native.sais(codes), suffix_array.build_suffix_array_plain(codes))
    data = b"ACGTNacgtnRYK\n  AC\r\nG\tT" + bytes(rng.integers(33, 127, 500).astype(np.uint8))
    np.testing.assert_array_equal(native.encode_strip(data), native.encode_strip_plain(data))
    packed = rng.integers(0, 256, 40).astype(np.uint8)
    for nops in (0, 1, 5, 160):
        np.testing.assert_array_equal(native.unpack_moves(packed, nops),
                                      native.unpack_moves_plain(packed, nops))


# the functions of a copy that differ on purpose: tools dotplot searches on
# a device the caller names
WHOLE_BUT = {"cli/tools.py": {"_cmd_dotplot"}}


@pytest.mark.parametrize("module", [
    "pipeline/secondary_refine.py", "output/verbose.py", "io/bam.py", "index/safile.py",
    "io/sam.py", "sim.py", "statistics.py", "core/condense.py", "oracle.py", "index/lcp.py",
    "ops/onegap.py", "ops/fullqv.py", "cli/sawriter.py", "cli/bwtutils.py", "cli/tools.py"])
def test_whole_module_copies_equal_jax(module):
    """The copies made whole: the same code as the original once the
    port's package name reads as the JAX package's; only the module
    docstrings differ (and the functions of ``WHOLE_BUT``)."""

    def body(pkg):
        with open(os.path.join(REPO, pkg, module)) as f:
            tree = ast.parse(f.read())
        assert isinstance(tree.body[0], ast.Expr)            # the docstring
        skip = WHOLE_BUT.get(module, set())
        tree.body = [n for n in tree.body[1:] if getattr(n, "name", None) not in skip]
        return ast.unparse(tree).replace("blasr_tpu_torch.", "blasr_tpu.")

    port = body("blasr_tpu_torch")
    assert port == body("blasr_tpu")
    assert "def " in port


def test_sam_writer_copy_equals_jax():
    """``output/sam_writer.py``: every function but the two CIGAR routes and
    ``write_sam`` is the JAX package's code. The CIGAR routes call the
    port's C++ helpers, which never return None, so the JAX writer's numpy
    CIGAR route (``_xeq_runs``) has no copy. ``write_sam`` finds each
    record's read by stream index (``records_by_read``) and formats a
    read's records with ``format_read_records``, which the resumable
    writer shares; where stream index and position agree its text is the
    JAX writer's (``tests/test_torch_sam.py``, ``test_torch_bam.py``)."""

    def functions(pkg):
        with open(os.path.join(REPO, pkg, "output/sam_writer.py")) as f:
            tree = ast.parse(f.read())
        # the package's name, in imports and as the default command line
        return {n.name: ast.unparse(n).replace("blasr_tpu_torch", "blasr_tpu")
                for n in tree.body if isinstance(n, ast.FunctionDef)}

    jf, tf = functions("blasr_tpu"), functions("blasr_tpu_torch")
    added = {"records_by_read", "format_read_records"}
    assert set(jf) - set(tf) == {"_xeq_runs"} and set(tf) - set(jf) == added
    same = set(tf) - {"_cigar_string", "format_sam_record", "write_sam"} - added
    assert len(same) == 5
    for name in same:
        assert tf[name] == jf[name], name


FM_FIELDS = ("bwt_rows", "occ_bins", "C", "ssa_mask", "ssa_base", "ssa_vals")


@pytest.mark.parametrize("G", [1023, 5000])
def test_fm_index_build_and_host_queries_equal_jax(G):
    """``index/fm.py``: the arrays of ``build_fm_index`` (a genome with N
    bases; G = 1023 makes n a multiple of the 128-byte row), and
    ``count_host``/``locate_host`` on patterns and rows."""
    rng = np.random.default_rng(G)
    g = rng.integers(0, 4, G).astype(np.uint8)
    g[rng.integers(0, G, G // 50)] = 4
    sa = jsa.build_suffix_array(g)
    j, t = jfm.build_fm_index(g, sa), fm.build_fm_index(g, sa)
    assert (j.n, j.genome_length) == (t.n, t.genome_length) == (G + 1, G)
    for f in FM_FIELDS:
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    assert (fm.ROW, fm.SAMPLE_D, fm.SENTINEL) == (jfm.ROW, jfm.SAMPLE_D, jfm.SENTINEL)
    for _ in range(40):
        k = int(rng.integers(1, 12))
        s0 = int(rng.integers(0, G - k))
        p = g[s0 : s0 + k].copy()
        assert fm.count_host(t, p) == jfm.count_host(j, p)
        for c, i in ((int(p[0]), s0), (4, G + 1), (5, 0)):
            assert fm.occ_host(t, c, i) == jfm.occ_host(j, c, i)
    for r in [0, G] + rng.integers(0, G + 1, 60).tolist():
        assert fm.locate_host(t, r) == jfm.locate_host(j, r)


def test_fm_bundle_loads_across_packages(tmp_path):
    """A ``.btfm.npz`` written by either package loads in the other with
    the same arrays and keys."""
    rng = np.random.default_rng(2)
    g = rng.integers(0, 5, 3000).astype(np.uint8)
    j = jfm.build_fm_index(g, jsa.build_suffix_array(g))
    t = fm.build_fm_index(g, suffix_array.build_suffix_array(g))
    j.save(str(tmp_path / "jax.btfm.npz"))
    t.save(str(tmp_path / "port.btfm.npz"))
    a, b = np.load(tmp_path / "jax.btfm.npz"), np.load(tmp_path / "port.btfm.npz")
    assert sorted(a.files) == sorted(b.files)
    for loaded, orig in ((fm.FMIndex.load(str(tmp_path / "jax.btfm.npz")), j),
                         (jfm.FMIndex.load(str(tmp_path / "port.btfm.npz")), t)):
        assert loaded.n == orig.n
        for f in FM_FIELDS:
            x, y = getattr(loaded, f), getattr(orig, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, f)


def test_ref_bwt_reader_equal_jax():
    """``index/bwtfile.py`` on the reference's sa2bwt output in tests/data."""
    data = os.path.join(REPO, "tests", "data")
    path = os.path.join(data, "ref_golden.bwt")
    a, b = jbwt.read_ref_bwt(path), bwtfile.read_ref_bwt(path)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    z = np.load(os.path.join(data, "ref_golden_genome.npz"))
    for contigs in ([("c1", z["c1"]), ("c2", z["c2"])], [("c1", z["c1"])]):
        assert bwtfile.ref_bwt_genome_matches(b, contigs) == jbwt.ref_bwt_genome_matches(a, contigs)
    assert bwtfile.ref_bwt_genome_matches(b, [("c1", z["c1"]), ("c2", z["c2"])])


def test_diagnostics_copy_equals_jax():
    """``pipeline/diagnostics.py``: ``write_clusters`` and
    ``write_lcp_bounds`` are the JAX package's code; ``write_full_metrics``
    prints the JAX rows where each read's stream index is its position (on
    hand-built records: two on one read, one on another, a read without
    any), with Cells from ``last_run_dp_cells``, which the JAX function
    reads as ``total_dp_cells``."""
    import io
    from types import SimpleNamespace

    from blasr_tpu.pipeline import diagnostics as jdiag
    from blasr_tpu_torch.pipeline import diagnostics as tdiag

    def functions(pkg):
        with open(os.path.join(REPO, pkg, "pipeline/diagnostics.py")) as f:
            tree = ast.parse(f.read())
        return {n.name: ast.unparse(n) for n in tree.body if isinstance(n, ast.FunctionDef)}

    jf, tf = functions("blasr_tpu"), functions("blasr_tpu_torch")
    assert set(jf) == set(tf)
    for name in ("write_clusters", "write_lcp_bounds"):
        assert tf[name] == jf[name], name
    rng = np.random.default_rng(4)
    reads = [SimpleNamespace(name=f"r{i}", index=i, codes=rng.integers(0, 4, 100 + i))
             for i in range(4)]
    recs = [SimpleNamespace(qname=f"r{i}", read_index=i, score=s, mapqv=q, qstart=a, qend=b)
            for i, s, q, a, b in ((0, -300, 40, 3, 90), (0, -410, 25, 0, 97),
                                  (2, -150, 60, 10, 60))]
    met = SimpleNamespace(dispatch_seconds=0.5, finalize_seconds=0.25, wall_seconds=2.0,
                          total_dp_cells=123457, last_run_dp_cells=123457)
    outs = []
    for mod in (jdiag, tdiag):
        buf = io.StringIO()
        mod.write_full_metrics(buf, reads, recs, ["r1", "r3"], met)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 6


SELECTOR_ARGV = [["-start", "3"], ["-stride", "4"], ["-start", "2", "-stride", "3"],
                 ["-subsample", "0.5", "-randomSeed", "11"],
                 ["-start", "3", "-stride", "2", "-subsample", "0.8", "-randomSeed", "7"],
                 ["-maxReadLength", "130"], ["-maxReadIndex", "7"], ["-readIndex", "5"],
                 ["-readIndices", "2,9,11"],
                 ["-stride", "2", "-maxReadLength", "140", "-readIndices", "0,4,6,9"]]


@pytest.mark.parametrize("argv", SELECTOR_ARGV, ids=[" ".join(a) for a in SELECTOR_ARGV])
def test_read_selection_equals_jax(tmp_path, monkeypatch, argv):
    """``cli/blasr.select_reads`` keeps the reads the JAX CLI maps (its
    ``main`` run with the index load and the mapping stubbed, the reads it
    hands to ``run_mapping`` captured), in the same order."""
    from types import SimpleNamespace

    from blasr_tpu.io.fasta import write_fasta
    from blasr_tpu.pipeline import runner as jrunner
    from blasr_tpu_torch.cli import blasr as tcli

    rng = np.random.default_rng(6)
    path = str(tmp_path / "r.fa")
    write_fasta(path, [(f"q{i}", rng.integers(0, 4, 100 + 3 * i).astype(np.uint8))
                       for i in range(16)])
    captured = []
    monkeypatch.setattr(jart, "load_index", lambda *a, **k: SimpleNamespace())
    monkeypatch.setattr(jrunner, "run_mapping",
                        lambda index, reads, params, **kw: (captured.append(reads), ([], []))[1])
    full = [path, "g.fa", *argv, "-out", str(tmp_path / "o.m4")]
    assert jcli.main(full) == 0
    port = tcli.select_reads(batching.read_records(path), tcli.build_parser().parse_args(full))
    assert [r.name for r in port] == [r.name for r in captured[0]]
    assert [r.index for r in port] == [r.index for r in captured[0]]


@pytest.mark.parametrize("G", [1, 700, 5000])
def test_fm_reconstruct_equals_jax(G):
    """The BWT inverted back to the genome and its full-rotation suffix
    array, N bases included."""
    rng = np.random.default_rng(G)
    g = rng.integers(0, 4, G).astype(np.uint8)
    g[G // 3 : G // 3 + min(20, G // 4)] = 4
    sa = suffix_array.build_suffix_array(g)
    tfm, jfm_ = fm.build_fm_index(g, sa), jfm.build_fm_index(g, sa)
    tg, tsa = fm.fm_reconstruct(tfm)
    jg, jsa_ = jfm.fm_reconstruct(jfm_)
    assert tg.tobytes() == jg.tobytes() == g.tobytes()
    assert tsa.dtype == jsa_.dtype and np.array_equal(tsa, jsa_)


@pytest.mark.parametrize("n,grid", [(0, 40), (1, 40), (300, 40), (2000, 12)])
def test_graph_paper_filter_equals_jax(n, grid):
    """The seed grid filter on a colinear chain among random noise."""
    from blasr_tpu.ops import sdp as jsdp
    from blasr_tpu_torch.ops import sdp

    rng = np.random.default_rng(n)
    q = np.concatenate([np.arange(0, 5 * n, 10), rng.integers(0, 5 * n + 1, n)])[:n]
    t = np.concatenate([np.arange(0, 5 * n, 10) + 777, rng.integers(0, 9 * n + 1, n)])[:n]
    lens = rng.integers(8, 20, n)
    for kw in ({}, dict(n_rows=grid, n_cols=grid // 2, min_score=30, max_score=200)):
        want = jsdp.graph_paper_filter(q, t, lens, **kw)
        got = sdp.graph_paper_filter(q, t, lens, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_shredder_and_error_model_from_sam_equal_jax(tmp_path):
    g = jsim.simulate_genome(30_000, seed=1)
    db = jseqdb.SeqDB(["c1", "c2"], np.array([0, 20_000, 30_000]), ["0" * 32] * 2)
    for cov, seed in ((1.0, 0), (2.5, 4)):
        j = jsim.shred_genome(g, db, 1000, coverage=cov, seed=seed)
        t = sim.shred_genome(g, db, 1000, coverage=cov, seed=seed)
        assert [(n, c.tobytes()) for n, c in j] == [(n, c.tobytes()) for n, c in t]
    rng = np.random.default_rng(3)
    lines = ["@HD\tVN:1.5", "@SQ\tSN:c1\tLN:20000"]
    for i in range(12):
        codes = rng.integers(0, 4, 120).astype(np.uint8)
        cigar = ["100M5I15M", "4S110M2D6M", "120M", "10H60M3I57M"][i % 4]
        qual = "*" if i % 5 == 0 else (rng.integers(5, 40, 120) + 33).astype(np.uint8).tobytes().decode()
        lines.append("\t".join([f"r{i}", "4" if i == 7 else "0", "c1", str(100 + i), "60", cigar,
                                "*", "0", "0", encode.codes_to_seq(codes), qual, f"NM:i:{i % 6}"]))
    path = str(tmp_path / "a.sam")
    open(path, "w").write("\n".join(lines) + "\n")
    assert dataclasses.asdict(sim.build_model_from_sam(path, bins=5)) == dataclasses.asdict(
        jsim.build_model_from_sam(path, bins=5))
