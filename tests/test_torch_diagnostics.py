"""The CLI's diagnostic writers of the port (-anchors, -fullMetrics,
-clusters, -lcpBounds) against the JAX CLI's files on the CPU.

Both CLIs run in this process (the port with ``-device cpu``) on the
corpus of ``tests/test_torch_cli_host.py`` (a 60 kb genome, 24 reads of
120-235 bases): at k = 13 with command A's selectors and compatibility
flags (``chip_smoke.CLI_HOST_SELECTORS``, ``CLI_HOST_COMPAT``), where the
anchors come from bisection over the prefix table; at k = 18, where they
come from wide keys; and with ``-bwt``, where FM backward search finds
them and -lcpBounds warns and writes nothing. Every file equals the JAX
CLI's byte for byte, with two named departures (``ROADMAP.md`` queue 3):
-anchors lists one read position's hits by genome position, where the
JAX dump leaves them in the order of numpy's sort, which is not stable
(``pipeline/debug.canonical_anchor_lines`` puts the JAX file in that
order); and under a selector, -fullMetrics keys records by stream index,
so it equals the JAX CLI's on a file of the selected reads alone, where
the JAX CLI's own rows carry other reads' records. The Cells column with
band escalation is held in ``tests/test_torch_cli_host.py``."""

import numpy as np
import pytest
import torch

from blasr_tpu.cli.blasr import main as jax_main
from blasr_tpu.io.batching import read_records as jread_records
from blasr_tpu.io.fasta import write_fasta
from blasr_tpu.sim import simulate_genome
from blasr_tpu_torch.cli import blasr as tcli
from blasr_tpu_torch.pipeline.debug import canonical_anchor_lines

from test_torch_cli_host import COMMAND_A_SELECTORS, FLAGS, _lines, _short_reads

torch.set_num_threads(1)

# chip_smoke.CLI_HOST_COMPAT
COMPAT = ["-nproc", "16", "-V", "1", "-affineAlign", "-noSplitSubreads", "-maxLCPLength", "16",
          "-useQuality"]
SIDE_FILES = ("anchors", "fullMetrics", "clusters", "lcpBounds")


def _side_args(d, tag, files=SIDE_FILES):
    return [a for kind in files for a in (f"-{kind}", str(d / f"{tag}.{kind}"))]


def _run_both(d, reads, genome, argv, files=SIDE_FILES):
    """The JAX CLI and the port on the same command line with the side
    files: {kind: (JAX lines, port lines)} for -out and each file."""
    assert jax_main([reads, genome, *argv, "-out", str(d / "j.out"),
                     *_side_args(d, "j", files)]) == 0
    assert tcli.main([reads, genome, *argv, "-device", "cpu", "-out", str(d / "t.out"),
                      *_side_args(d, "t", files)]) == 0
    return {kind: (_lines(d / f"j.{kind}"), _lines(d / f"t.{kind}"))
            for kind in ("out", *files)}


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("diag")
    g = simulate_genome(60_000, seed=51, repeat_fraction=0.0)
    write_fasta(str(d / "g.fa"), [("ref", g)])
    write_fasta(str(d / "r.fa"), _short_reads(g, 24, seed=52))
    return d


@pytest.fixture(scope="module")
def k13(genome, tmp_path_factory):
    """Command A's flags at k = 13, and the JAX CLI's -fullMetrics on the
    selected reads' own file."""
    d = tmp_path_factory.mktemp("k13")
    files = _run_both(d, str(genome / "r.fa"), str(genome / "g.fa"),
                      [*FLAGS, *COMMAND_A_SELECTORS, *COMPAT])
    own = d / "own"
    own.mkdir()
    reads = jread_records(str(genome / "r.fa"))
    sel = reads[3::2]
    rng = np.random.default_rng(7)
    sel = [r for r in sel if rng.random() < 0.8]
    write_fasta(str(own / "r.fa"), [(r.name, r.codes) for r in sel])
    assert jax_main([str(own / "r.fa"), str(genome / "g.fa"), *FLAGS, *COMPAT,
                     "-out", str(d / "own.out"), "-fullMetrics", str(d / "own.fullMetrics")]) == 0
    files["own_out"] = _lines(d / "own.out")
    files["own_fullMetrics"] = _lines(d / "own.fullMetrics")
    return files


@pytest.mark.parametrize("kind", ["out", "clusters", "lcpBounds"])
def test_k13_files_under_selectors_equal_jax(k13, kind):
    jax, port = k13[kind]
    assert port == jax and len(port) > 4


def test_k13_anchors_by_bisection_equal_jax(k13):
    jax, port = k13["anchors"]
    assert port == canonical_anchor_lines(jax)
    assert len(port) > 100 and {ln.split()[1] for ln in port} == {"0", "1"}


def test_k13_full_metrics_keys_records_by_stream_index(k13):
    """The port's rows equal the JAX CLI's on the selected reads' own file
    (stream index = position there); the JAX CLI's rows under the
    selectors put records on other reads."""
    jax, port = k13["fullMetrics"]
    own = k13["own_fullMetrics"]
    assert k13["own_out"] == k13["out"][0]
    assert port[0].startswith("#") and port[1:] == own[1:]
    assert jax[1:] != own[1:]
    mapped = {ln.split()[0].rpartition("/")[0] for ln in k13["out"][1]}
    assert {r.split()[0] for r in port[2:] if r.split()[2] == "1"} == mapped


@pytest.fixture(scope="module")
def k18(genome, tmp_path_factory):
    d = tmp_path_factory.mktemp("k18")
    return _run_both(d, str(genome / "r.fa"), str(genome / "g.fa"),
                     [*FLAGS, "-minMatch", "18"])


@pytest.mark.parametrize("kind", ["out", "fullMetrics", "clusters", "lcpBounds", "anchors"])
def test_k18_files_by_wide_keys_equal_jax(k18, kind):
    jax, port = k18[kind]
    if kind == "fullMetrics":
        jax, port = jax[1:], port[1:]
    if kind == "anchors":
        jax = canonical_anchor_lines(jax)
    assert port == jax and len(port) > 4


def test_bwt_anchors_by_fm_search_equal_jax(genome, tmp_path):
    """-anchors on the -bwt path: ``dump_anchors`` with an FM index (each
    package's, built from the genome) at the CLI's parameters."""
    import io

    from blasr_tpu.index.artifacts import GenomeIndex as JGenomeIndex
    from blasr_tpu.index.artifacts import build_pos_ok as jbuild_pos_ok
    from blasr_tpu.index.fm import build_fm_index as jbuild_fm
    from blasr_tpu.index.suffix_array import build_suffix_array as jbuild_sa
    from blasr_tpu.io.seqdb import load_genome as jload_genome
    from blasr_tpu.pipeline.debug import dump_anchors as jdump_anchors
    from blasr_tpu_torch.io.batching import read_records
    from blasr_tpu_torch.pipeline.debug import dump_anchors

    argv = [str(genome / "r.fa"), str(genome / "g.fa"), *FLAGS]
    params = tcli.params_from_args(tcli.build_parser().parse_args(argv))
    index, fm = tcli.load_fm_index(str(genome / "g.fa"), str(tmp_path / "g.btfm.npz"), 13)
    port = io.StringIO()
    dump_anchors(index, read_records(str(genome / "r.fa")), params, port, device="cpu", fm=fm)
    g, seqdb = jload_genome(str(genome / "g.fa"))
    empty = np.zeros(0, np.int32)
    jindex = JGenomeIndex(g, empty, empty, jbuild_pos_ok(g, seqdb, 13), 13, seqdb)
    from blasr_tpu.cli.blasr import build_arg_parser, params_from_args

    jparams = params_from_args(build_arg_parser().parse_args(argv))
    jax = io.StringIO()
    jdump_anchors(jindex, jread_records(str(genome / "r.fa")), jparams, jax,
                  fm=jbuild_fm(g, jbuild_sa(g)))
    lines = port.getvalue().splitlines()
    assert lines == canonical_anchor_lines(jax.getvalue().splitlines())
    assert len(lines) > 100


def test_bwt_lcp_bounds_warns_and_writes_nothing(genome, tmp_path, capsys):
    """-lcpBounds needs the suffix array's keys: on the -bwt path the port
    writes no file and warns, as the JAX CLI does."""
    assert tcli.main([str(genome / "r.fa"), str(genome / "g.fa"), *FLAGS, "-device", "cpu",
                      "-readIndex", "0", "-bwt", str(tmp_path / "g.btfm.npz"),
                      "-out", str(tmp_path / "o.m4"), "-lcpBounds", str(tmp_path / "lcp")]) == 0
    assert "warning: -lcpBounds needs the suffix-array index" in capsys.readouterr().err
    assert not (tmp_path / "lcp").exists()
