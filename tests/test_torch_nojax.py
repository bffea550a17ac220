"""The port stands alone: subprocesses with ``jax`` and the whole
``blasr_tpu`` package blocked import blasr_tpu_torch and map FASTA and
FASTQ reads end to end on the CPU to -m 4 lines, through the library and
through the CLI (also with ``-useGuidedAlign -scoreMatrix``, to -m 5
lines with ``-bestn 2``, to SAM and BAM with ``-sam``, anchored through
the FM index with ``-bwt``, its bundle built and then loaded, with
seeds of 18 bases from a reference-format ``.sa`` file and of 30 with
``-nucmer``, with ``-resume``, with read selectors and the four
diagnostic writers, and with the optional mapping modes), and no file
of the port imports either package."""

import io
import json
import os
import re
import subprocess
import sys
import tokenize

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = r"""
import sys
for _name in ("jax", "jaxlib", "blasr_tpu"):
    sys.modules[_name] = None        # any import of them now raises ImportError
"""

SCRIPT = BLOCK + r"""
import io, json
import numpy as np
from blasr_tpu_torch.index.artifacts import build_index_from_arrays
from blasr_tpu_torch.io.batching import Read
from blasr_tpu_torch.io.seqdb import SeqDB
from blasr_tpu_torch.output.m4 import write_m4
from blasr_tpu_torch.pipeline.runner import run_mapping
from blasr_tpu_torch import bench

rng = np.random.default_rng(3)
G = 50_000
genome = rng.integers(0, 4, G).astype(np.uint8)
index = build_index_from_arrays(genome, SeqDB(["ref"], np.array([0, G]), ["0" * 32]), k=9)
params = bench.bench_params(batch_size=4, max_read_len=768, min_match_length=9)
out = {}
for fmt in ("fasta", "fastq"):
    reads = []
    for i in range(8):
        s = int(rng.integers(0, G - 800))
        r = genome[s : s + int(rng.integers(300, 700))].copy()
        r[::23] = (r[::23] + 1) % 4
        qual = rng.integers(5, 40, len(r)).astype(np.uint8) if fmt == "fastq" else None
        reads.append(Read(f"sim/{i}|ref|{s}|{s + len(r)}|0", r, qual, i))
    records, unmapped = run_mapping(index, reads, params, device="cpu")
    buf = io.StringIO()
    write_m4(records, buf)
    out[fmt] = {"lines": buf.getvalue().splitlines(), "unmapped": unmapped,
                "accuracy": bench.accuracy_true_locus(records, reads)}
# a read longer than max_read_len: mapped piecewise, stitched whole
s = 20_000
r = genome[s : s + 3000].copy()
r[15::31] = (r[15::31] + 1) % 4
long_read = Read(f"long/0|ref|{s}|{s + 3000}|0", r, None, 0)
records, unmapped = run_mapping(index, [long_read], params, device="cpu")
buf = io.StringIO()
write_m4(records, buf)
out["long"] = {"lines": buf.getvalue().splitlines(), "unmapped": unmapped,
               "accuracy": bench.accuracy_true_locus(records, [long_read])}
out["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "blasr_tpu")
                       and sys.modules[m] is not None)
print(json.dumps(out))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"   # one PyTorch CPU thread, as in the other tests
    return env


def test_port_maps_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert len(out["long"]["lines"]) == 1 and out["long"]["accuracy"] == 1.0
    assert out["long"]["lines"][0].split()[5:8] == ["0", "3000", "3000"]
    for fmt in ("fasta", "fastq"):
        assert len(out[fmt]["lines"]) == 8 and not out[fmt]["unmapped"], fmt
        assert out[fmt]["accuracy"] == 1.0
        for line in out[fmt]["lines"]:
            assert len(line.split()) == 13
    # the quality values scale the scores
    assert [ln.split()[2] for ln in out["fasta"]["lines"]] != [
        ln.split()[2] for ln in out["fastq"]["lines"]]


PARALLEL_SCRIPT = BLOCK + r"""
import io, json, os, sys, tempfile
import numpy as np
from blasr_tpu_torch.cli import tools
from blasr_tpu_torch.io.fasta import write_fasta
from blasr_tpu_torch.io.seqdb import SeqDB
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.parallel.multihost import merge_host_parts, run_mapping_host_part
from blasr_tpu_torch.parallel.sharded import run_mapping_sharded
from blasr_tpu_torch.index.artifacts import build_index_from_arrays
from blasr_tpu_torch import bench
from blasr_tpu_torch.sim import simulate_genome, simulate_reads

d = tempfile.mkdtemp()
g = simulate_genome(40_000, seed=5, repeat_fraction=0.0)
seqdb = SeqDB(["ref"], np.array([0, len(g)]), ["0" * 32])
reads, _ = simulate_reads(g, 6, mean_len=400, seed=6)
params = bench.bench_params(batch_size=4, max_read_len=768, min_match_length=11)
out = {}
recs, unm = run_mapping_sharded(g, seqdb, reads, params, n_shards=2, k=11, devices=["cpu"],
                                route=True)
out["sharded"] = [format_m4(r) for r in recs]
out["accuracy"] = bench.accuracy_true_locus(recs, reads)
index = build_index_from_arrays(g, seqdb, k=11)
for pid in range(2):
    run_mapping_host_part(index, reads, params, os.path.join(d, "p"), pid, 2, device="cpu")
out["merged_n"] = merge_host_parts(os.path.join(d, "p"), os.path.join(d, "m.m4"), 2)
out["merged"] = open(os.path.join(d, "m.m4")).read().splitlines()
write_fasta(os.path.join(d, "g.fa"), [("ref", g)])
buf = io.StringIO()
sys.stdout, stdout = buf, sys.stdout
assert tools.main(["countnmers", os.path.join(d, "g.fa"), "-wordsize", "10"]) == 0
sys.stdout = stdout
out["countnmers"] = buf.getvalue().split()
out["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "blasr_tpu")
                       and sys.modules[m] is not None)
print(json.dumps(out))
"""


def test_sharded_host_parts_and_tools_with_jax_blocked():
    """run_mapping_sharded (routed, two shards), two host parts and their
    merge, and ``tools countnmers``, with jax and blasr_tpu blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", PARALLEL_SCRIPT], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert len(out["sharded"]) == 6 and out["accuracy"] == 1.0
    assert out["merged_n"] == 6 and len(out["merged"]) == 6
    assert [ln.split()[:1] + ln.split()[5:12] for ln in out["merged"]] == [
        ln.split()[:1] + ln.split()[5:12] for ln in out["sharded"]]
    assert int(out["countnmers"][1]) == 40_000 - 10 + 1


CLI_SCRIPT = BLOCK + r"""
from blasr_tpu_torch.cli.blasr import main
argv = sys.argv[1:]
i = argv.index("--")
common, runs = argv[:i], argv[i + 1 :]
for run in runs:                       # one CLI run each: reads,out[,flags]
    reads, out, *flags = run.split(",", 2)
    extra = flags[0].split() if flags else []
    assert main([reads, *common, *extra, "-out", out]) == 0
"""

CLI_FORMATS = ("fasta", "fastq", "sam")
SIDE_FILES = ("anchors", "fullMetrics", "clusters", "lcpBounds")
# guided bands and a score matrix (transitions at -2), its 25 values
# comma-separated after '=' since the first one is negative
GUIDED_MATRIX = ("-useGuidedAlign -scoreMatrix="
                 "-5,6,-2,6,0,6,-5,6,-2,0,-2,6,-5,6,0,6,-2,6,-5,0,0,0,0,0,0")


MODE_RUNS = {"sensitive": "-useSensitiveSearch", "repeats": "-placeRepeatsRandomly",
             "expand": "-maxExpand 2", "pvaltype2": "-pvaltype 2"}


@pytest.fixture(scope="module")
def cli_outputs(tmp_path_factory):
    """The CLI of the port, in one subprocess with ``jax`` and
    ``blasr_tpu`` blocked, on the same six reads as FASTA, as FASTQ and as
    SAM with iq/sq tracks, and on the FASTA reads with guided bands and a
    score matrix: run -> the lines it wrote."""
    from blasr_tpu_torch.core.encode import codes_to_seq
    from blasr_tpu_torch.io.fasta import write_fasta
    from blasr_tpu_torch.io.fastq import write_fastq

    tmp_path = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 40_000).astype(np.uint8)
    reads = []
    for i in range(6):
        s = int(rng.integers(0, 39_000))
        r = genome[s : s + 500].copy()
        r[::29] = (r[::29] + 2) % 4
        reads.append((f"q{i}", r, rng.integers(5, 40, 500).astype(np.uint8)))
    write_fasta(str(tmp_path / "g.fa"), [("chr1", genome)])
    write_fasta(str(tmp_path / "r.fasta"), [(n, c) for n, c, _ in reads])
    write_fastq(str(tmp_path / "r.fastq"), reads)
    (tmp_path / "r.sam").write_text("".join(
        f"{n}\t4\t*\t0\t0\t*\t*\t0\t0\t{codes_to_seq(c)}\t{(q + 33).tobytes().decode()}"
        f"\tiq:Z:{(q[::-1] + 33).tobytes().decode()}\tsq:Z:{(q + 33).tobytes().decode()}\n"
        for n, c, q in reads))
    runs = [f"{tmp_path / f'r.{fmt}'},{tmp_path / f'{fmt}.m4'}" for fmt in CLI_FORMATS]
    runs.append(f"{tmp_path / 'r.fasta'},{tmp_path / 'guided_matrix.m4'},{GUIDED_MATRIX}")
    runs.append(f"{tmp_path / 'r.fasta'},{tmp_path / 'bestn2_m5.m4'},-bestn 2 -m 5")
    # SAM text with hard clips and a QV track, then SAM (soft) as BAM
    runs.append(f"{tmp_path / 'r.sam'},{tmp_path / 'sam_hard.m4'},-sam -clipping hard "
                f"-samqv InsertionQV")
    runs.append(f"{tmp_path / 'r.sam'},{tmp_path / 'sam_soft.m4'},-sam")
    runs.append(f"{tmp_path / 'r.sam'},{tmp_path / 'bam.bam'},-sam")
    # -bwt: the first run builds and saves the FM bundle, the second loads it
    for run in ("bwt_built", "bwt_loaded"):
        runs.append(f"{tmp_path / 'r.fasta'},{tmp_path / f'{run}.m4'},-bwt {tmp_path / 'g.btfm.npz'}")
    # seeds of 18 bases (wide keys) around the port's .sa file, and -nucmer (30)
    from blasr_tpu_torch.index.safile import reference_order_sa, write_sa_file

    write_sa_file(str(tmp_path / "g.sa"), reference_order_sa(genome))
    runs.append(f"{tmp_path / 'r.fasta'},{tmp_path / 'sa_k18.m4'},-minMatch 18 -sa {tmp_path / 'g.sa'}")
    runs.append(f"{tmp_path / 'r.fasta'},{tmp_path / 'nucmer.m4'},-nucmer")
    # a 6 kb contig: -alignContigs, and as a read longer than -maxReadLen
    write_fasta(str(tmp_path / "c.fasta"), [("ctg", genome[30_000:36_000])])
    runs.append(f"{tmp_path / 'c.fasta'},{tmp_path / 'contigs.m4'},-alignContigs")
    runs.append(f"{tmp_path / 'c.fasta'},{tmp_path / 'long.m4'},-maxReadLen 2048")
    # -resume (its manifest beside the output); the selectors with -nproc and
    # the four diagnostic writers
    runs.append(f"{tmp_path / 'r.fasta'},{tmp_path / 'resume.m4'},-resume")
    side = " ".join(f"-{kind} {tmp_path / ('selected.' + kind)}" for kind in SIDE_FILES)
    runs.append(f"{tmp_path / 'r.fasta'},{tmp_path / 'selected.m4'},-start 1 -stride 2 "
                f"-nproc 16 {side}")
    # the optional mapping modes, once refused by name, and -ndevices 2 (one
    # device visible on the CPU: the plain path)
    for run, flags in {**MODE_RUNS, "ndevices": "-ndevices 2"}.items():
        runs.append(f"{tmp_path / 'r.fasta'},{tmp_path / f'{run}.m4'},{flags}")
    proc = subprocess.run(
        [sys.executable, "-c", CLI_SCRIPT, str(tmp_path / "g.fa"),
         "-m", "4", "-header", "-device", "cpu", "-minMatch", "10",
         "-batchSize", "4", "--", *runs],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    from blasr_tpu_torch.io.bam import read_bam

    header, recs = read_bam(str(tmp_path / "bam.bam"))
    assert (tmp_path / "g.btfm.npz").exists()
    return {"bam": header + ["\t".join(r) for r in recs],
            "manifest": json.loads((tmp_path / "resume.m4.resume.json").read_text()),
            **{kind: (tmp_path / f"selected.{kind}").read_text().splitlines()
               for kind in SIDE_FILES},
            **{run: (tmp_path / f"{run}.m4").read_text().splitlines()
               for run in (*CLI_FORMATS, "guided_matrix", "bestn2_m5", "sam_hard", "sam_soft",
                           "bwt_built", "bwt_loaded", "sa_k18", "nucmer", "contigs", "long",
                           "resume", "selected", *MODE_RUNS, "ndevices")}}


def test_cli_writes_m4_with_jax_blocked(cli_outputs):
    _check_cli_lines(cli_outputs["fasta"])


@pytest.mark.parametrize("fmt", ["fastq", "sam"])
def test_cli_maps_quality_reads_with_blasr_tpu_blocked(cli_outputs, fmt):
    _check_cli_lines(cli_outputs[fmt])
    # the quality values scale the scores: not the FASTA result
    assert cli_outputs[fmt] != cli_outputs["fasta"]


def test_cli_maps_guided_with_a_matrix_with_blasr_tpu_blocked(cli_outputs):
    _check_cli_lines(cli_outputs["guided_matrix"])
    # the matrix scores the same alignments otherwise
    assert cli_outputs["guided_matrix"] != cli_outputs["fasta"]


def test_cli_maps_bwt_with_jax_blocked(cli_outputs):
    """-bwt: FM anchors find the suffix array's alignments on these reads;
    the loaded bundle maps as the one just built."""
    _check_cli_lines(cli_outputs["bwt_built"])
    assert cli_outputs["bwt_built"] == cli_outputs["bwt_loaded"] == cli_outputs["fasta"]


@pytest.mark.parametrize("run", ["sa_k18", "nucmer"])
def test_cli_maps_long_seeds_with_jax_blocked(cli_outputs, run):
    """-minMatch 18 with a reference-format .sa (wide keys) and -nucmer
    (30-base seeds, maxScore -200): the reads' alignments, on the spans
    the k = 10 run reports."""
    _check_cli_lines(cli_outputs[run])
    spans = [ln.split()[5:12] for ln in cli_outputs["fasta"][1:]]
    assert [ln.split()[5:12] for ln in cli_outputs[run][1:]] == spans


@pytest.mark.parametrize("run", ["contigs", "long"])
def test_cli_maps_long_queries_with_jax_blocked(cli_outputs, run):
    """-alignContigs, and a query longer than -maxReadLen: the 6 kb contig's
    segments stitch into one whole record at its locus."""
    lines = cli_outputs[run]
    assert lines[0].startswith("qname tname score") and len(lines) == 2
    f = lines[1].split()
    assert f[0] == "ctg/0_6000" and f[5:12] == ["0", "6000", "6000", "0", "30000", "36000",
                                                "40000"]


def test_cli_resumes_and_selects_with_jax_blocked(cli_outputs):
    """-resume writes the plain run's lines, its manifest recording every
    batch written and no read held back; -start 1 -stride 2 with -nproc 16
    maps q1, q3 and q5 and writes the four side files for them."""
    assert sorted(cli_outputs["resume"]) == sorted(cli_outputs["fasta"])
    assert cli_outputs["manifest"]["batches_done"] == 2
    assert cli_outputs["manifest"]["deferred"] == {}
    selected = {"q1", "q3", "q5"}
    assert {ln.split()[0].split("/")[0] for ln in cli_outputs["selected"][1:]} == selected
    assert {ln.split()[0] for ln in cli_outputs["anchors"]} == selected
    assert [ln.split()[:3] for ln in cli_outputs["fullMetrics"][2:]] == [
        [q, "500", "1"] for q in ("q1", "q3", "q5")]
    assert len(cli_outputs["clusters"]) == 4 and len(cli_outputs["lcpBounds"]) == 6


def test_cli_writes_bestn2_m5_with_jax_blocked(cli_outputs):
    """-bestn 2 -m 5: each read's best alignment as the -m 4 run reports it,
    with its alignment strings (19 fields, no header line)."""
    lines = cli_outputs["bestn2_m5"]
    assert len(lines) >= 6
    best = {}
    for ln in lines:
        f = ln.split()
        assert len(f) == 19 and f[4] == "+" and f[9] in "+-"
        assert len(f[16]) == len(f[17]) == len(f[18]) > 400
        best.setdefault(f[0], f)                 # a read's first line is its best
    assert set(best) == {f"q{i}" for i in range(6)}
    for m4 in cli_outputs["fasta"][1:]:
        g = m4.split()
        f = best[g[0].split("/")[0]]
        # score, query span and strand as -m 4 prints them
        assert (f[10], f[2], f[3], f[9]) == (g[2], g[5], g[6], "+-"[int(g[8])])


def test_cli_writes_sam_and_bam_with_jax_blocked(cli_outputs):
    """-sam -clipping hard -samqv InsertionQV: a header, then one line a
    read with H clips, = and X runs and the iq track; -sam to a .bam reads
    back as the soft-clipped SAM text."""
    lines = cli_outputs["sam_hard"]
    header = [ln for ln in lines if ln.startswith("@")]
    body = [ln.split("\t") for ln in lines if not ln.startswith("@")]
    assert header[0].startswith("@HD") and header[-1].startswith("@PG")
    assert "@SQ\tSN:chr1\tLN:40000" in "\n".join(header)
    assert sorted(f[0] for f in body) == [f"q{i}/0_500" for i in range(6)]
    for f in body:
        assert f[1] in ("0", "16") and "H" not in f[5].strip("0123456789H")
        assert "=" in f[5] and len(f[9]) == len(f[10]) < 500
        assert any(t.startswith("iq:Z:") for t in f[11:])
        assert not any(t.startswith("sq:Z:") for t in f[11:])
    assert cli_outputs["bam"] == cli_outputs["sam_soft"]
    assert cli_outputs["bam"] != lines


def _check_cli_lines(lines):
    assert lines[0].startswith("qname tname score")
    assert len(lines) == 7
    assert {ln.split()[0] for ln in lines[1:]} == {f"q{i}/0_500" for i in range(6)}


def test_cli_names_unsupported_options(cli_outputs):
    """No option is refused any more: -ndevices 2 writes the plain run's
    lines (one device is visible on the CPU); -useSensitiveSearch,
    -placeRepeatsRandomly, -maxExpand 2 and -pvaltype 2 map every read
    with jax blocked, on the spans the plain run reports (these clean reads
    give the passes nothing to change)."""
    assert cli_outputs["ndevices"] == cli_outputs["fasta"]
    spans = [ln.split()[5:12] for ln in cli_outputs["fasta"][1:]]
    for run in MODE_RUNS:
        _check_cli_lines(cli_outputs[run])
        assert [ln.split()[5:12] for ln in cli_outputs[run][1:]] == spans, run


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "tools", n) for n in os.listdir(os.path.join(REPO, "tools"))
              if n.startswith("torch_") and n.endswith(".py")]
    for root, _, names in os.walk(os.path.join(REPO, "blasr_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for module in ("pipeline/debug.py", "pipeline/diagnostics.py", "cli/blasr.py",
                   "parallel/mesh.py", "parallel/sharded.py", "parallel/multihost.py",
                   "cli/tools.py", "cli/sawriter.py", "cli/bwtutils.py"):
        assert os.path.join(REPO, "blasr_tpu_torch", module) in files
    assert os.path.join(REPO, "tools", "torch_sharded_smoke.py") in files
    return files


def test_no_port_file_imports_jax_or_blasr_tpu():
    """Outside string literals and comments, no file of the port names the
    ``blasr_tpu`` or ``jax`` packages; no string is such a module path (an
    ``importlib`` target). Docstrings may name the reference's file:line."""
    module_path = re.compile(r"^(blasr_tpu|jax|jaxlib)(\.\w+)*$")
    files = _port_files()
    assert len(files) > 20
    for path in files:
        with open(path, "rb") as f:
            toks = list(tokenize.tokenize(f.readline))
        for tok in toks:
            if tok.type == tokenize.NAME:
                assert tok.string not in ("blasr_tpu", "jax", "jaxlib"), (path, tok.start)
            elif tok.type == tokenize.STRING:
                body = tok.string.strip("rbuRBU").strip("\"'")
                assert not module_path.match(body), (path, tok.start)
        text = open(path).read()
        for line in io.StringIO(text):
            code = line.split("#", 1)[0]
            assert not re.match(r"\s*(from|import)\s+(blasr_tpu|jax)\b(?!_)", code), (path, line)
