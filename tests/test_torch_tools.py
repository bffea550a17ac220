"""The port's host tools against the JAX package's: ``tools`` (every
subcommand of ``COMMANDS``), ``sawriter`` and ``bwtutils``.

Each case runs both packages' ``main(argv)`` on its own copy of the same
input files: the standard output (with the copy's path read as one) and
every file in the copy afterwards must be equal, written ``.npz`` bundles
array for array (their zip entries carry times). ``tools dotplot``
searches anchors on ``-device cpu`` here; its lines are compared after
``pipeline/debug.canonical_anchor_lines``, since the JAX dump orders a
read position's hits with numpy's unstable sort."""

import os
import shutil

import numpy as np
import pytest
import torch

from blasr_tpu.cli import bwtutils as jbwtutils
from blasr_tpu.cli import sawriter as jsawriter
from blasr_tpu.cli import tools as jtools
from blasr_tpu.core.encode import codes_to_seq, revcomp_codes
from blasr_tpu.index.safile import reference_order_sa, write_sa_file
from blasr_tpu.io.fasta import write_fasta
from blasr_tpu.io.seqdb import load_genome
from blasr_tpu.sim import shred_genome, simulate_genome
from blasr_tpu_torch.cli import bwtutils as tbwtutils
from blasr_tpu_torch.cli import sawriter as tsawriter
from blasr_tpu_torch.cli import tools as ttools
from blasr_tpu_torch.pipeline.debug import canonical_anchor_lines

torch.set_num_threads(1)


def _sam_records(g: np.ndarray) -> list[str]:
    """Alignments on contig c1 of ``g``: split and fragmented deletions, an
    insertion, clips, the reverse strand, quality values and an unmapped
    read."""
    rng = np.random.default_rng(2)
    ins = simulate_genome(120, seed=32)
    recs = [
        ("r1", 0, 101, 254, "300M150D150M120I150M",
         np.concatenate([g[100:400], g[550:700], ins, g[700:850]])),
        ("r2", 0, 1001, 60, "300M90D3M107D297M",
         np.concatenate([g[1000:1300], g[1390:1393], g[1500:1797]])),
        ("r3", 0, 3001, 30, "200M80D5M80D200M",
         np.concatenate([g[3000:3200], g[3280:3285], g[3365:3565]])),
        ("r5", 0, 5001, 254, "12S400M",
         np.concatenate([rng.integers(0, 4, 12).astype(np.uint8), g[5000:5400]])),
    ]
    m = g[6000:6500].copy()
    m[::37] = (m[::37] + 1) % 4
    lines = []
    for name, flag, pos, mapq, cigar, codes in recs:
        qual = (rng.integers(5, 40, len(codes)) + 33).astype(np.uint8).tobytes().decode()
        lines.append(f"{name}\t{flag}\tc1\t{pos}\t{mapq}\t{cigar}\t*\t0\t0\t"
                     f"{codes_to_seq(codes)}\t{qual}\tNM:i:3")
    lines.append(f"r6\t16\tc1\t6001\t10\t500M\t*\t0\t0\t{codes_to_seq(m)}\t*\tNM:i:14")
    lines.append(f"r7\t4\t*\t0\t0\t*\t*\t0\t0\t{codes_to_seq(g[9000:9100])}\t*")
    return lines


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools_in")
    g = simulate_genome(30_000, seed=1)
    g[2000:2180] = g[12_500:12_680]                     # a planted repeat
    write_fasta(str(d / "g.fa"), [("c1", g[:20_000]), ("c2", g[20_000:])])
    genome, seqdb = load_genome(str(d / "g.fa"))
    reads = shred_genome(genome, seqdb, 300, coverage=1.0)[::20]
    noisy = []
    for i, (n, c) in enumerate(reads[:6]):
        c = c.copy()
        c[::13] = (c[::13] + 1) % 4
        noisy.append((n, c if i % 2 else revcomp_codes(c)))
    write_fasta(str(d / "reads.fa"), noisy)
    write_fasta(str(d / "two.fa"), noisy[:2])
    sam = ["@HD\tVN:1.5", "@SQ\tSN:c1\tLN:20000", "@SQ\tSN:c2\tLN:10000"] + _sam_records(g)
    (d / "aln.sam").write_text("\n".join(sam) + "\n")
    (d / "mask.txt").write_text("c1 100 150\nc2 300 310\nc1 5000 5100\n")
    write_sa_file(str(d / "g.sa"), reference_order_sa(genome), genome)
    write_fasta(str(d / "probes.fa"), [("p1", g[700:730]), ("p2", g[2000:2020]),
                                       ("p3", g[25_000:25_016])])
    # one-gap: a query across a 400-base deletion of the target
    write_fasta(str(d / "og_q.fa"), [("q", np.concatenate([g[0:300], g[700:1000]]))])
    write_fasta(str(d / "og_t.fa"), [("t", g[0:1000])])
    rng = np.random.default_rng(8)
    adapter = rng.integers(0, 4, 45).astype(np.uint8)
    insert = rng.integers(0, 4, 400).astype(np.uint8)
    write_fasta(str(d / "ad.fa"), [("adapter", adapter)])
    write_fasta(str(d / "zmw.fa"), [("zmw", np.concatenate([insert, adapter,
                                                             revcomp_codes(insert)])),
                                    ("plain", insert)])
    write_fasta(str(d / "hp.fa"), [("h", np.repeat(g[:200], 1 + np.arange(200) % 3))])
    os.makedirs(d / "gffdir")
    write_fasta(str(d / "gffdir" / "c1.fa"), [("c1", g[:20_000])])
    (d / "d.gff").write_text("c1 dup 99.1 10 60\nc1 dup 88.0 100 140\n")
    (d / "a.gtf").write_text(
        'c1\tHAVANA\texon\t100\t200\t.\t+\t.\tgene_id "G1"; gene_name "FAM"; '
        'transcript_id "T1";\n'
        'c1\tHAVANA\texon\t500\t600\t.\t+\t.\tgene_id "G2"; gene_name "BAR"; '
        'transcript_id "T2";\n')
    (d / "a.m4").write_text(
        "r1 c1 -100 95.0 0 0 100 100 0 110 190 20000 254\n"
        "r2 c1 -100 95.0 1 0 100 100 1 19395 19495 20000 254\n"
        "r3 c1 -100 95.0 0 0 100 100 0 800 900 20000 254\n")
    (d / "a.gff3").write_text("c1\tblasr\tmatch\t120\t180\t.\t+\t.\tID=x1\n"
                              "c1\tblasr\tmatch\t900\t950\t.\t-\t.\tID=x2\n")
    return d


# (case, argv with {i} for the input copy; the package's main is picked by
# the first word). Every subcommand of tools.COMMANDS has a case.
CASES = [
    ("samtom4", "tools samtom4 {i}/aln.sam -header"),
    ("onegap", "tools onegap {i}/og_q.fa {i}/og_t.fa -indel 4"),
    ("masksequence", "tools masksequence {i}/g.fa {i}/mask.txt {i}/masked.fa"),
    ("masksequence-reverse", "tools masksequence {i}/g.fa {i}/mask.txt {i}/kept.fa -reverse"),
    ("exciserepeats", "tools exciserepeats {i}/g.fa {i}/mask.txt {i}/excised.fa"),
    ("extractseq", "tools extractseq {i}/g.fa c2:10-200"),
    ("revcomp", "tools revcomp {i}/reads.fa -out {i}/rc.fa"),
    ("countnmers", "tools countnmers {i}/g.fa -wordsize 10"),
    ("longestrepeat", "tools longestrepeat {i}/g.fa"),
    ("removeadapters", "tools removeadapters -ad1 {i}/ad.fa -reads {i}/zmw.fa "
                       "-readsout {i}/passes.fa -pctSim 0.8"),
    ("saquery", "tools saquery {i}/g.fa {i}/g.sa {i}/probes.fa -print -printCount -max 3"),
    ("saquery-count", "tools saquery {i}/g.fa {i}/g.sa {i}/probes.fa -count"),
    ("saprint", "tools saprint {i}/g.sa -ps {i}/g.fa -limit 12"),
    ("svrealign", "tools svrealign {i}/g.fa {i}/aln.sam -out {i}/re.sam"),
    ("samcoverage", "tools samcoverage -sam {i}/aln.sam -outDir {i}/cov -bin 20"),
    ("samcoverage-text", "tools samcoverage -sam {i}/aln.sam -outDir {i}/covt -text -unique"),
    ("samconsensus", "tools samconsensus -sam {i}/aln.sam -outDir {i}/cons -bin 10 -text"),
    ("maxalignedread", "tools maxalignedread -sam {i}/aln.sam -outDir {i}/mar -bin 10 -q 20"),
    ("printgaps", "tools printgaps {i}/g.fa {i}/aln.sam -out {i}/gaps.txt -minGapLength 100 "
                  "-merge 10 -printGapFasta {i}/gaps.fa"),
    ("samtom0", "tools samtom0 {i}/aln.sam {i}/g.fa"),
    ("samfilter", "tools samfilter {i}/aln.sam -minPctIdentity 90 -minMapQV 20"),
    ("ctab", "tools ctab {i}/g.fa -wordsize 4 -minCount 2"),
    ("shredder", "tools shredder {i}/g.fa -out {i}/shred.fa -readLength 700 -coverage 2 "
                 "-seed 5"),
    ("evolve", "tools evolve {i}/g.fa -out {i}/evolved.fa -sub 0.02 -seed 3"),
    ("wordcount", "tools wordcount {i}/g.fa -wordsize 6 -top 7"),
    ("exhalign", "tools exhalign {i}/two.fa {i}/g.fa -tstart 100 -tend 800"),
    ("alchemy", "tools alchemy {i}/g.fa -nReads 4 -seed 3 -fastq -out {i}/alc.fq"),
    ("buildErrorModel", "tools buildErrorModel {i}/aln.sam -out {i}/model.json"),
    ("condense", "tools condense {i}/hp.fa"),
    ("dotplot", "tools dotplot {i}/two.fa {i}/g.fa -minMatch 12 -out {i}/dots.txt"),
    ("extractGFFSequences", "tools extractGFFSequences {i}/d.gff {i}/gffdir"),
    ("matchGTFExons", "tools matchGTFExons {i}/a.m4 {i}/a.gtf -format m4"),
    ("matchGTFExons-gff3", "tools matchGTFExons {i}/a.gff3 {i}/a.gtf"),
    ("sawriter", "sawriter {i}/g.fa {i}/idx.btidx.npz -k 10 -safile -salut 4"),
    ("sa2bwt", "bwtutils sa2bwt {i}/g.fa {i}/g.btfm.npz"),
    ("bwtquery", "bwtutils sa2bwt {i}/g.fa {i}/g.btfm.npz ; "
                 "bwtutils bwtquery {i}/g.btfm.npz ACGTAC -max 5"),
    ("bwtinfo", "bwtutils sa2bwt {i}/g.fa {i}/g.btfm.npz ; bwtutils bwtinfo {i}/g.btfm.npz"),
    ("bwt2sa", "bwtutils sa2bwt {i}/g.fa {i}/g.btfm.npz ; "
               "bwtutils bwt2sa {i}/g.btfm.npz {i}/back.sa"),
    ("locatelist", "bwtutils sa2bwt {i}/g.fa {i}/g.btfm.npz ; "
                   "bwtutils locatelist {i}/g.btfm.npz {i}/probes.fa -max 4 -print"),
]

MAINS = {"jax": {"tools": jtools.main, "sawriter": jsawriter.main, "bwtutils": jbwtutils.main},
         "port": {"tools": ttools.main, "sawriter": tsawriter.main,
                  "bwtutils": tbwtutils.main}}


def _run(pkg, cmd, inp, out_root, capsys):
    """Run ``cmd`` (commands split by ';') with ``pkg``'s mains on a copy of
    the inputs; returns (stdout with the copy's path as {i}, the copy)."""
    d = out_root / pkg
    shutil.copytree(inp, d)
    text = []
    for one in cmd.split(" ; "):
        prog, *argv = one.format(i=d).split()
        if pkg == "port" and argv[0] == "dotplot":
            argv += ["-device", "cpu"]
        assert MAINS[pkg][prog](argv) == 0, one
        text.append(capsys.readouterr().out.replace(str(d), "{i}"))
    return "".join(text), d


def _same_file(a: str, b: str) -> bool:
    if a.endswith(".npz"):
        za, zb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
        return sorted(za.files) == sorted(zb.files) and all(
            np.array_equal(za[k], zb[k]) for k in za.files)
    return open(a, "rb").read() == open(b, "rb").read()


def test_every_tools_command_has_a_case():
    names = {c[1].split()[1] for c in CASES if c[1].startswith("tools ")}
    assert names == set(jtools.COMMANDS) == set(ttools.COMMANDS)
    assert {c[1].split(" ; ")[-1].split()[1] for c in CASES
            if c[1].startswith("bwtutils")} == set(jbwtutils.COMMANDS) == set(tbwtutils.COMMANDS)


@pytest.mark.parametrize("case,cmd", CASES, ids=[c[0] for c in CASES])
def test_tool_output_equals_jax(inputs, tmp_path, capsys, case, cmd):
    jout, jdir = _run("jax", cmd, inputs, tmp_path, capsys)
    tout, tdir = _run("port", cmd, inputs, tmp_path, capsys)
    files = sorted(os.path.relpath(os.path.join(r, n), jdir)
                   for r, _, ns in os.walk(jdir) for n in ns)
    assert files == sorted(os.path.relpath(os.path.join(r, n), tdir)
                           for r, _, ns in os.walk(tdir) for n in ns)
    if case == "dotplot":
        got = (tdir / "dots.txt").read_text().splitlines()
        want = (jdir / "dots.txt").read_text().splitlines()
        assert got == want[:1] + canonical_anchor_lines(want[1:])      # after the header
        assert len(got) > 50
        files.remove("dots.txt")
    for f in files:
        assert _same_file(str(jdir / f), str(tdir / f)), f
    assert tout == jout
    assert tout or len(files) > len(os.listdir(inputs)), case   # each case writes something
