"""The port's BAM container and its SAM/BAM command line against the JAX
package's, exact (tolerance 0: bytes, strings and integers).

  * ``write_bam_from_sam_lines`` writes the JAX package's bytes, and
    ``read_bam`` reads them back as the JAX package reads them: a round
    trip of typed tags, an unmapped record and a payload that spills past
    one 64 KiB BGZF block;
  * a ``.bam`` read file through ``read_records``;
  * the CLI's ``-sam`` (every clip mode, ``-samqv``), ``-out x.bam``,
    ``-unaligned`` (with and without ``-noPrintUnalignedSeqs``) and
    ``-titleTable`` against ``blasr_tpu.cli.blasr.main`` on the same files.
"""

import numpy as np
import pytest
import torch

from blasr_tpu.cli import blasr as jcli
from blasr_tpu.io import bam as jbam
from blasr_tpu.io import batching as jbat
from blasr_tpu_torch.cli import blasr as tcli
from blasr_tpu_torch.core.encode import codes_to_seq, revcomp_codes
from blasr_tpu_torch.io import bam as tbam
from blasr_tpu_torch.io import batching as tbat
from blasr_tpu_torch.io.fasta import write_fasta

torch.set_num_threads(1)

HEADER = [
    "@HD\tVN:1.5\tpb:3.0.1",
    "@SQ\tSN:chr1\tLN:5000\tM5:0",
    "@SQ\tSN:chr2\tLN:3000\tM5:1",
    "@PG\tID:blasr_tpu\tPN:blasr_tpu\tVN:2.0\tCL:test",
]
RECORDS = [
    "r1/0_102\t0\tchr1\t101\t60\t10S40=2I28X2=5D20=\t*\t0\t96\t"
    + "ACGT" * 25 + "AN\t" + "I" * 102
    + "\tRG:Z:abc\tAS:i:-371\tXS:i:1\tzm:i:-1\trq:f:0\tsn:B:f,0,0,0,0\tiq:Z:" + "#" * 102,
    "r2/0_50\t272\tchr2\t7\t254\t3H47=\t*\t0\t47\t" + "GATTACA" * 6 + "GATTA\t*"
    + "\tNM:i:3\tXT:i:1\tst:Z:" + "A" * 47,
    "u1\t4\t*\t0\t0\t*\t*\t0\t0\tACGTACGTN\t" + "+" * 9 + "\tRG:Z:abc",
]


def _write_both(tmp_path, header, records, name):
    jp, tp = str(tmp_path / f"j_{name}.bam"), str(tmp_path / f"t_{name}.bam")
    assert tbam.write_bam_from_sam_lines(header, records, tp) == (
        jbam.write_bam_from_sam_lines(header, records, jp)) == len(records)
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert g.read() == f.read()
    return tp


def test_bam_bytes_and_round_trip_equal_jax(tmp_path):
    p = _write_both(tmp_path, HEADER, RECORDS, "small")
    assert open(p, "rb").read().endswith(tbam.BGZF_EOF)
    header, recs = tbam.read_bam(p)
    assert (header, recs) == jbam.read_bam(p)
    assert header == HEADER
    assert ["\t".join(r) for r in recs] == RECORDS


def test_bam_block_spill_equals_jax(tmp_path):
    """More than 64 KiB of records: several BGZF members, read back whole."""
    rng = np.random.default_rng(4)
    recs = []
    for i in range(900):
        seq = codes_to_seq(rng.integers(0, 4, 120).astype(np.uint8))
        qual = (rng.integers(0, 60, 120).astype(np.uint8) + 33).tobytes().decode()
        recs.append(f"q{i}/0_120\t{16 * (i % 2)}\tchr{1 + i % 2}\t{1 + i}\t{i % 255}\t"
                    f"120=\t*\t0\t120\t{seq}\t{qual}\tAS:i:{-i}\tRG:Z:x")
    p = _write_both(tmp_path, HEADER, recs, "big")
    raw = open(p, "rb").read()
    assert len(tbam.bgzf_decompress(p)) > 65536 and raw.count(b"BC\x02\x00") >= 3
    header, got = tbam.read_bam(p)
    assert (header, got) == jbam.read_bam(p)
    assert ["\t".join(r) for r in got] == recs


def test_bam_reads_equal_jax(tmp_path):
    """A BAM read file through read_records: orientation restored from
    FLAG 16, the secondary skipped, QV tracks kept."""
    p = _write_both(tmp_path, HEADER, RECORDS, "reads")
    jr, tr = jbat.read_records(p), tbat.read_records(p)
    assert [r.name for r in tr] == [r.name for r in jr] == ["r1", "u1"]
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.qual, b.qual)
        assert (a.qvs or {}).keys() == (b.qvs or {}).keys()


# ---- the command line ----

def _reads(rng, genome, n_mapped):
    out = []
    for i in range(n_mapped):
        s = int(rng.integers(0, len(genome) - 700))
        r = genome[s : s + int(rng.integers(350, 600))].copy()
        r[::23] = (r[::23] + 1) % 4
        if i % 2:
            r = revcomp_codes(r)
        out.append((f"m1/{10 + i}/0_{len(r)}" if i % 3 == 0 else f"q{i}", r))
    for i in range(2):                           # random reads: left unmapped
        out.append((f"junk{i}", rng.integers(0, 4, 400).astype(np.uint8)))
    out.append(("q1", out[1][1].copy()))         # a second read named q1
    return out


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sam_cli")
    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, 30_000).astype(np.uint8)
    write_fasta(str(tmp / "g.fa"), [("chrA", genome[:18_000]), ("chrB", genome[18_000:])])
    reads = _reads(rng, genome, 8)
    with open(tmp / "r.fastq", "w") as f:
        for name, c in reads:
            q = rng.integers(5, 40, len(c)).astype(np.uint8)
            f.write(f"@{name}\n{codes_to_seq(c)}\n+\n{(q + 33).tobytes().decode()}\n")
    with open(tmp / "r.sam", "w") as f:
        f.write("@HD\tVN:1.5\n")
        for name, c in reads:
            q = rng.integers(5, 40, len(c)).astype(np.uint8)
            iq = (q * 3 % 90).astype(np.uint8)
            f.write("\t".join([name, "4", "*", "0", "0", "*", "*", "0", "0", codes_to_seq(c),
                               (q + 33).tobytes().decode(), f"iq:Z:{(iq + 33).tobytes().decode()}",
                               f"sq:Z:{(q + 33).tobytes().decode()}"]) + "\n")
    return tmp


COMMON = ["-minMatch", "10", "-batchSize", "4", "-maxReadLen", "1024"]
CLI_CASES = {
    "sam_soft": ("r.fastq", ["-sam"]),
    "sam_hard_samqv": ("r.sam", ["-sam", "-clipping", "hard", "-samqv", "InsertionQV",
                                 "SubstitutionQV"]),
    "sam_none": ("r.sam", ["-sam", "-clipping", "none"]),
    "sam_subread_bestn2": ("r.fastq", ["-sam", "-clipping", "subread", "-bestn", "2"]),
    "bam": ("r.fastq", ["-sam"]),
    "unaligned": ("r.fastq", ["-m", "4", "-unaligned", "{tmp}/{pkg}_unal.fa"]),
    "unaligned_names": ("r.fastq", ["-sam", "-unaligned", "{tmp}/{pkg}_unal.txt",
                                    "-noPrintUnalignedSeqs"]),
    "title_table": ("r.fastq", ["-sam", "-titleTable", "{tmp}/{pkg}_titles.txt"]),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_sam_bam_equals_jax(cli_files, case):
    reads, flags = CLI_CASES[case]
    tmp = cli_files
    outs = {}
    for pkg, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["-device", "cpu"])):
        out = str(tmp / f"{pkg}_{case}.{'bam' if case == 'bam' else 'out'}")
        argv = [str(tmp / reads), str(tmp / "g.fa"), *COMMON, *extra, "-out", out,
                *(f.format(tmp=tmp, pkg=pkg) for f in flags)]
        assert main(argv) == 0
        side = [f.format(tmp=tmp, pkg=pkg) for f in flags if "{tmp}" in f]
        outs[pkg] = [open(p, "rb").read() for p in [out, *side]]
    assert outs["port"] == outs["jax"]
    text = outs["port"][0]
    if case == "bam":
        header, recs = tbam.read_bam(str(tmp / "port_bam.bam"))
        soft = (tmp / "port_sam_soft.out").read_text().splitlines()
        assert header + ["\t".join(r) for r in recs] == soft
        return
    lines = text.decode().splitlines()
    if "-sam" in flags:
        body = [ln for ln in lines if not ln.startswith("@")]
        assert sum(ln.split("\t")[1] == "4" for ln in body) == 2      # the random reads
    if reads == "r.fastq" and "-sam" in flags:
        assert sum(ln.startswith("q1/") for ln in body) == 2          # both reads named q1
    if case == "sam_hard_samqv":
        assert all("\tiq:Z:" in ln and "\tsq:Z:" in ln for ln in body if "\tAS:i:" in ln)
    if case == "unaligned":
        assert outs["port"][1].decode().splitlines()[::2] == [">junk0", ">junk1"]
    if case == "unaligned_names":
        assert outs["port"][1].decode().splitlines() == ["junk0", "junk1"]
    if case == "title_table":
        assert outs["port"][1].decode().splitlines() == ["chrA", "chrB"]
        assert "@SQ\tSN:0\tLN:18000\t" in text.decode()


def test_bam_path_without_sam_writes_m4_text(cli_files):
    """-out x.bam without -sam writes -m 4 text to that path, as the JAX
    command line does."""
    tmp = cli_files
    for pkg, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["-device", "cpu"])):
        assert main([str(tmp / "r.fastq"), str(tmp / "g.fa"), *COMMON, *extra,
                     "-out", str(tmp / f"{pkg}_m4.bam")]) == 0
    assert (tmp / "port_m4.bam").read_text() == (tmp / "jax_m4.bam").read_text()
    assert not (tmp / "port_m4.bam").read_bytes().startswith(b"\x1f\x8b")
