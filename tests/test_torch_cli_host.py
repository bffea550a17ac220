"""The port's CLI host surface against the JAX CLI on the CPU: the read
selectors, the compatibility flags, ``run_mapping``'s batch stream and
``-resume``.

Both CLIs run in this process (the port with ``-device cpu``) on a 60 kb
genome with 24 simulated reads of 120-235 bases (one batch shape, to keep
the plain DP's time down), and on the burst corpus of
``tests/test_resume.py`` (14 reads of 800 bases and two of 1350 with a
150-base insertion, which band escalation re-maps). Each selector's -m 4
file equals the JAX CLI's byte for byte; under a selector the port's SAM
puts every record under its own read, as the JAX CLI does on a file of
the selected reads alone. Every compatibility flag parses to the same
parameters, and a run with all of them prints the run without them.
A resumed run ends with the lines of the JAX CLI's uninterrupted run
(sorted): after a kill right after a manifest update, after one between a
flush and the manifest's update (the JAX CLI appends that batch again),
and, on the burst corpus, after one before the last update, while the
held-back reads' resolved records are being written. ``-resume -sam``
writes the plain run's unmapped lines too. Tolerance 0 everywhere."""

import io
import json
import os

import numpy as np
import pytest
import torch

from blasr_tpu.cli.blasr import main as jax_main
from blasr_tpu.io.batching import Read as JRead
from blasr_tpu.io.batching import read_records as jread_records
from blasr_tpu.io.fasta import write_fasta
from blasr_tpu.output.m4 import format_m4 as jformat_m4
from blasr_tpu.pipeline.runner import run_mapping as jrun_mapping
from blasr_tpu.index.artifacts import load_index as jload_index
from blasr_tpu.sim import simulate_genome, simulate_reads
from blasr_tpu_torch.cli import blasr as tcli
from blasr_tpu_torch.index.artifacts import load_index
from blasr_tpu_torch.io.batching import batch_reads, read_records
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.pipeline.runner import run_mapping

torch.set_num_threads(1)

# batches of 8: three for the 24 reads (-resume), fewer for a selection (the
# plain DP's time grows with the batch)
FLAGS = ["-m", "4", "-batchSize", "8", "-maxReadLen", "256", "-minMatch", "13"]
BURST_FLAGS = ["-m", "4", "-batchSize", "8", "-maxReadLen", "1536", "-minMatch", "13",
               "-bandSize", "16", "-nCandidates", "2"]
# command A's selector set (chip_smoke.CLI_HOST_SELECTORS) runs with the
# side files in tests/test_torch_diagnostics.py
SELECTORS = {
    "start": ["-start", "3"],
    "stride": ["-stride", "3"],
    "subsample": ["-subsample", "0.6", "-randomSeed", "5"],
    "maxReadLength": ["-maxReadLength", "180"],
    "maxReadIndex": ["-maxReadIndex", "9"],
    "readIndex": ["-readIndex", "4"],
    "readIndices": ["-readIndices", "1,5,7,20"],
}
COMMAND_A_SELECTORS = ["-start", "3", "-stride", "2", "-subsample", "0.8", "-randomSeed", "7"]


class Killed(Exception):
    """A kill of the process, raised from inside the resumable writer."""


def _lines(path) -> list:
    with open(path) as f:
        return f.read().splitlines()


def _port(argv) -> None:
    assert tcli.main([*argv, "-device", "cpu"]) == 0


def _jax(argv) -> None:
    assert jax_main(argv) == 0


def _short_reads(g, n, seed):
    """(name, codes) of n reads of 120-235 bases drawn from the genome, every
    other one reverse complemented, with a substitution every 19 bases and
    a one-base deletion: all map, in one bucket (256)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        n_i = 120 + 5 * i
        s = int(rng.integers(0, len(g) - n_i - 1))
        r = np.delete(g[s : s + n_i + 1].copy(), n_i // 2)
        r[7::19] = (r[7::19] + 1) % 4
        if i % 2:
            r = (3 - r)[::-1].copy()
        out.append((f"sim/{i}|ref|{s}|{s + n_i + 1}|{i % 2}", r))
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_host")
    g = simulate_genome(60_000, seed=51, repeat_fraction=0.0)
    write_fasta(str(d / "g.fa"), [("ref", g)])
    write_fasta(str(d / "r.fa"), _short_reads(g, 24, seed=52))
    _jax([str(d / "r.fa"), str(d / "g.fa"), *FLAGS, "-out", str(d / "plain.m4")])
    return {"dir": d, "reads": str(d / "r.fa"), "genome": str(d / "g.fa"),
            "plain": _lines(d / "plain.m4")}


@pytest.mark.parametrize("name", list(SELECTORS))
def test_selector_output_equals_jax(corpus, name):
    d = corpus["dir"]
    common = [corpus["reads"], corpus["genome"], *FLAGS, *SELECTORS[name]]
    _jax([*common, "-out", str(d / f"j_{name}.m4")])
    _port([*common, "-out", str(d / f"t_{name}.m4")])
    jl, tl = _lines(d / f"j_{name}.m4"), _lines(d / f"t_{name}.m4")
    assert tl == jl
    assert 0 < len(tl) < len(corpus["plain"])


def test_sam_under_a_selector_keeps_each_record_on_its_read(corpus):
    """The JAX CLI's -sam takes a record's stream index for a position in
    the selected list, so under -start 3 -stride 2 its lines carry other
    reads' SEQ. The port's lines equal the JAX CLI's on a file holding the
    selected reads alone, under the same basename (the @RG id)."""
    d = corpus["dir"]
    flags = [*FLAGS, "-sam", "-clipping", "none"]
    sel = ["-start", "3", "-stride", "2"]
    _port([corpus["reads"], corpus["genome"], *flags, *sel, "-out", str(d / "t_sel.sam")])
    _jax([corpus["reads"], corpus["genome"], *flags, *sel, "-out", str(d / "j_sel.sam")])
    own = d / "selected"
    own.mkdir()
    write_fasta(str(own / "r.fa"), [(r.name, r.codes) for r in
                                    jread_records(corpus["reads"])[3::2]])
    _jax([str(own / "r.fa"), corpus["genome"], *flags, "-out", str(d / "j_own.sam")])
    port, jax_own = _lines(d / "t_sel.sam"), _lines(d / "j_own.sam")
    assert port == jax_own
    body = [ln.split("\t") for ln in port if not ln.startswith("@")]
    seq = {r.name: r for r in read_records(corpus["reads"])}
    from blasr_tpu_torch.core.encode import codes_to_seq, revcomp_codes

    for f in body:
        rd = seq[f[0].rpartition("/")[0]]
        codes = revcomp_codes(rd.codes) if int(f[1]) & 16 else rd.codes
        assert f[9] == codes_to_seq(codes)
    assert _lines(d / "j_sel.sam") != port   # the JAX CLI's fault


def _compat_cases():
    """(argv, name) per compatibility flag of the JAX CLI: the reference
    flags of its "accepted for reference compatibility" group, and -nproc,
    -affineAlign, -noSplitSubreads, -advanceExactMatches and -V."""
    p = tcli.build_parser()
    grp = next(g for g in p._action_groups if g.title == "accepted for reference compatibility")
    cases = []
    for a in grp._group_actions:
        flag = a.option_strings[0]
        cases.append([flag] if a.nargs == 0 else [flag, "x" if a.metavar == "FILE" else "3"])
    cases += [["-nproc", "16"], ["-affineAlign"], ["-noSplitSubreads"],
              ["-advanceExactMatches", "2"], ["-V", "1"], ["-v"]]
    return cases


COMPAT = _compat_cases()


@pytest.mark.parametrize("argv", COMPAT, ids=[c[0] for c in COMPAT])
def test_compat_flag_changes_no_parameter(argv):
    p = tcli.build_parser()
    base = p.parse_args(["r.fa", "g.fa"])
    args = p.parse_args(["r.fa", "g.fa", *argv])
    assert tcli.params_from_args(args) == tcli.params_from_args(base)


def test_compat_flags_change_no_line(corpus, capsys):
    """Every compatibility flag at once prints the lines of the run without
    them (the JAX CLI's, which the port's equal), with the JAX CLI's
    warnings for the FILE flags and -computeAlignProbability on stderr."""
    assert len(COMPAT) == 22 + 27 + 7 + 5 + 6
    d = corpus["dir"]
    _port([corpus["reads"], corpus["genome"], *FLAGS, *[a for c in COMPAT for a in c],
           "-out", str(d / "t_compat.m4")])
    err = capsys.readouterr().err
    assert _lines(d / "t_compat.m4") == corpus["plain"]
    for flag in tcli.NOOP_FILE_FLAGS:
        assert f"warning: -{flag} is accepted for reference compatibility" in err
    assert "warning: -computeAlignProbability has no separate output" in err


def test_only_the_modes_not_ported_are_refused():
    """No mode is refused now that the port has them all: -ndevices and the
    optional mapping modes parse to their parameters
    (tests/test_torch_parallel.py and tests/test_torch_modes_*.py map
    them)."""
    p = tcli.build_parser()
    assert not hasattr(tcli, "unsupported_options")
    accepted = {("-ndevices", "2"): dict(ndevices=2), ("-ndevices", "0"): dict(ndevices=0),("-useSensitiveSearch",): dict(sensitive_retry=True, min_match_length=12,
                                               n_candidates=10),
                ("-maxExpand", "2"): dict(max_expand=2),
                ("-placeRepeatsRandomly",): dict(place_repeats_randomly=True),
                ("-pvaltype", "2"): dict(pval_type=2), ("-pvaltype", "3"): dict(pval_type=3)}
    for argv, fields in accepted.items():
        params = tcli.params_from_args(p.parse_args(["r.fa", "g.fa", *argv]))
        assert {f: getattr(params, f) for f in fields} == fields
    # -minExpand above -maxExpand raises max_expand with it: no retry pass
    args = p.parse_args(["r.fa", "g.fa", "-minExpand", "2", "-sdpTupleSize", "9"])
    params = tcli.params_from_args(args)
    assert (params.min_expand, params.max_expand, params.sdp_tuple_size) == (2, 2, 9)


# ---- run_mapping's batch stream ----

def _burst_reads(g):
    """tests/test_resume.py's burst corpus."""
    reads, _ = simulate_reads(g, 14, mean_len=800, seed=62)
    reads = list(reads)
    rng = np.random.default_rng(63)
    for i, t0 in enumerate((30_000, 70_000)):
        tpl = g[t0 : t0 + 1200]
        burst = rng.integers(0, 4, 150).astype(np.uint8)
        q = np.concatenate([tpl[:600], burst, tpl[600:]])
        reads.append(JRead(f"burst/{i}|ref|{t0}|{t0 + 1200}|0", q, None, 100 + i))
    return reads


@pytest.fixture(scope="module")
def burst(tmp_path_factory):
    """The burst corpus and the JAX CLI's uninterrupted -m 4 and
    -fullMetrics files of it."""
    d = tmp_path_factory.mktemp("burst")
    g = simulate_genome(120_000, seed=61, repeat_fraction=0.0)
    write_fasta(str(d / "g.fa"), [("ref", g)])
    write_fasta(str(d / "r.fa"), [(r.name, r.codes) for r in _burst_reads(g)])
    plain = str(d / "plain.m4")
    _jax([str(d / "r.fa"), str(d / "g.fa"), *BURST_FLAGS, "-out", plain,
          "-fullMetrics", str(d / "plain.fullMetrics")])
    return {"dir": d, "reads": str(d / "r.fa"), "genome": str(d / "g.fa"),
            "plain": _lines(plain)}


def _stream(reads_path, genome, argv, n_args, **kw):
    """run_mapping of the port at the CLI's parameters for ``argv``, with a
    callback of ``n_args`` parameters: (records, unmapped, metrics,
    streamed records, streamed unmapped names, held-back names, batch
    indices called)."""
    from blasr_tpu_torch.pipeline.runner import MappingMetrics

    params = tcli.params_from_args(tcli.build_parser().parse_args([reads_path, genome, *argv]))
    streamed, streamed_unm, held_names, calls = [], [], set(), []

    def on_batch3(bi, recs, unm):
        calls.append(bi)
        streamed.extend(recs)
        streamed_unm.extend(unm)

    def on_batch4(bi, recs, unm, held):
        on_batch3(bi, recs, unm)
        held_names.update(held)
        for name, h in held.items():
            assert h.records and all(r.qname == name for r in h.records)

    met = MappingMetrics()
    recs, unm = run_mapping(load_index(genome, k=13), read_records(reads_path), params,
                            device="cpu", metrics=met,
                            on_batch=on_batch3 if n_args == 3 else on_batch4, **kw)
    return recs, unm, met, streamed, streamed_unm, held_names, calls


@pytest.mark.parametrize("n_args", [3, 4])
def test_streamed_records_equal_the_returned_and_jax(burst, n_args):
    """Escalation replaces records here; the stream holds those reads back
    and delivers their resolved records in the final on_batch(-1, ...), so
    the streamed records are the returned ones, whose lines are the JAX
    CLI's. The -fullMetrics rows of the run equal the JAX CLI's: the Cells
    column is the first pass's DP cells per read, escalation aside."""
    from blasr_tpu_torch.pipeline.diagnostics import write_full_metrics

    recs, unm, met, streamed, streamed_unm, held, calls = _stream(
        burst["reads"], burst["genome"], BURST_FLAGS, n_args)
    assert met.escalated_reads >= 2
    assert calls[-1] == -1 and calls[:-1] == sorted(calls[:-1])
    assert sorted(format_m4(r) for r in streamed) == sorted(format_m4(r) for r in recs)
    assert [format_m4(r) for r in recs] == burst["plain"]
    assert sorted(streamed_unm) == sorted(unm)
    if n_args == 4:
        assert {"burst/0|ref|30000|31200|0", "burst/1|ref|70000|71200|0"} <= held
    buf = io.StringIO()
    write_full_metrics(buf, read_records(burst["reads"]), recs, unm, met)
    assert buf.getvalue().splitlines()[1:] == _lines(burst["dir"] / "plain.fullMetrics")[1:]


def test_skip_batches_and_truncation_equal_jax(corpus):
    """``skip_batches`` maps only the batches after the first ones; with a
    stream, a read longer than max_read_len is truncated to it, as in the
    JAX package (its run_mapping with on_batch), not mapped piecewise."""
    from blasr_tpu.cli.blasr import build_arg_parser, params_from_args

    d = corpus["dir"]
    reads = read_records(corpus["reads"])
    path = str(d / "r_long.fa")
    g = read_records(corpus["genome"])[0].codes
    write_fasta(path, [(r.name, r.codes) for r in reads] + [("long/0", g[30_000:30_400])])
    jparams = params_from_args(build_arg_parser().parse_args([path, corpus["genome"],
                                                              *FLAGS]))
    jrecs, junm = jrun_mapping(jload_index(corpus["genome"], k=13), jread_records(path),
                               jparams, on_batch=lambda bi, r, u: None, skip_batches=1)
    recs, unm, _, _, _, _, calls = _stream(path, corpus["genome"], FLAGS, 3,
                                           skip_batches=1)
    assert [format_m4(r) for r in recs] == [jformat_m4(r) for r in jrecs]
    assert unm == junm
    n_batches = len(list(batch_reads(read_records(path), 8, 256)))
    assert calls == list(range(1, n_batches))
    first = set(next(iter(batch_reads(read_records(path), 8, 256))).names)
    assert recs and not {r.qname for r in recs} & first
    assert [(r.qstart, r.qend, r.qlength) for r in recs if r.qname == "long/0"] == [(0, 256, 256)]


# ---- -resume ----

def _kill_at(monkeypatch, when):
    """Make the manifest's update raise ``Killed`` when ``when(n, state)``
    holds for the n-th update (1-based) and the manifest it writes:
    returns the callable that restores ``os.replace``. The tests' kill is
    a raise "before" (between the flush and the manifest's replace) when
    ``when`` returns "before", or right after it when it returns
    "after"."""
    real = os.replace
    n = [0]

    def fake(src, dst):
        n[0] += 1
        with open(src) as f:
            where = when(n[0], json.load(f))
        if where == "before":
            raise Killed
        real(src, dst)
        if where == "after":
            raise Killed

    monkeypatch.setattr(os, "replace", fake)
    return lambda: monkeypatch.setattr(os, "replace", real)


def _n_batches(reads_path, batch_size, max_read_len):
    return len(list(batch_reads(read_records(reads_path), batch_size, max_read_len)))


@pytest.mark.parametrize("when", ["after", "before"])
def test_resume_after_a_kill_ends_with_the_plain_lines(corpus, monkeypatch, when):
    """A kill right after batch 2's manifest update, and one between its
    flush and the update, then the same command: the file's sorted lines
    are the JAX CLI's uninterrupted run's, none repeated, and the resumed
    run maps only the batches not yet written. The JAX CLI's resume would
    append batch 2 again after the second kill. Each batch is written as
    soon as the next one is dispatched (the JAX CLI keeps eight in flight,
    so its first write waits for the ninth batch)."""
    d = corpus["dir"]
    out = str(d / f"resume_{when}.m4")
    argv = [corpus["reads"], corpus["genome"], *FLAGS, "-resume", "-out", out,
            "-metrics", str(d / f"resume_{when}.json")]
    total = _n_batches(corpus["reads"], 8, 256)
    assert total >= 3
    from blasr_tpu_torch.pipeline.mapper import Mapper

    mapped, saves = [], []
    real_map_batch = Mapper.map_batch
    monkeypatch.setattr(Mapper, "map_batch",
                        lambda self, *a, **k: (mapped.append(1), real_map_batch(self, *a, **k))[1])
    restore = _kill_at(monkeypatch, lambda n, m: (
        saves.append((m["batches_done"], len(mapped))),
        when if m["batches_done"] == 2 else None)[1])
    with pytest.raises(Killed):
        _port(argv)
    restore()
    monkeypatch.setattr(Mapper, "map_batch", real_map_batch)
    # one batch in flight: batch 0 is written once batch 1 is dispatched
    assert (1, 2) in saves
    with open(out + ".resume.json") as f:
        m = json.load(f)
    assert m["batches_done"] == (2 if when == "after" else 1)
    if when == "before":
        assert os.path.getsize(out) > m["out_bytes"]   # the kill landed in the window
    _port(argv)
    lines = _lines(out)
    assert sorted(lines) == sorted(corpus["plain"]) and len(set(lines)) == len(lines)
    with open(out + ".resume.json") as f:
        m = json.load(f)
    assert (m["batches_done"], m["deferred"]) == (total, {})
    with open(d / f"resume_{when}.json") as f:
        assert json.load(f)["stages"]["n_batches"] == total - (2 if when == "after" else 1)


def test_resume_with_escalation_ends_with_the_plain_lines(burst, monkeypatch):
    """On the burst corpus: a -resume run killed just before its last
    manifest update, after every batch was written and while the held-back
    reads' resolved records were being written, has the plain lines on
    disk; the manifest still holds those reads, with their narrow-pass
    lines. The rerun cuts the file back, re-maps them in one escalation
    pass, as the uninterrupted run does, and ends with the JAX CLI's
    uninterrupted lines."""
    d = burst["dir"]
    out = str(d / "resume.m4")
    argv = [burst["reads"], burst["genome"], *BURST_FLAGS, "-resume", "-out", out,
            "-fullMetrics", str(d / "resume.fullMetrics")]
    total = _n_batches(burst["reads"], 8, 1536)
    restore = _kill_at(monkeypatch, lambda n, m: (
        "before" if m["batches_done"] == total and not m["deferred"] else None))
    with pytest.raises(Killed):
        _port(argv)
    restore()
    assert sorted(_lines(out)) == sorted(burst["plain"])
    with open(out + ".resume.json") as f:
        held = json.load(f)["deferred"]
    assert {"burst/0|ref|30000|31200|0", "burst/1|ref|70000|71200|0"} <= set(held)
    _port(argv)
    assert sorted(_lines(out)) == sorted(burst["plain"])
    with open(out + ".resume.json") as f:
        assert json.load(f)["deferred"] == {}


def test_resume_sam_writes_the_plain_sam_lines(corpus):
    """-resume -sam ends with the plain -sam lines (sorted), the unmapped
    reads' lines included: a read the length filter drops before batching
    and one that maps nowhere."""
    d = corpus["dir"]
    reads = jread_records(corpus["reads"])
    rng = np.random.default_rng(9)
    extra = [("short/0", reads[0].codes[:40]),
             ("random/0", rng.integers(0, 4, 200).astype(np.uint8))]
    path = str(d / "r_sam.fa")
    write_fasta(path, [(r.name, r.codes) for r in reads[:12]] + extra)
    flags = [*FLAGS, "-sam"]
    _jax([path, corpus["genome"], *flags, "-out", str(d / "plain.sam")])
    _port([path, corpus["genome"], *flags, "-resume", "-out", str(d / "resume.sam")])
    plain, resumed = _lines(d / "plain.sam"), _lines(d / "resume.sam")
    assert sorted(resumed) == sorted(plain)
    unmapped = [ln.split("\t")[0] for ln in plain if ln.split("\t")[1:2] == ["4"]]
    assert {"short/0", "random/0"} <= set(unmapped)


@pytest.mark.parametrize("argv,refusal", [
    (["-m", "5"], "-m 5"), (["-sam", "-out", "x.bam"], "cannot write BAM")])
def test_resume_refuses_what_it_cannot_stream(corpus, argv, refusal):
    d = corpus["dir"]
    with pytest.raises(SystemExit, match=refusal):
        tcli.main([corpus["reads"], corpus["genome"], "-device", "cpu", "-resume",
                   "-out", str(d / "refused.txt"), *argv])
