"""``-resume`` under ``-useSensitiveSearch -maxExpand 2``: the port's CLI
killed mid-run and rerun ends with the lines of the JAX CLI's
uninterrupted run, on the CPU.

The corpus of test_torch_modes_passes.py as FASTA files (its dense reads
map only at expand level 2, its noisy ones trip the sensitive retry and
band escalation), batches of 8. The kill is ``os.replace`` patched to
raise: right after batch 1's manifest update (-m 4), and just before the
last update, while the held-back reads' resolved records are written
(-sam). The manifest holds each held read's first-pass summary and lines;
the rerun cuts -out back, carries the held reads into its passes and ends
with the JAX CLI's uninterrupted lines (sorted), none missing and none
repeated, and no read with both an unmapped SAM line and a record.
Tolerance 0."""

import json
import os

import pytest
import torch

from blasr_tpu.cli.blasr import main as jax_main
from blasr_tpu.io.fasta import write_fasta
from blasr_tpu_torch.cli import blasr as tcli

from test_torch_modes_passes import modes_genome, modes_reads

torch.set_num_threads(1)

FLAGS = ["-batchSize", "8", "-maxReadLen", "256", "-minMatch", "11", "-nCandidates", "4",
         "-dpCandidates", "2", "-anchorStride", "4", "-maxAnchorsPerRead", "128",
         "-bandSize", "16", "-useSensitiveSearch", "-maxExpand", "2"]


class Killed(Exception):
    """A kill of the process, raised from inside the resumable writer."""


def _lines(path) -> list:
    with open(path) as f:
        return f.read().splitlines()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("modes_resume")
    g = modes_genome()
    write_fasta(str(d / "g.fa"), [("ref", g)])
    write_fasta(str(d / "r.fa"), modes_reads(g))
    return d


def _kill_at(monkeypatch, when):
    """``os.replace`` raising ``Killed`` before or after the n-th manifest
    update, as ``when(n, manifest)`` says ("before" / "after" / None)."""
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


@pytest.mark.parametrize("fmt", ["m4", "sam"])
def test_resume_under_the_retry_passes_ends_with_the_jax_lines(files, monkeypatch, fmt):
    d = files
    out_flags = ["-m", "4"] if fmt == "m4" else ["-sam"]
    common = [str(d / "r.fa"), str(d / "g.fa"), *FLAGS, *out_flags]
    assert jax_main([*common, "-out", str(d / f"jax.{fmt}")]) == 0
    want = _lines(d / f"jax.{fmt}")
    out = str(d / f"resume.{fmt}")
    argv = [*common, "-resume", "-out", out, "-device", "cpu"]
    if fmt == "m4":
        def when(n, m):
            return "after" if m["batches_done"] == 1 else None
    else:
        def when(n, m):
            return "before" if m["batches_done"] == 3 and not m["deferred"] else None
    restore = _kill_at(monkeypatch, when)
    with pytest.raises(Killed):
        tcli.main(argv)
    restore()
    with open(out + ".resume.json") as f:
        held = json.load(f)["deferred"]
    assert held and all(set(h) == {"amb", "records", "lines"} for h in held.values())
    # the dense reads are held unmapped (the expand cascade may map them)
    if fmt == "sam":
        assert held["dense/0"]["records"] == [] and len(held["dense/0"]["lines"]) == 1
    assert tcli.main(argv) == 0
    lines = _lines(out)
    assert sorted(lines) == sorted(want) and len(set(lines)) == len(lines)
    with open(out + ".resume.json") as f:
        m = json.load(f)
    assert (m["batches_done"], m["deferred"]) == (3, {})
    body = [ln.split("\t") if fmt == "sam" else ln.split() for ln in lines
            if not ln.startswith("@")]
    if fmt == "sam":
        unmapped = {f[0] for f in body if int(f[1]) & 4}
        mapped = {f[0] for f in body if not int(f[1]) & 4}
        assert not unmapped & mapped and any(n.startswith("dense/") for n in mapped)
    else:
        assert {"dense/0", "dense/1"} <= {f[0].rsplit("/", 1)[0] for f in body}
