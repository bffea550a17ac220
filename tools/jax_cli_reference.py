#!/usr/bin/env python3
"""The JAX CLI's files for phase 14 of chip_smoke.py, as digests, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_cli_reference.py [--out FILE] [--lines-dir DIR]

Two runs of ``blasr_tpu.cli.blasr.main`` in this process, on the corpora
that ``blasr_tpu_torch.bench`` writes under benchdata/ when missing:

  * ``cli_host``, command A: ``chip_smoke.CLI_FLAGS`` (less ``-device``)
    with the read selectors ``CLI_HOST_SELECTORS``, the compatibility
    flags ``CLI_HOST_COMPAT`` and the four diagnostic writers
    (``-fullMetrics``, ``-clusters``, ``-lcpBounds``, ``-anchors``) on the
    first 256 bench reads (``benchdata/reads_cli.fasta``, the file phase 4
    writes). Kept: the -out lines and each side file, the ``#`` line of
    -fullMetrics aside (its times are clock readings), and the names of
    the selected reads. The -anchors lines are kept in the port's order
    (``pipeline/debug.canonical_anchor_lines``: one read position's hits
    by genome position), since the JAX dump leaves that order to numpy's
    sort, which is not stable. The JAX CLI's -fullMetrics keys records by stream
    index but rows by position in the selected list, so under a selector
    its rows fall on other reads; the -fullMetrics kept here is the JAX
    CLI's on the selected reads written to a file of their own, where
    stream index and position agree (that run's -out lines are checked
    equal to command A's);
  * ``resume``: the uninterrupted ``CLI_FLAGS -m 4`` run on the 2000-read
    CLR FASTQ corpus (``benchdata/reads_clr.fastq``), the lines a killed
    and resumed run must end with.

Each file is kept as ``chip_smoke.text_digests`` gives it (the line count,
the sha256 of the lines in order and sorted, and per-read digests where
the lines name their read, ``chip_smoke.side_file_names``), with the md5
of the reads file and the host-clock seconds of each run as CPU figures.
The output defaults to ``tools/jax_cli_reference.json``. ``--lines-dir``
also writes the files, to diff against the card's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, HERE]


def _jax_flags():
    from chip_smoke import CLI_FLAGS

    i = CLI_FLAGS.index("-device")
    return CLI_FLAGS[:i] + CLI_FLAGS[i + 2:]


def _md5(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def _lines(path: str) -> list:
    with open(path) as f:
        return f.read().splitlines()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "jax_cli_reference.json"))
    ap.add_argument("--lines-dir", default=None, help="also write each file here")
    args = ap.parse_args()

    from blasr_tpu.cli.blasr import main as jax_cli
    from blasr_tpu.pipeline import runner
    from blasr_tpu_torch import bench
    from blasr_tpu_torch.pipeline.debug import canonical_anchor_lines
    from chip_smoke import (CLI_HOST_COMPAT, CLI_HOST_SELECTORS, CLI_HOST_SIDE_FILES,
                            side_file_names, text_digests)

    genome_fa, _ = bench.ensure_corpus()
    reads_fq = bench.ensure_fastq_corpus()
    reads_cli = os.path.join(bench.BENCH_DIR, "reads_cli.fasta")
    bench.write_reads(reads_cli, bench.load_reads()[:256])
    flags = _jax_flags()
    out: dict = {}
    tmp = os.path.join(bench.BENCH_DIR, "jax_cli")
    os.makedirs(tmp, exist_ok=True)
    files = {kind: os.path.join(tmp, f"a.{kind}") for kind in ("out", *CLI_HOST_SIDE_FILES)}

    # command A, the selected reads captured from the JAX CLI's first run_mapping call
    captured: list = []
    orig = runner.run_mapping

    def capture(index, reads, params, **kw):
        if not captured:
            captured.append(list(reads))
        return orig(index, reads, params, **kw)

    runner.run_mapping = capture
    try:
        t0 = time.time()
        jax_cli([reads_cli, genome_fa, *flags, *CLI_HOST_SELECTORS, *CLI_HOST_COMPAT,
                 "-out", files["out"],
                 *[a for kind in CLI_HOST_SIDE_FILES for a in (f"-{kind}", files[kind])]])
        seconds_a = time.time() - t0
    finally:
        runner.run_mapping = orig
    selected = captured[0]
    names = [r.name for r in selected]
    texts = {kind: _lines(path) for kind, path in files.items()}
    texts["anchors"] = canonical_anchor_lines(texts["anchors"])

    # -fullMetrics on the selected reads' own file
    own_dir = os.path.join(tmp, "selected")
    os.makedirs(own_dir, exist_ok=True)
    own = os.path.join(own_dir, "reads_cli.fasta")
    bench.write_reads(own, selected)
    own_out, own_fm = os.path.join(tmp, "own.m4"), os.path.join(tmp, "own.fullMetrics")
    jax_cli([own, genome_fa, *flags, *CLI_HOST_COMPAT, "-out", own_out, "-fullMetrics", own_fm])
    if _lines(own_out) != texts["out"]:
        raise AssertionError("the selected reads' own file maps to other -out lines")
    texts["fullMetrics"] = [ln for ln in _lines(own_fm) if not ln.startswith("#")]

    out["cli_host"] = {
        "reads_file": os.path.relpath(reads_cli, REPO), "reads_md5": _md5(reads_cli),
        "flags": [*CLI_HOST_SELECTORS, *CLI_HOST_COMPAT], "selected": names,
        "files": {kind: text_digests(lines, side_file_names(kind, lines, names))
                  for kind, lines in texts.items()},
        "seconds_cpu_host_clock": round(seconds_a, 1),
    }

    # B: the uninterrupted CLR FASTQ run
    out_b = os.path.join(tmp, "b.m4")
    t0 = time.time()
    jax_cli([reads_fq, genome_fa, *flags, "-out", out_b])
    seconds_b = time.time() - t0
    texts_b = _lines(out_b)
    out["resume"] = {
        "reads_file": os.path.relpath(reads_fq, REPO), "reads_md5": _md5(reads_fq),
        "records": len(texts_b), **text_digests(texts_b, side_file_names("out", texts_b, None)),
        "seconds_cpu_host_clock": round(seconds_b, 1),
    }
    if args.lines_dir:
        os.makedirs(args.lines_dir, exist_ok=True)
        for kind, lines in {**texts, "resume": texts_b}.items():
            with open(os.path.join(args.lines_dir, f"{kind}.txt"), "w") as f:
                f.writelines(ln + "\n" for ln in lines)
    print(json.dumps({"selected": len(names),
                      **{kind: len(lines) for kind, lines in texts.items()},
                      "resume_records": len(texts_b), "seconds_a": round(seconds_a, 1),
                      "seconds_b": round(seconds_b, 1)}), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
