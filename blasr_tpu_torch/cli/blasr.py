"""Command line of the port: mapping on one device to -m 0, 1, 2, 3, 4 or 5,
SAM or BAM.

    python -m blasr_tpu_torch.cli.blasr reads.{fa,fastq,sam,bam} genome.fa -m 4 \\
        [-out FILE] [-header] [-device cuda|cpu] [mapping options]
    python -m blasr_tpu_torch.cli.blasr reads.fastq genome.fa -sam \\
        [-clipping soft|hard|none|subread] [-samqv NAME ...] [-out FILE.{sam,bam}]

The flags are the JAX package's (``cli/args.py`` holds the port's copy of
its parser and ``params_from_args``), and a BLASR command line runs as it
is: the compatibility flags the JAX CLI accepts (``-nproc``,
``-affineAlign``, ``-noSplitSubreads``, ``-advanceExactMatches``, ``-V``
and the long tail of reference flags, ``cli/args.py``) are accepted and
change nothing; those that name a file (``-ctab``, ``-seqdb``,
``-findex``, ``-regionTable``, ``-fileType``) and
``-computeAlignProbability`` say so on stderr. Only ``-ndevices`` other
than 1 is refused, by name (``unsupported_options``).
``-useSensitiveSearch`` re-maps the unmapped reads and those below 80%
similarity with twice the candidates and anchors (and takes seeds of at
most 12 bases and at least 10 candidates for the whole run);
``-maxExpand N`` re-maps the reads still unmapped at each wider seed
level up to N; ``-placeRepeatsRandomly`` orders a read's tied alignments
at random from ``-randomSeed``; ``-pvaltype 2`` and ``3`` rank the
candidate windows by their anchor count or inverse-frequency weight.
``-start``, ``-stride``, ``-subsample`` (with ``-randomSeed``),
``-maxReadLength``, ``-maxReadIndex``, ``-readIndex`` and ``-readIndices``
select the reads to map (``select_reads``). FASTQ quality values, and
the ``iq``/``sq`` tracks of a SAM read file, scale the DP's costs unless
``-ignoreQualities`` is given.
``-useGuidedAlign`` bands each read along its own anchor chain (the wide
buckets keep the base band of 128); ``-scoreMatrix "25 ints"`` scores
substitutions from a 5x5 matrix. ``-bestn N`` reports up to N alignments
per read, each secondary admitted on the host as the reference does.
``-m 0``, ``1``, ``2``, ``3`` and ``5`` print the verbose formats (0, 2 and
5 with alignment strings, 3 as a VULGAR string, all from the walk's move
strings).
``-sam`` writes SAM (BAM when ``-out`` ends in ``.bam``), with the reads
file's basename as the movie name and the CIGAR's matches split into = and
X; ``-clipping`` chooses the clip of the unaligned ends, ``-samqv`` the
read's QV tracks echoed as tags. ``-unaligned FILE`` writes the unmapped
reads (names only with ``-noPrintUnalignedSeqs``), and ``-titleTable
FILE`` writes the contig names and prints each contig by its index.
``-bwt [FILE]`` anchors by FM backward search instead of the suffix
array's direct tables (the reference's low-memory mode): FILE is a
``.btfm.npz`` bundle that is loaded, or built from the genome and saved
there when missing (default ``<genome>.btfm.npz``), or a reference binary
``.bwt``, checked against the genome FASTA.
``-sa FILE`` builds the index around a reference-format suffix array (as
``sawriter`` writes it) instead of building one (``-bwt`` wins when both
are given). ``-minMatch`` takes seeds of 1 to 30 bases: up to 14 on a
genome of 1 Mb or more through the direct 4^k tables, else by bisection
over the sorted keys, and above 15 over keys split in two halves;
``-nucmer`` sets the seed to 30 bases and ``-maxScore`` to at most -200.
Reads longer than ``-maxReadLen`` are cut into segments, mapped, and
stitched back into whole-read records; ``-alignContigs`` (``-piecewise``)
maps every query above the segment length so, for multi-megabase contigs,
with ``-removeContained`` and move strings on. ``-removeContained`` drops
alignments whose read span lies inside a better one's.
``-resume`` checkpoints a run batch by batch (``run_resumable``): the
records are appended to ``-out`` as each batch finalizes and a manifest
at ``<out>.resume.json`` records the progress, so a rerun of the same
command after a kill maps only the batches not yet written and ends with
the uninterrupted run's lines. ``-anchors FILE`` writes every anchor of
every read (``pipeline/debug.py``, on the device), ``-fullMetrics``,
``-clusters`` and ``-lcpBounds`` the per-read rows, the per-alignment
cluster rows and the suffix-array interval widths
(``pipeline/diagnostics.py``).
``-device`` defaults to ``cuda`` and never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import sys
import time

import numpy as np

from blasr_tpu_torch.cli.args import build_arg_parser, params_from_args

# the compatibility flags that name a file: accepted, no file is read or written
NOOP_FILE_FLAGS = ("ctab", "seqdb", "findex", "regionTable", "fileType")
FM_SUFFIX = ".btfm.npz"   # the FM bundle beside the genome (the JAX package's name)


def build_parser():
    p = build_arg_parser()
    p.prog = "blasr_tpu_torch"
    p.description = ("BLASR-capability long-read aligner, PyTorch/CUDA port "
                     "(-m 0-5, -sam, BAM)")
    p.add_argument("-device", default="cuda", help="torch device to map on (cuda or cpu)")
    return p


def unsupported_options(args) -> list[str]:
    """The options given that select a mode the port does not have yet
    (ROADMAP.md queue 1, item 16: mapping over several devices), by name.
    Every other flag of the JAX CLI is honoured or, as there, accepted and
    changes nothing."""
    return [f"-ndevices {args.ndevices}"] if args.ndevices != 1 else []


def warn_noop_flags(args) -> None:
    """The JAX CLI's warnings for the compatibility flags whose output a
    user would look for (blasr_tpu/cli/blasr.py:506-522)."""
    for noop in NOOP_FILE_FLAGS:
        if getattr(args, noop, None):
            print(
                f"[blasr_tpu] warning: -{noop} is accepted for reference "
                "compatibility but has no effect (index artifacts are "
                "auto-discovered); no file will be read or written",
                file=sys.stderr,
            )
    if getattr(args, "computeAlignProbability", False):
        print(
            "[blasr_tpu] warning: -computeAlignProbability has no separate "
            "output here; use -metrics FILE for the run statistics",
            file=sys.stderr,
        )


def select_reads(reads, args) -> list:
    """The reads the input selectors keep, in the JAX CLI's order
    (blasr_tpu/cli/blasr.py:583-602): every ``-stride``-th read from
    ``-start``, each kept with probability ``-subsample`` (numpy's
    generator seeded with ``-randomSeed``, one draw per read that passes
    the stride, as there); then reads no longer than ``-maxReadLength``,
    with a stream index below ``-maxReadIndex``, and with the stream
    index ``-readIndex`` or one of ``-readIndices``."""
    if args.start or args.stride > 1 or args.subsample < 1.0:
        rng = np.random.default_rng(args.randomSeed)
        reads = [
            r for i, r in enumerate(reads)
            if i >= args.start and (i - args.start) % args.stride == 0
            and (args.subsample >= 1.0 or rng.random() < args.subsample)
        ]
    if args.maxReadLength:
        reads = [r for r in reads if len(r) <= args.maxReadLength]
    if args.maxReadIndex is not None:
        reads = [r for r in reads if r.index < args.maxReadIndex]
    if args.readIndex is not None or args.readIndices:
        want = set()
        if args.readIndex is not None:
            want.add(args.readIndex)
        if args.readIndices:
            want.update(int(x) for x in args.readIndices.split(","))
        reads = [r for r in reads if r.index in want]
    return reads


def load_fm_index(genome_path: str, bwt: str, k: int):
    """(genome-only GenomeIndex, FMIndex) for ``-bwt [FILE]``: the FM path
    needs only the genome codes, the seed-validity mask and the contig db,
    so no suffix-array bundle is built. FILE (default ``<genome>`` +
    ``FM_SUFFIX``) is a reference ``.bwt`` (inverted and checked against
    the FASTA, then the FM index is built from the genome), an existing FM
    bundle (loaded), or else the path the FM index is built and saved to."""
    from blasr_tpu_torch.index.artifacts import GenomeIndex, build_pos_ok
    from blasr_tpu_torch.index.fm import FMIndex, build_fm_index
    from blasr_tpu_torch.index.suffix_array import build_suffix_array
    from blasr_tpu_torch.io.seqdb import load_genome

    genome, seqdb = load_genome(genome_path)
    empty = np.zeros(0, np.int32)
    index = GenomeIndex(genome, empty, empty, build_pos_ok(genome, seqdb, k), k, seqdb)
    fm_path = bwt or (genome_path + FM_SUFFIX)
    if fm_path.endswith(".bwt") and os.path.exists(fm_path):
        from blasr_tpu_torch.index.bwtfile import read_ref_bwt, ref_bwt_genome_matches
        from blasr_tpu_torch.io.fasta import read_fasta

        if not ref_bwt_genome_matches(read_ref_bwt(fm_path), read_fasta(genome_path)):
            raise SystemExit(f"{fm_path}: .bwt content does not match {genome_path}")
        fm = build_fm_index(genome, build_suffix_array(genome))
    elif os.path.exists(fm_path):
        fm = FMIndex.load(fm_path)
    else:
        fm = build_fm_index(genome, build_suffix_array(genome))
        try:
            fm.save(fm_path)
        except OSError:
            pass
    return index, fm


def write_output(args, params, index, reads, records, unmapped) -> None:
    """The run's records to ``-out``: SAM (BAM when it ends in ``.bam``),
    -m 4 or a verbose format."""
    from blasr_tpu_torch.io.bam import write_bam_from_sam_lines
    from blasr_tpu_torch.output.m4 import write_m4
    from blasr_tpu_torch.output.sam_writer import write_sam
    from blasr_tpu_torch.output.verbose import write_verbose

    def sam(out):
        write_sam(records, reads, index.seqdb, out, clipping=args.clipping,
                  program_line=" ".join(sys.argv), unmapped=unmapped,
                  movie_name=os.path.basename(args.reads), genome=index.genome,
                  samqv=params.samqv)

    if args.sam and args.out.endswith(".bam"):
        buf = io.StringIO()
        sam(buf)
        lines = buf.getvalue().split("\n")
        write_bam_from_sam_lines([ln for ln in lines if ln.startswith("@")],
                                 [ln for ln in lines if ln and not ln.startswith("@")],
                                 args.out)
        return
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        if args.sam:
            sam(out)
        elif args.m == 4:
            write_m4(records, out, header=args.header)
        else:
            write_verbose(records, reads, index, out, fmt=args.m, header=args.header)
    finally:
        if out is not sys.stdout:
            out.close()


def write_diagnostics(args, params, index, reads, records, unmapped, metrics, fm) -> None:
    """The side files the JAX CLI writes after mapping
    (blasr_tpu/cli/blasr.py:688-720): -anchors (the anchor searches on
    ``args.device``), -fullMetrics, -clusters and -lcpBounds, which needs
    the suffix array's keys and warns without them."""
    from blasr_tpu_torch.pipeline.diagnostics import (
        write_clusters,
        write_full_metrics,
        write_lcp_bounds,
    )

    if args.anchors:
        from blasr_tpu_torch.pipeline.debug import dump_anchors

        with open(args.anchors, "w") as f:
            dump_anchors(index, reads, params, f, device=args.device, fm=fm)
    if args.fullMetrics:
        with open(args.fullMetrics, "w") as f:
            write_full_metrics(f, reads, records, unmapped, metrics)
    if args.clusters:
        with open(args.clusters, "w") as f:
            write_clusters(f, reads, records)
    if args.lcpBounds:
        if getattr(index, "sa_kmers", None) is None or fm is not None:
            print(
                "[blasr_tpu] warning: -lcpBounds needs the suffix-array "
                "index (not available on the -bwt path); skipping",
                file=sys.stderr,
            )
        else:
            with open(args.lcpBounds, "w") as f:
                write_lcp_bounds(f, reads, index)


def run_resumable(args, params, index, reads, fm, metrics):
    """``-resume``: the run checkpointed batch by batch, as the JAX CLI's
    ``_run_resumable`` (blasr_tpu/cli/blasr.py:378-499) does: each
    batch's records (-m 4 lines, or SAM) are appended to ``-out`` as it
    finalizes, and the manifest ``<out>.resume.json`` records the batches
    written, keyed on the reads, the genome, the selected reads, the
    parameters and the output format. A rerun of the same command maps
    only the batches after them. Returns (records, unmapped) of the
    batches this process mapped.

    Its departures from the JAX CLI's (ROADMAP.md queue 3), by which its
    resumed file is always the uninterrupted run's:
      * the manifest also records the byte length of ``-out`` after each
        flush, and a resume first cuts ``-out`` back to it, so a kill
        between a flush and the manifest's update repeats no line;
      * the reads that a later pass may still replace or map are held
        back (``run_mapping``'s ``held``: band escalation's and the
        sensitive retry's candidates, adaptive_cd's flagged reads, and the
        unmapped reads when the expand cascade or the sensitive retry may
        map them, so no read gets both an unmapped line and a record); the
        manifest keeps each one's ``HeldRead.summary()`` and lines, and a
        resumed run hands them to ``run_mapping`` (``carried``), so each
        pass maps the run's whole candidate set, as the uninterrupted run
        does, where the JAX CLI re-maps them on their own with other batch
        mates; they are written, a pass's records or the kept lines, at the
        end, with one manifest update;
      * one batch is in flight, where the JAX CLI's runs eight ahead, so a
        batch is written as soon as it is mapped, not after the ninth is
        dispatched;
      * with ``-sam``, the unmapped reads get their unmapped line, those
        the length and quality filters drop before batching included (the
        JAX CLI writes none under -resume), and with ``-header`` the -m 4
        file starts with its header line.
    """
    from blasr_tpu_torch.output.m4 import HEADER, format_m4
    from blasr_tpu_torch.output.sam_writer import (
        format_read_records,
        format_unmapped,
        read_group_id,
        records_by_read,
        sam_header,
    )
    from blasr_tpu_torch.pipeline.runner import passes_input_filters, run_mapping

    manifest_path = args.out + ".resume.json"
    key = {
        "reads": os.path.abspath(args.reads),
        "reads_bytes": os.path.getsize(args.reads),
        "genome": os.path.abspath(args.genome),
        "selected": hashlib.sha256("\n".join(r.name for r in reads).encode()).hexdigest(),
        "params": repr(params),
        "output": [bool(args.sam), args.clipping, bool(args.header), bool(args.titleTable)],
    }
    state = None
    if os.path.exists(manifest_path) and os.path.exists(args.out):
        try:
            with open(manifest_path) as f:
                m = json.load(f)
        except (OSError, ValueError):
            m = None
        # a manifest of another run, of a format without the held reads'
        # summaries, or past the end of -out starts the run afresh
        if (isinstance(m, dict) and m.get("key") == key
                and 0 <= m.get("out_bytes", -1) <= os.path.getsize(args.out)
                and isinstance(m.get("deferred"), dict)
                and all({"amb", "records", "lines"} <= set(d) for d in m["deferred"].values())):
            state = m
    movie = os.path.basename(args.reads)
    rgid = read_group_id(movie)
    read_of_name: dict = {}
    for r in reads:
        read_of_name.setdefault(r.name, r)

    def lines_of(recs, unmapped_names) -> list:
        if not args.sam:
            return [format_m4(r) for r in recs]
        lines = []
        for i, rs in records_by_read(recs, reads).items():
            lines += format_read_records(rs, reads[i], index.seqdb, args.clipping, rgid,
                                         index.genome, params.samqv)
        return lines + [format_unmapped(read_of_name[n], rgid=rgid)
                        for n in unmapped_names if n in read_of_name]

    def emit(lines) -> None:
        out_f.write("".join(ln + "\n" for ln in lines).encode())
        out_f.flush()

    def save() -> None:
        state["out_bytes"] = out_f.tell()
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, manifest_path)

    if state is None:
        out_f = open(args.out, "wb")
        state = {"key": key, "batches_done": 0, "out_bytes": 0, "deferred": {}}
        head = []
        if args.sam:
            head = sam_header(index.seqdb, " ".join(sys.argv), [movie]) + lines_of(
                [], [r.name for r in reads if not passes_input_filters(r, params)])
        elif args.header:
            head = [HEADER]
        emit(head)
        save()
    else:
        out_f = open(args.out, "r+b")
        out_f.truncate(state["out_bytes"])
        out_f.seek(0, os.SEEK_END)
    carried = {n: {"amb": d["amb"], "records": d["records"]}
               for n, d in state["deferred"].items()}
    delivered: set = set()

    def on_batch(bi, recs, unm, held=None):
        emit(lines_of(recs, unm))
        if bi < 0:
            # the resolved records and unmapped names of the held-back
            # reads: the manifest keeps them pending until the kept lines
            # are written too
            delivered.update(r.qname for r in recs)
            delivered.update(unm)
            return
        state["batches_done"] = max(state["batches_done"], bi + 1)
        for n, h in (held or {}).items():
            state["deferred"][n] = {**h.summary(),
                                    "lines": lines_of(h.records, [] if h.records else [n])}
        save()

    # one batch in flight, so each batch is written as soon as it is mapped
    # (at the default depth of 8 the first write waits for the ninth batch;
    # the records do not depend on the depth)
    run_params = dataclasses.replace(params, dispatch_ahead=min(params.dispatch_ahead, 1))
    try:
        records, unmapped = run_mapping(
            index, reads, run_params, device=args.device, metrics=metrics, fm=fm,
            on_batch=on_batch, skip_batches=state["batches_done"], carried=carried,
        )
        if state["deferred"]:
            # held-back reads of skipped batches that no pass replaced keep
            # their lines
            emit([ln for n, d in state["deferred"].items() if n not in delivered
                  for ln in d["lines"]])
            state["deferred"] = {}
            save()
    finally:
        out_f.close()
    return records, unmapped


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    bad = unsupported_options(args)
    if bad:
        raise SystemExit(
            "blasr_tpu_torch: not supported by the port yet: " + ", ".join(bad)
            + " (see ROADMAP.md)"
        )
    params = params_from_args(args)
    params.validate()
    warn_noop_flags(args)
    resumable = args.resume and args.out != "-" and not params.piecewise
    if args.resume and args.out.endswith(".bam"):
        raise SystemExit(
            "-resume streams text records and cannot write BAM; "
            "resume to .sam and convert, or drop -resume"
        )
    if resumable and not args.sam and args.m != 4:
        raise SystemExit(f"-resume writes -m 4 or SAM lines, not -m {args.m}; "
                         "drop -resume or take -m 4")

    from blasr_tpu_torch.core.encode import codes_to_seq
    from blasr_tpu_torch.index.artifacts import build_index_from_sa, load_index
    from blasr_tpu_torch.io.batching import read_records
    from blasr_tpu_torch.ops import dp_launch_counts, launch_counts
    from blasr_tpu_torch.pipeline.piecewise import run_mapping_piecewise
    from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping

    t_start = time.time()
    fm = None
    if args.bwt is not None:
        index, fm = load_fm_index(args.genome, args.bwt, params.min_match_length)
    elif args.sa is not None:
        # reference-format .sa input (SuffixArray.h:505 layout): reuse the
        # precomputed array, derive the device-side artifacts from it
        index = build_index_from_sa(args.genome, args.sa, k=params.min_match_length)
    else:
        index = load_index(args.genome, k=params.min_match_length)
    t_index = time.time() - t_start
    reads = select_reads(read_records(args.reads), args)
    if args.titleTable:
        with open(args.titleTable, "w") as f:
            for name in index.seqdb.names:
                f.write(name + "\n")
        # ResetTableToIntegers (Blasr.cpp:4495, TitleTable.h role): output
        # refers to contigs by their table index; the table file maps back
        index.seqdb.names = [str(i) for i in range(len(index.seqdb.names))]
    met = MappingMetrics()
    t0 = time.time()
    if resumable:
        records, unmapped = run_resumable(args, params, index, reads, fm, met)
        t_map = time.time() - t0
    else:
        run = run_mapping_piecewise if params.piecewise else run_mapping
        records, unmapped = run(index, reads, params, device=args.device, metrics=met, fm=fm)
        t_map = time.time() - t0
        write_output(args, params, index, reads, records, unmapped)
    if args.unaligned:
        # every unmapped OCCURRENCE is written (duplicate read names are
        # legal in FASTA; a name->read dict would collapse them)
        unmapped_names = set(unmapped)
        with open(args.unaligned, "w") as f:
            for rd in reads:
                if rd.name not in unmapped_names:
                    continue
                if args.noPrintUnalignedSeqs:
                    f.write(rd.name + "\n")
                else:
                    f.write(f">{rd.name}\n{codes_to_seq(rd.codes)}\n")
    write_diagnostics(args, params, index, reads, records, unmapped, met, fm)
    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump({
                "device": args.device,
                "nReads": len(reads),
                "nMapped": len(reads) - len(unmapped),
                "nAlignments": len(records),
                "indexLoadSeconds": round(t_index, 3),
                "mapSeconds": round(t_map, 3),
                "stages": met.to_dict(),
                "kernelLaunches": launch_counts(),
                "dpLaunches": dp_launch_counts(),
            }, f, indent=2)
    print(f"Finished mapping {len(reads) - len(unmapped)}/{len(reads)} reads",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
