"""Command line of the port: mapping on one device to -m 0, 1, 2, 3, 4 or 5,
SAM or BAM.

    python -m blasr_tpu_torch.cli.blasr reads.{fa,fastq,sam,bam} genome.fa -m 4 \\
        [-out FILE] [-header] [-device cuda|cpu] [mapping options]
    python -m blasr_tpu_torch.cli.blasr reads.fastq genome.fa -sam \\
        [-clipping soft|hard|none|subread] [-samqv NAME ...] [-out FILE.{sam,bam}]

The flags are the JAX package's (``cli/args.py`` holds the port's copy of
its parser and ``params_from_args``). Only the options of the ported slice
are accepted (see ``SUPPORTED``); any other option given raises an error
that names it. FASTQ quality values, and the ``iq``/``sq`` tracks of a SAM
read file, scale the DP's costs unless ``-ignoreQualities`` is given.
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
``-device`` defaults to ``cuda`` and never falls back to the CPU.
"""

from __future__ import annotations

import io
import json
import os
import sys
import time

from blasr_tpu_torch.cli.args import build_arg_parser, params_from_args

# argparse destinations the port honours (with the reference's defaults)
SUPPORTED = {
    "reads", "genome", "m", "out", "header", "device", "metrics",
    "bestn", "printOnlyBest", "nCandidates", "dpCandidates", "minMatch",
    "anchorStride", "maxAnchorsPerRead", "maxAnchorsPerPosition",
    "batchSize", "maxReadLen", "bandSize", "maxScore", "minPctIdentity",
    "maxPctIdentity", "minAlnLength", "minAlnLength2", "minReadLength",
    "minSubreadLength", "minMapQV", "minInterval", "forwardOnly",
    "indel", "insertion", "deletion", "match", "mismatch",
    "affineOpen", "affineExtend", "pvaltype", "indelRate",
    "ignoreQualities", "minAvgQual", "useGuidedAlign", "scoreMatrix",
    "sam", "clipping", "samqv", "unaligned", "noPrintUnalignedSeqs", "titleTable",
    "bwt", "sa", "nucmer", "alignContigs", "removeContained",
}
FM_SUFFIX = ".btfm.npz"   # the FM bundle beside the genome (the JAX package's name)


def build_parser():
    p = build_arg_parser()
    p.prog = "blasr_tpu_torch"
    p.description = ("BLASR-capability long-read aligner, PyTorch/CUDA port "
                     "(-m 0-5, -sam, BAM)")
    p.add_argument("-device", default="cuda", help="torch device to map on (cuda or cpu)")
    return p


def unsupported_options(parser, args) -> list[str]:
    """Flags given with a non-default value that the port does not take."""
    bad = []
    defaults: dict = {}
    for action in parser._actions:
        # the namespace default of a shared dest is its first action's
        defaults.setdefault(action.dest, action.default)
    for action in parser._actions:
        dest = action.dest
        if dest in SUPPORTED or dest == "help" or not action.option_strings:
            continue
        if getattr(args, dest, defaults[dest]) != defaults[dest]:
            bad.append(action.option_strings[0])
    if args.pvaltype not in (0, 1):
        bad.append(f"-pvaltype {args.pvaltype}")
    return bad


def load_fm_index(genome_path: str, bwt: str, k: int):
    """(genome-only GenomeIndex, FMIndex) for ``-bwt [FILE]``: the FM path
    needs only the genome codes, the seed-validity mask and the contig db,
    so no suffix-array bundle is built. FILE (default ``<genome>`` +
    ``FM_SUFFIX``) is a reference ``.bwt`` (inverted and checked against
    the FASTA, then the FM index is built from the genome), an existing FM
    bundle (loaded), or else the path the FM index is built and saved to."""
    import numpy as np

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


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    bad = unsupported_options(parser, args)
    if bad:
        raise SystemExit(
            "blasr_tpu_torch: not supported by the port yet: " + ", ".join(bad)
            + " (the port maps to -m 0-5, SAM and BAM on one device; see ROADMAP.md)"
        )
    params = params_from_args(args)
    params.validate()

    from blasr_tpu_torch.core.encode import codes_to_seq
    from blasr_tpu_torch.index.artifacts import build_index_from_sa, load_index
    from blasr_tpu_torch.io.bam import write_bam_from_sam_lines
    from blasr_tpu_torch.io.batching import read_records
    from blasr_tpu_torch.ops import dp_launch_counts, launch_counts
    from blasr_tpu_torch.output.m4 import write_m4
    from blasr_tpu_torch.output.sam_writer import write_sam
    from blasr_tpu_torch.output.verbose import write_verbose
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
    reads = read_records(args.reads)
    if args.titleTable:
        with open(args.titleTable, "w") as f:
            for name in index.seqdb.names:
                f.write(name + "\n")
        # ResetTableToIntegers (Blasr.cpp:4495, TitleTable.h role): output
        # refers to contigs by their table index; the table file maps back
        index.seqdb.names = [str(i) for i in range(len(index.seqdb.names))]
    met = MappingMetrics()
    t0 = time.time()
    run = run_mapping_piecewise if params.piecewise else run_mapping
    records, unmapped = run(index, reads, params, device=args.device, metrics=met, fm=fm)
    t_map = time.time() - t0

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
    else:
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
