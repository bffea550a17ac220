"""Satellite tools (L8) — one multi-command CLI.

Roles of the reference satellite executables that remain relevant without
HDF5 (SURVEY.md §2.10):

  samtom4     pbihdfutils/SamToM4.cpp   — SAM -> m4 interval format
  samfilter   pbihdfutils/SamFilter.cpp — filter SAM by score/identity/length
  ctab        alignment/PrintTupleCountTable.cpp + TupleCountTable.h —
              genome k-mer count table (built on the fly, printed or saved)
  shredder    sequtils/SimpleShredder   — shred a genome into reads
  evolve      sequtils/Evolve.cpp       — mutate a genome (test data)
  wordcount   alignment/WordCounter.cpp — top-N k-mer frequencies

Usage: python -m blasr_tpu_torch.cli.tools <command> [args]

The port's copy of ``blasr_tpu/cli/tools.py``, whole but for ``dotplot``,
the one command that uses the device: it takes ``-device`` (default
``cuda``) and writes a read position's anchors by genome position
(``pipeline/debug.dump_anchors``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _cmd_samtom4(argv) -> int:
    p = argparse.ArgumentParser(prog="tools samtom4")
    p.add_argument("sam")
    p.add_argument("-out", default="-")
    p.add_argument("-header", action="store_true")
    args = p.parse_args(argv)

    from blasr_tpu_torch.io.sam import read_sam

    sam = read_sam(args.sam)
    ref_lens = sam.ref_lengths
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    if args.header:
        out.write(
            "qname tname score pctsimilarity qstrand qstart qend qseqlength "
            "tstrand tstart tend tseqlength mapqv ncells\n"
        )
    for rec in sam.records:
        if rec.is_unmapped:
            continue
        qstart, qend, tlen, qlen = rec.aligned_lengths()
        tstart = rec.pos - 1
        tend = tstart + tlen
        tlength = ref_lens.get(rec.rname, 0)
        score = int(rec.tags.get("AS", 0))
        nm = int(rec.tags.get("NM", 0))
        nmatch_est = sum(n for op, n in rec.cigar_runs() if op in "M=")
        denom = max(nmatch_est + nm, 1)
        pct = 100.0 * max(nmatch_est - nm, 0) / denom
        strand = 1 if rec.is_reverse else 0
        if strand == 1:
            # m4 convention: reverse-strand target interval in RC coords
            tstart, tend = tlength - tend, tlength - tstart
        out.write(
            f"{rec.qname} {rec.rname} {score} {pct:.4f} 0 {qstart} {qend} "
            f"{qlen} {strand} {tstart} {tend} {tlength} {rec.mapq} 0\n"
        )
    if out is not sys.stdout:
        out.close()
    return 0


def _cmd_samfilter(argv) -> int:
    p = argparse.ArgumentParser(prog="tools samfilter")
    p.add_argument("sam", help="SAM text (use samtom4/printgaps for .bam)")
    p.add_argument("-out", default="-")
    p.add_argument("-maxScore", type=int, default=0)
    p.add_argument("-minPctIdentity", type=float, default=0.0)
    p.add_argument("-minAlnLength", type=int, default=0)
    p.add_argument("-minMapQV", type=int, default=0)
    args = p.parse_args(argv)

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    from blasr_tpu_torch.io.sam import _CIGAR_RE  # reuse parse regex

    with open(args.sam) as f:
        for line in f:
            if line.startswith("@"):
                out.write(line)
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 11:
                continue
            flag = int(fields[1])
            if flag & 4:
                continue
            if int(fields[4]) < args.minMapQV:
                continue
            tags = dict(
                (t.split(":", 2)[0], t.split(":", 2)[2])
                for t in fields[11:]
                if t.count(":") >= 2
            )
            score = int(tags.get("AS", 0))
            if args.maxScore and score > args.maxScore:
                continue
            runs = [
                (op.decode(), int(n))
                for n, op in _CIGAR_RE.findall(fields[5].encode())
            ]
            aln_len = sum(n for op, n in runs if op in "M=XID")
            if aln_len < args.minAlnLength:
                continue
            nmatch = sum(n for op, n in runs if op in "M=")
            nm = int(tags.get("NM", 0))
            pct = 100.0 * max(nmatch - nm, 0) / max(nmatch + nm, 1)
            if pct < args.minPctIdentity:
                continue
            out.write(line)
    if out is not sys.stdout:
        out.close()
    return 0


def _cmd_ctab(argv) -> int:
    p = argparse.ArgumentParser(prog="tools ctab")
    p.add_argument("genome")
    p.add_argument("-wordsize", type=int, default=8)
    p.add_argument("-out", default="-", help="'-' prints text; else .npy")
    p.add_argument("-minCount", type=int, default=0,
                   help="print only k-mers with count > this")
    args = p.parse_args(argv)

    from blasr_tpu_torch.core.encode import codes_to_seq
    from blasr_tpu_torch.index.artifacts import build_count_table
    from blasr_tpu_torch.io.seqdb import load_genome

    genome, _ = load_genome(args.genome)
    counts = build_count_table(genome, args.wordsize)
    if args.out == "-":
        k = args.wordsize
        for key in np.flatnonzero(counts > args.minCount):
            codes = (key >> (2 * np.arange(k - 1, -1, -1))) & 3
            print(codes_to_seq(codes.astype(np.uint8)), int(counts[key]))
    else:
        np.save(args.out, counts)
        print(f"wrote {args.out}: 4^{args.wordsize} counts", file=sys.stderr)
    return 0


def _cmd_shredder(argv) -> int:
    p = argparse.ArgumentParser(prog="tools shredder")
    p.add_argument("genome")
    p.add_argument("-out", default="-")
    p.add_argument("-readLength", type=int, default=1000)
    p.add_argument("-coverage", type=float, default=1.0)
    p.add_argument("-seed", type=int, default=0)
    args = p.parse_args(argv)

    from blasr_tpu_torch.io.fasta import write_fasta
    from blasr_tpu_torch.io.seqdb import load_genome
    from blasr_tpu_torch.sim import shred_genome

    genome, seqdb = load_genome(args.genome)
    reads = shred_genome(
        genome, seqdb, args.readLength, args.coverage, seed=args.seed
    )
    if args.out == "-":
        from blasr_tpu_torch.core.encode import codes_to_seq

        for name, codes in reads:
            print(f">{name}")
            print(codes_to_seq(codes))
    else:
        write_fasta(args.out, reads)
    return 0


def _cmd_evolve(argv) -> int:
    p = argparse.ArgumentParser(prog="tools evolve")
    p.add_argument("genome")
    p.add_argument("-out", default="evolved.fasta")
    p.add_argument("-sub", type=float, default=0.01)
    p.add_argument("-ins", type=float, default=0.005)
    p.add_argument("-del", dest="dele", type=float, default=0.005)
    p.add_argument("-seed", type=int, default=0)
    args = p.parse_args(argv)

    from blasr_tpu_torch.io.fasta import read_fasta, write_fasta
    from blasr_tpu_torch.sim import evolve_sequence

    out_recs = []
    for name, codes in read_fasta(args.genome):
        mutated, _ = evolve_sequence(
            codes, args.sub, args.ins, args.dele, seed=args.seed
        )
        out_recs.append((name, mutated))
    write_fasta(args.out, out_recs)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


def _cmd_wordcount(argv) -> int:
    p = argparse.ArgumentParser(prog="tools wordcount")
    p.add_argument("fasta")
    p.add_argument("-wordsize", type=int, default=8)
    p.add_argument("-top", type=int, default=20)
    args = p.parse_args(argv)

    from blasr_tpu_torch.core.encode import codes_to_seq
    from blasr_tpu_torch.index.artifacts import build_count_table
    from blasr_tpu_torch.io.seqdb import load_genome

    genome, _ = load_genome(args.fasta)
    counts = build_count_table(genome, args.wordsize)
    top = np.argsort(counts)[::-1][: args.top]
    k = args.wordsize
    for key in top:
        if counts[key] == 0:
            break
        codes = (int(key) >> (2 * np.arange(k - 1, -1, -1))) & 3
        print(codes_to_seq(codes.astype(np.uint8)), int(counts[key]))
    return 0


def _cmd_exhalign(argv) -> int:
    """Brute-force optimal alignment of every read vs a genome region
    (role of gold_standard/ExhaustiveAlign.cpp)."""
    p = argparse.ArgumentParser(prog="tools exhalign")
    p.add_argument("reads")
    p.add_argument("genome")
    p.add_argument("-tstart", type=int, default=0)
    p.add_argument("-tend", type=int, default=0, help="0 = genome end")
    args = p.parse_args(argv)

    from blasr_tpu_torch.core.encode import revcomp_codes
    from blasr_tpu_torch.io.batching import read_records
    from blasr_tpu_torch.io.seqdb import load_genome
    from blasr_tpu_torch.oracle import local_affine_score
    from blasr_tpu_torch.ops.banded_align import AlignScores

    genome, _ = load_genome(args.genome)
    tend = args.tend or len(genome)
    region = genome[args.tstart : tend]
    sc = AlignScores()
    for r in read_records(args.reads):
        fwd = local_affine_score(r.codes, region, sc)
        rev = local_affine_score(revcomp_codes(r.codes), region, sc)
        strand = 0 if fwd <= rev else 1
        print(f"{r.name} {min(fwd, rev)} {strand}")
    return 0


def _cmd_alchemy(argv) -> int:
    """Simulate reads with a context-conditioned error model
    (role of simulator/Alchemy.cpp)."""
    p = argparse.ArgumentParser(prog="tools alchemy")
    p.add_argument("genome")
    p.add_argument("-model", default=None, help="ErrorModel JSON (default: PacBio-like)")
    p.add_argument("-nReads", type=int, default=100)
    p.add_argument("-out", default="-")
    p.add_argument("-fastq", action="store_true")
    p.add_argument("-seed", type=int, default=0)
    args = p.parse_args(argv)

    from blasr_tpu_torch.core.encode import codes_to_seq
    from blasr_tpu_torch.io.seqdb import load_genome
    from blasr_tpu_torch.sim import ErrorModel, simulate_reads_alchemy

    genome, _ = load_genome(args.genome)
    model = ErrorModel.load(args.model) if args.model else ErrorModel.default()
    reads, _ = simulate_reads_alchemy(genome, model, args.nReads, seed=args.seed)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    for r in reads:
        if args.fastq:
            out.write(f"@{r.name}\n{codes_to_seq(r.codes)}\n+\n")
            out.write((np.asarray(r.qual) + 33).astype(np.uint8).tobytes().decode() + "\n")
        else:
            out.write(f">{r.name}\n{codes_to_seq(r.codes)}\n")
    if out is not sys.stdout:
        out.close()
    return 0


def _cmd_build_error_model(argv) -> int:
    """Estimate an ErrorModel from aligned reads (StoreQualityByContext
    role)."""
    p = argparse.ArgumentParser(prog="tools buildErrorModel")
    p.add_argument("sam")
    p.add_argument("-out", default="model.json")
    args = p.parse_args(argv)

    from blasr_tpu_torch.sim import build_model_from_sam

    model = build_model_from_sam(args.sam)
    model.save(args.out)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


def _cmd_condense(argv) -> int:
    """Homopolymer-condense a FASTA (role of sequtils/Condense.cpp)."""
    p = argparse.ArgumentParser(prog="tools condense")
    p.add_argument("fasta")
    p.add_argument("-out", default="-")
    args = p.parse_args(argv)

    from blasr_tpu_torch.core.condense import condense
    from blasr_tpu_torch.core.encode import codes_to_seq
    from blasr_tpu_torch.io.fasta import read_fasta

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    for name, codes in read_fasta(args.fasta):
        cond, lengths, _ = condense(codes)
        out.write(f">{name} condensed={len(cond)} original={len(codes)}\n")
        out.write(codes_to_seq(cond) + "\n")
    if out is not sys.stdout:
        out.close()
    return 0


def _cmd_dotplot(argv) -> int:
    """Anchor dot plot data (role of alignment/DotPlot.cpp blDotPlot):
    per-read anchor (qpos, tpos, strand) triples, gnuplot/TSV-ready. The
    anchors are searched on ``-device``; a read position's hits come by
    genome position."""
    p = argparse.ArgumentParser(prog="tools dotplot")
    p.add_argument("reads")
    p.add_argument("genome")
    p.add_argument("-out", default="-")
    p.add_argument("-minMatch", type=int, default=14)
    p.add_argument("-device", default="cuda", help="torch device of the anchor search")
    args = p.parse_args(argv)

    from blasr_tpu_torch.index.artifacts import load_index
    from blasr_tpu_torch.io.batching import read_records
    from blasr_tpu_torch.params import MappingParams
    from blasr_tpu_torch.pipeline.debug import dump_anchors
    from blasr_tpu_torch.pipeline.mapper import require_device

    device = require_device(args.device)
    index = load_index(args.genome, k=args.minMatch)
    reads = read_records(args.reads)
    params = MappingParams(min_match_length=args.minMatch)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    out.write("# read strand qpos tpos nhits\n")
    dump_anchors(index, reads, params, out, device=device)
    if out is not sys.stdout:
        out.close()
    return 0


def _cmd_printgaps(argv) -> int:
    """Gap/SV extraction from SAM alignments.

    Role of reference ``samutils/PrintGaps.cpp`` (406 LoC): per alignment,
    emit every indel gap longer than -minGapLength as a GFF-like line

      tname  blasr  {deletion|insertion}  start,end  length  strand  0
      seq <bases>  qname  tname:start-end

    'deletion' = bases present in the target but not the read (CIGAR D,
    sequence from the genome); 'insertion' = extra read bases (CIGAR I,
    sequence from the read). -merge fuses same-type gaps separated by
    match blocks shorter than the given length (PrintGaps.cpp:190-220);
    -minqv and -F filter records like the reference flags.
    """
    p = argparse.ArgumentParser(prog="tools printgaps")
    p.add_argument("genome")
    p.add_argument("sam", nargs="+")
    p.add_argument("-out", default="-")
    p.add_argument("-minGapLength", type=int, default=100)
    p.add_argument("-minqv", type=int, default=0)
    p.add_argument("-F", type=int, default=0, dest="exclude_flag")
    p.add_argument("-merge", type=int, default=0)
    p.add_argument("-printGapFasta", default=None)
    args = p.parse_args(argv)

    from blasr_tpu_torch.core.encode import codes_to_seq, seq_to_codes
    from blasr_tpu_torch.io.fasta import read_fasta
    from blasr_tpu_torch.io.sam import read_sam

    genome = {name: codes for name, codes in read_fasta(args.genome)}
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    gap_fa = open(args.printGapFasta, "w") if args.printGapFasta else None

    OPQ = {"M": (1, 1), "=": (1, 1), "X": (1, 1), "I": (1, 0), "D": (0, 1),
           "S": (1, 0), "H": (0, 0), "N": (0, 1), "P": (0, 0)}
    for sam_path in args.sam:
        sam = read_sam(sam_path)
        for rec in sam.records:
            if rec.is_unmapped or rec.rname == "*" or rec.rname not in genome:
                continue
            if args.exclude_flag and (rec.flag & args.exclude_flag):
                continue
            if rec.mapq < args.minqv:
                continue
            tcodes = genome[rec.rname]
            qcodes = seq_to_codes(rec.seq.encode()) if rec.seq != "*" else None
            runs = rec.cigar_runs()
            # merge same-type gaps separated by short aligned blocks:
            # [gap, block<merge, gap] -> [block, fused gap]
            # (PrintGaps.cpp:190-220 block/gap fusion)
            if args.merge:
                merged: list[tuple[str, int]] = []
                for op, ln in runs:
                    if (
                        op in "ID" and len(merged) >= 2
                        and merged[-1][0] in "M=X"
                        and merged[-1][1] < args.merge
                        and merged[-2][0] == op
                    ):
                        _, blk_len = merged.pop()
                        _, gap_len = merged.pop()
                        merged.append(("M", blk_len))
                        merged.append((op, gap_len + ln))
                        continue
                    merged.append((op, ln))
                runs = merged
            qpos = 0
            tpos = rec.pos - 1
            strand = "-" if rec.is_reverse else "+"
            for op, ln in runs:
                dq, dt = OPQ.get(op, (0, 0))
                if op == "D" and ln > args.minGapLength:
                    seq = codes_to_seq(tcodes[tpos : tpos + ln])
                    out.write(
                        f"{rec.rname}\tblasr\tdeletion\t{tpos},{tpos + ln}\t"
                        f"{ln}\t{strand}\t0\tseq {seq}\t{rec.qname}\t"
                        f"{rec.rname}:{tpos}-{tpos + ln}\n"
                    )
                    if gap_fa:
                        gap_fa.write(f">{rec.rname}:{tpos}-{tpos+ln}\n{seq}\n")
                elif op == "I" and ln > args.minGapLength and qcodes is not None:
                    seq = codes_to_seq(qcodes[qpos : qpos + ln])
                    out.write(
                        f"{rec.rname}\tblasr\tinsertion\t{tpos},{tpos + ln}\t"
                        f"{ln}\t{strand}\t0\tseq {seq}\t{rec.qname}\t"
                        f"{rec.rname}:{tpos}-{tpos + ln}\n"
                    )
                    if gap_fa:
                        gap_fa.write(f">{rec.qname}:{qpos}-{qpos+ln}\n{seq}\n")
                qpos += dq * ln
                tpos += dt * ln
    if out is not sys.stdout:
        out.close()
    if gap_fa:
        gap_fa.close()
    return 0


def _cmd_svrealign(argv) -> int:
    """Consolidate fragmented SV gaps in SAM alignments.

    Role of reference ``samutils/SVRealigner.cpp:143-280``: when a long
    indel is split by the aligner into several gap runs separated by tiny
    match blocks, re-align the region so the SV becomes ONE clean gap. The
    reference smushes the interior blocks and fits them against the gap's
    prefix/suffix with two dense SWAligns; here the same contract is one
    ``onegap_align`` call (ops/onegap.py) — query across left+gap+right —
    which places the breakpoint optimally instead of prefix-or-suffix.
    Insertion SVs swap the roles (gap in the query) and invert I/D.
    """
    p = argparse.ArgumentParser(prog="tools svrealign")
    p.add_argument("genome")
    p.add_argument("sam")
    p.add_argument("-out", default="-")
    p.add_argument("-minGapLength", type=int, default=100)
    p.add_argument("-minMatch", type=int, default=10,
                   help="flanking match run that ends a gappy window")
    p.add_argument("-maxRealignLength", type=int, default=10000)
    args = p.parse_args(argv)

    import numpy as np

    from blasr_tpu_torch.core.encode import seq_to_codes
    from blasr_tpu_torch.io.fasta import read_fasta
    from blasr_tpu_torch.io.sam import SAMRecord
    from blasr_tpu_torch.ops.banded_align import AlignScores
    from blasr_tpu_torch.ops.onegap import onegap_align
    from blasr_tpu_torch.pipeline.traceback import OP_D, OP_I, OP_M

    genome = {name: codes for name, codes in read_fasta(args.genome)}
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    sc = AlignScores()
    OPQ = {"M": (1, 1), "=": (1, 1), "X": (1, 1), "I": (1, 0), "D": (0, 1),
           "S": (1, 0), "H": (0, 0), "N": (0, 1), "P": (0, 0)}

    def _ops_to_runs(ops):
        runs = []
        for op in ops:
            ch = "M" if op == OP_M else ("I" if op == OP_I else "D")
            if runs and runs[-1][0] == ch:
                runs[-1][1] += 1
            else:
                runs.append([ch, 1])
        return [(c, n) for c, n in runs]

    n_realigned = 0
    for line in open(args.sam):
        line = line.rstrip("\n")
        if not line or line.startswith("@"):
            out.write(line + "\n")
            continue
        f = line.split("\t")
        rec = SAMRecord(f[0], int(f[1]), f[2], int(f[3]), int(f[4]), f[5],
                        f[9], None, {})
        if rec.is_unmapped or rec.rname not in genome or rec.seq == "*":
            out.write(line + "\n")
            continue
        tcodes = genome[rec.rname]
        qcodes = seq_to_codes(rec.seq.encode())
        runs = rec.cigar_runs()
        anchors = [
            i for i, (op, ln) in enumerate(runs)
            if op in "M=X" and ln >= args.minMatch
        ]
        new_runs: list[tuple[str, int]] = []
        qpos = 0
        tpos = rec.pos - 1
        i = 0
        changed = False
        while i < len(runs):
            # find the gappy window ending at the next anchor
            if i in anchors or runs[i][0] in "SHNP":
                op, ln = runs[i]
                new_runs.append((op, ln))
                dq, dt = OPQ.get(op, (0, 0))
                qpos += dq * ln
                tpos += dt * ln
                i += 1
                continue
            j = i
            gap_total = 0
            n_gap_runs = 0
            while j < len(runs) and j not in anchors and runs[j][0] not in "SHNP":
                if runs[j][0] in "ID":
                    gap_total += runs[j][1]
                    n_gap_runs += 1
                j += 1
            qlen = sum(ln for op, ln in runs[i:j] if OPQ[op][0])
            tlen = sum(ln for op, ln in runs[i:j] if OPQ[op][1])
            if (
                gap_total < args.minGapLength or n_gap_runs < 2
                or max(qlen, tlen) >= args.maxRealignLength
            ):
                for op, ln in runs[i:j]:
                    new_runs.append((op, ln))
            else:
                qseg = qcodes[qpos : qpos + qlen]
                tseg = np.asarray(tcodes[tpos : tpos + tlen], np.uint8)
                # split the long side at its midpoint: the free gap must
                # cross the split, which a window-dominating SV always does;
                # left+distance(0)+right == full span keeps CIGAR lengths
                # exact
                if tlen >= qlen:
                    # deletion SV: one long gap in the target span
                    h = (tlen + 1) // 2
                    res = onegap_align(qseg, tseg[:h], tseg[h:], 0, sc)
                    seg_runs = _ops_to_runs(res.path.ops)
                else:
                    # insertion SV: gap lives in the query; swap and invert
                    h = (qlen + 1) // 2
                    res = onegap_align(tseg, qseg[:h], qseg[h:], 0, sc)
                    seg_runs = [
                        ("M" if c == "M" else ("I" if c == "D" else "D"), n)
                        for c, n in _ops_to_runs(res.path.ops)
                    ]
                new_runs.extend(seg_runs)
                changed = True
                n_realigned += 1
            qpos += qlen
            tpos += tlen
            i = j
        if changed:
            # fuse adjacent same-op runs from window boundaries
            fused: list[tuple[str, int]] = []
            for op, ln in new_runs:
                if fused and fused[-1][0] == op:
                    fused[-1] = (op, fused[-1][1] + ln)
                else:
                    fused.append((op, ln))
            f[5] = "".join(f"{ln}{op}" for op, ln in fused)
            out.write("\t".join(f) + "\n")
        else:
            out.write(line + "\n")
    print(f"realigned {n_realigned} gap window(s)", file=sys.stderr)
    if out is not sys.stdout:
        out.close()
    return 0


def _cmd_samtom0(argv) -> int:
    """SAM -> human-readable stick alignment (reference samutils/SamToM0.cpp:
    replay each record's CIGAR against the genome and print the m0 block
    layout via the framework's verbose printer)."""
    p = argparse.ArgumentParser(prog="tools samtom0")
    p.add_argument("sam")
    p.add_argument("genome")
    p.add_argument("-out", default="-")
    args = p.parse_args(argv)

    from blasr_tpu_torch.core.encode import codes_to_seq, seq_to_codes
    from blasr_tpu_torch.io.fasta import read_fasta
    from blasr_tpu_torch.io.sam import read_sam

    genome = {name: codes for name, codes in read_fasta(args.genome)}
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    sam = read_sam(args.sam)
    for rec in sam.records:
        if rec.is_unmapped or rec.rname not in genome or rec.seq == "*":
            continue
        tcodes = genome[rec.rname]
        qcodes = seq_to_codes(rec.seq.encode())
        qpos = 0
        tpos = rec.pos - 1
        qstr = []
        astr = []
        tstr = []
        for op, ln in rec.cigar_runs():
            if op in "M=X":
                for i in range(ln):
                    qc = codes_to_seq(qcodes[qpos + i : qpos + i + 1])
                    tc = codes_to_seq(tcodes[tpos + i : tpos + i + 1])
                    qstr.append(qc)
                    tstr.append(tc)
                    astr.append("|" if qc == tc else " ")
                qpos += ln
                tpos += ln
            elif op == "I":
                qstr.append(codes_to_seq(qcodes[qpos : qpos + ln]))
                tstr.append("-" * ln)
                astr.append(" " * ln)
                qpos += ln
            elif op in "DN":
                qstr.append("-" * ln)
                tstr.append(codes_to_seq(tcodes[tpos : tpos + ln]))
                astr.append(" " * ln)
                tpos += ln
            elif op in "SH":
                qpos += ln if op == "S" else 0
        q, a, t = "".join(qstr), "".join(astr), "".join(tstr)
        nm = a.count("|")
        out.write(
            f"{rec.qname} {rec.rname} {rec.pos - 1} "
            f"{'-' if rec.is_reverse else '+'} mapqv {rec.mapq}\n"
        )
        width = 50
        t0 = rec.pos - 1
        q0 = 0
        for ofs in range(0, len(q), width):
            out.write(f"  q: {q[ofs:ofs+width]}\n")
            out.write(f"     {a[ofs:ofs+width]}\n")
            out.write(f"  t: {t[ofs:ofs+width]}\n\n")
    if out is not sys.stdout:
        out.close()
    return 0


def _sam_ref_spans(sam_paths, unique: bool, min_mapq: int = 10):
    """Yield (SAMFile, record, ref_start, ref_end) for records passing the
    samutils primary/mapQV/subread-uniqueness filters shared by
    PrintCoverage.cpp:95-134 and PrintConsensus.cpp:98-117."""
    from blasr_tpu_torch.io.sam import read_sam

    def _read_number(name: str) -> str | None:
        # movie/zmw/qstart_qend -> the zmw field (PrintCoverage.cpp:27-49)
        a = name.find("/")
        if a < 0:
            return None
        b = name.find("/", a + 1)
        return name[a:b] if b >= 0 else None

    for sam_path in sam_paths:
        sam = read_sam(sam_path)
        prev_name = ""
        for rec in sam.records:
            if rec.is_unmapped or rec.rname == "*":
                continue
            if rec.flag & 256:          # secondary
                continue
            if rec.mapq < min_mapq:
                continue
            if unique and rec.qname != prev_name:
                rn, pn = _read_number(rec.qname), _read_number(prev_name)
                if rn is not None and rn == pn:
                    prev_name = rec.qname
                    continue
            prev_name = rec.qname
            tlen = sum(
                ln for op, ln in rec.cigar_runs() if op in "M=XDN"
            )
            yield sam, rec, rec.pos - 1, rec.pos - 1 + tlen


def _cmd_samcoverage(argv) -> int:
    """Binned reference coverage from SAM alignments.

    Role of reference ``samutils/PrintCoverage.cpp`` (225 LoC): count
    primary, mapQV>=10 alignments into per-reference bins of -bin bases,
    divide by bin size, and write one binary file per reference under
    -outDir: [binSize int32][length int32][counts uint32 x length]
    (PrintCoverage.cpp:51-61). -text writes a tsv instead.
    """
    p = argparse.ArgumentParser(prog="tools samcoverage")
    p.add_argument("-sam", nargs="+", required=True)
    p.add_argument("-outDir", required=True)
    p.add_argument("-bin", type=int, default=10, dest="bin_size")
    p.add_argument("-unique", action="store_true")
    p.add_argument("-text", action="store_true",
                   help="tsv (refname bin_start coverage) instead of binary")
    args = p.parse_args(argv)

    import os

    import numpy as np

    os.makedirs(args.outDir, exist_ok=True)
    counts: dict[str, np.ndarray] = {}
    for sam, rec, t0, t1 in _sam_ref_spans(args.sam, args.unique):
        if rec.rname not in counts:
            ln = sam.ref_lengths.get(rec.rname, 0)
            nb = ln // args.bin_size + (1 if ln % args.bin_size else 0) or 1
            counts[rec.rname] = np.zeros(nb, np.uint32)
        arr = counts[rec.rname]
        b0, b1 = t0 // args.bin_size, (max(t1 - 1, t0)) // args.bin_size
        b1 = min(b1, len(arr) - 1)
        # full bins get +binSize, edge bins the covered remainder — then
        # the final /binSize matches the reference's per-base increments
        for b in range(max(b0, 0), b1 + 1):
            lo = max(t0, b * args.bin_size)
            hi = min(t1, (b + 1) * args.bin_size)
            if hi > lo:
                arr[b] += hi - lo
    for name, arr in counts.items():
        arr //= args.bin_size
        path = os.path.join(args.outDir, name + (".tsv" if args.text else ".data"))
        if args.text:
            with open(path, "w") as f:
                for i, v in enumerate(arr):
                    f.write(f"{name}\t{i * args.bin_size}\t{v}\n")
        else:
            with open(path, "wb") as f:
                np.array([args.bin_size, len(arr)], np.int32).tofile(f)
                arr.astype(np.uint32).tofile(f)
    return 0


def _cmd_maxalignedread(argv) -> int:
    """Per-bin anchor-depth track from SAM alignments.

    Role of reference ``samutils/PrintMaxAlignedRead.cpp:77-141``
    (StoreLengths): at every covered reference position, keep the maximum
    over alignments of the distance to that alignment's NEARER end (how
    deeply the position is embedded in a read) — the support track SV
    callers use to tell well-anchored breakpoints from alignment tails;
    plus plain coverage counts. Output per reference under -outDir:
    [binSize int32][length int32][counts uint32 x length]
    [support uint32 x length] (WriteValues, :22-33). -text for tsv.
    """
    p = argparse.ArgumentParser(prog="tools maxalignedread")
    p.add_argument("-sam", nargs="+", required=True)
    p.add_argument("-outDir", required=True)
    p.add_argument("-bin", type=int, default=10, dest="bin_size")
    p.add_argument("-q", type=int, default=30, dest="min_mapq")
    p.add_argument("-l", type=int, default=0, dest="min_align_length")
    p.add_argument("-unique", action="store_true")
    p.add_argument("-text", action="store_true")
    args = p.parse_args(argv)

    import os

    import numpy as np

    os.makedirs(args.outDir, exist_ok=True)
    counts: dict[str, np.ndarray] = {}
    support: dict[str, np.ndarray] = {}
    bs = args.bin_size
    for sam, rec, t0, t1 in _sam_ref_spans(args.sam, args.unique,
                                           min_mapq=args.min_mapq):
        if t1 - t0 < args.min_align_length:
            continue
        if rec.rname not in counts:
            ln = sam.ref_lengths.get(rec.rname, 0)
            nb = ln // bs + (1 if ln % bs else 0) or 1
            counts[rec.rname] = np.zeros(nb, np.uint32)
            support[rec.rname] = np.zeros(nb, np.uint32)
        cnt = counts[rec.rname]
        sup = support[rec.rname]
        pos = np.arange(t0, min(t1, len(sup) * bs), dtype=np.int64)
        # distance to the nearer alignment end (PrintMaxAlignedRead.cpp
        # :126-133: first half measures from the start, second from the end)
        depth = np.minimum(pos - t0, t1 - pos).astype(np.uint32)
        bins = pos // bs
        np.maximum.at(sup, bins, depth)
        np.add.at(cnt, bins, 1)
    for name in counts:
        path = os.path.join(
            args.outDir, name + (".tsv" if args.text else ".data")
        )
        if args.text:
            with open(path, "w") as f:
                for i in range(len(counts[name])):
                    f.write(
                        f"{name}\t{i * bs}\t{counts[name][i]}\t"
                        f"{support[name][i]}\n"
                    )
        else:
            with open(path, "wb") as f:
                np.array([bs, len(counts[name])], np.int32).tofile(f)
                counts[name].astype(np.uint32).tofile(f)
                support[name].astype(np.uint32).tofile(f)
    return 0


def _cmd_samconsensus(argv) -> int:
    """Binned M/D/I event counts from SAM alignments.

    Role of reference ``samutils/PrintConsensus.cpp`` (245 LoC): per
    reference, three bin arrays — aligned-base count (CIGAR M), deleted-base
    count (D), inserted-base count (I credited to the bin of the insertion
    point) — written as [binSize int32][nCounts=3 int32][length int32]
    [3 x uint32 arrays] (PrintConsensus.cpp:50-65).
    """
    p = argparse.ArgumentParser(prog="tools samconsensus")
    p.add_argument("-sam", nargs="+", required=True)
    p.add_argument("-outDir", required=True)
    p.add_argument("-bin", type=int, default=10, dest="bin_size")
    p.add_argument("-unique", action="store_true")
    p.add_argument("-text", action="store_true")
    args = p.parse_args(argv)

    import os

    import numpy as np

    os.makedirs(args.outDir, exist_ok=True)
    counts: dict[str, np.ndarray] = {}
    for sam, rec, t0, _t1 in _sam_ref_spans(args.sam, args.unique):
        if rec.rname not in counts:
            ln = sam.ref_lengths.get(rec.rname, 0)
            nb = ln // args.bin_size + (1 if ln % args.bin_size else 0) or 1
            counts[rec.rname] = np.zeros((3, nb), np.uint32)
        arr = counts[rec.rname]
        nb = arr.shape[1]
        tpos = t0
        for op, ln in rec.cigar_runs():
            if op in "M=X" or op == "D":
                row = 1 if op == "D" else 0
                for i in range(ln):
                    b = tpos // args.bin_size
                    if 0 <= b < nb:
                        arr[row, b] += 1
                    tpos += 1
            elif op == "I":
                b = tpos // args.bin_size
                if 0 <= b < nb:
                    arr[2, b] += ln
            elif op == "N":
                tpos += ln
    for name, arr in counts.items():
        path = os.path.join(args.outDir, name + (".tsv" if args.text else ".data"))
        if args.text:
            with open(path, "w") as f:
                for i in range(arr.shape[1]):
                    f.write(
                        f"{name}\t{i * args.bin_size}\t{arr[0, i]}\t"
                        f"{arr[1, i]}\t{arr[2, i]}\n"
                    )
        else:
            with open(path, "wb") as f:
                np.array([args.bin_size, 3, arr.shape[1]], np.int32).tofile(f)
                arr.astype(np.uint32).tofile(f)
    return 0


def _cmd_onegap(argv) -> int:
    """One-gap (deletion SV) alignment of a query vs a target
    (role of alignment/OneGapAlign.cpp `oneGapAlign query target`):
    the target is split into left/right windows of <= query length and the
    whole query is aligned across one free long gap between them
    (OneGapAlignment.h:18). Prints the breakpoint and alignment."""
    p = argparse.ArgumentParser(prog="tools onegap")
    p.add_argument("query")
    p.add_argument("target")
    p.add_argument("-indel", type=int, default=5)
    args = p.parse_args(argv)

    from blasr_tpu_torch.io.batching import read_records
    from blasr_tpu_torch.ops.banded_align import AlignScores
    from blasr_tpu_torch.ops.onegap import onegap_align

    q = read_records(args.query)[0]
    t = read_records(args.target)[0]
    # window split per OneGapAlign.cpp:30-37
    ln = min(len(t.codes), len(q.codes))
    rn = min(len(t.codes) - ln, len(q.codes))
    left = t.codes[:ln]
    right = t.codes[len(t.codes) - rn :]
    distance = len(t.codes) - ln - rn
    sc = AlignScores(insertion=args.indel, deletion=args.indel)
    res = onegap_align(q.codes, left, right, distance, sc)
    cigar = "".join(f"{n}{c}" for c, n in res.path.cigar_runs())
    print(f"{q.name} {t.name} score {res.score} "
          f"gap t={res.gap_t_start} len={res.gap_len} at q={res.split_q}")
    print(cigar)
    return 0


def _sa_interval(genome, sa, pat) -> tuple[int, int]:
    """[lo, hi) rows of ``sa`` whose suffixes start with ``pat``
    (binary search with direct suffix compares; SAQuery role)."""
    n = len(sa)
    m = len(pat)

    def cmp_at(row: int) -> int:
        s = int(sa[row])
        seg = genome[s : s + m]
        if len(seg) < m:
            pad = np.full(m, -1, np.int16)
            pad[: len(seg)] = seg
            seg = pad
        seg = np.asarray(seg, np.int16)
        d = seg - pat.astype(np.int16)
        nz = np.flatnonzero(d)
        return 0 if nz.size == 0 else int(d[nz[0]])

    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) // 2
        if cmp_at(mid) < 0:
            lo = mid + 1
        else:
            hi = mid
    start = lo
    lo, hi = start, n
    while lo < hi:
        mid = (lo + hi) // 2
        if cmp_at(mid) <= 0:
            lo = mid + 1
        else:
            hi = mid
    return start, lo


def _cmd_saquery(argv) -> int:
    """Query a .sa for occurrences of each FASTA sequence
    (role of alignment/SAQuery.cpp `saquery ref sa queries`)."""
    p = argparse.ArgumentParser(prog="tools saquery")
    p.add_argument("genome")
    p.add_argument("sa", help=".sa (reference format) or .btidx.npz")
    p.add_argument("queries")
    p.add_argument("-print", dest="do_print", action="store_true")
    p.add_argument("-printCount", action="store_true")
    p.add_argument("-max", type=int, default=0)
    p.add_argument("-count", action="store_true")
    args = p.parse_args(argv)

    from blasr_tpu_torch.io.batching import read_records
    from blasr_tpu_torch.io.seqdb import load_genome

    genome, _ = load_genome(args.genome)
    sa = _load_any_sa(args.sa, len(genome))
    for r in read_records(args.queries):
        lo, hi = _sa_interval(genome, sa, r.codes)
        n = hi - lo
        if args.printCount or args.count:
            print(f"{r.name} {n}")
        if args.do_print and not args.count and (args.max == 0 or n <= args.max):
            for pos in sorted(int(sa[row]) for row in range(lo, hi)):
                print(pos)
    return 0


def _load_any_sa(path: str, genome_len: int) -> "np.ndarray":
    if path.endswith(".npz"):
        import numpy as _np

        z = _np.load(path)
        return z["sa"]
    from blasr_tpu_torch.index.safile import read_sa_file

    return read_sa_file(path, genome_len)


def _cmd_saprint(argv) -> int:
    """Dump suffix-array rows (role of alignment/SAPrinter.cpp:38-54:
    row count, then one position per line, optionally with 50 bases of
    the suffix)."""
    p = argparse.ArgumentParser(prog="tools saprint")
    p.add_argument("sa", help=".sa (reference format) or .btidx.npz")
    p.add_argument("-ps", metavar="GENOME", default=None,
                   help="print 50 bases of each suffix")
    p.add_argument("-limit", type=int, default=0, help="stop after N rows")
    args = p.parse_args(argv)

    from blasr_tpu_torch.core.encode import codes_to_seq
    from blasr_tpu_torch.io.seqdb import load_genome

    genome = None
    if args.ps:
        genome, _ = load_genome(args.ps)
    if args.sa.endswith(".npz"):
        sa = _load_any_sa(args.sa, 0)
    else:
        from blasr_tpu_torch.index.safile import read_sa_file

        sa = read_sa_file(args.sa)  # raw rows, sentinel included (SAPrinter.cpp:38)
    print(len(sa))
    n = len(sa) if args.limit == 0 else min(len(sa), args.limit)
    for i in range(n):
        pos = int(sa[i])
        if genome is not None:
            seq = codes_to_seq(genome[pos : pos + 50])
            print(f"{pos} {seq}")
        else:
            print(pos)
    return 0


def _cmd_masksequence(argv) -> int:
    """Mask genome regions to N (role of sequtils/MaskSequence.cpp -table
    mode: coordinate-pair tables; -reverse masks everything OUTSIDE)."""
    p = argparse.ArgumentParser(prog="tools masksequence")
    p.add_argument("genome")
    p.add_argument("table", help="lines: <contig> <start> <end> (0-based)")
    p.add_argument("out")
    p.add_argument("-reverse", action="store_true")
    args = p.parse_args(argv)

    from blasr_tpu_torch.core.encode import CODE_N
    from blasr_tpu_torch.io.fasta import read_fasta, write_fasta

    seqs = {name: codes.copy() for name, codes in read_fasta(args.genome)}
    masks = {name: np.zeros(len(c), bool) for name, c in seqs.items()}
    for line in open(args.table):
        f = line.split()
        if len(f) < 3 or f[0] not in masks:
            continue
        masks[f[0]][int(f[1]) : int(f[2])] = True
    out = []
    for name, codes in seqs.items():
        m = masks[name] if not args.reverse else ~masks[name]
        codes[m] = CODE_N
        out.append((name, codes))
    write_fasta(args.out, out)
    return 0


def _cmd_exciserepeats(argv) -> int:
    """Remove masked/listed regions from a sequence entirely
    (role of sequtils/ExciseRepeats.cpp, with a coordinate table instead
    of RepeatMasker .out parsing)."""
    p = argparse.ArgumentParser(prog="tools exciserepeats")
    p.add_argument("genome")
    p.add_argument("table", help="lines: <contig> <start> <end> (0-based)")
    p.add_argument("out")
    args = p.parse_args(argv)

    from blasr_tpu_torch.io.fasta import read_fasta, write_fasta

    spans: dict[str, list[tuple[int, int]]] = {}
    with open(args.table) as tf:
        for line in tf:
            f = line.split()
            if len(f) >= 3:
                spans.setdefault(f[0], []).append((int(f[1]), int(f[2])))
    out = []
    for name, codes in read_fasta(args.genome):
        keep = np.ones(len(codes), bool)
        for lo, hi in spans.get(name, ()):
            keep[lo:hi] = False
        out.append((name, codes[keep]))
    write_fasta(args.out, out)
    return 0


def _cmd_extractseq(argv) -> int:
    """Print a genome region (role of sequtils/ExtractSeq.cpp)."""
    p = argparse.ArgumentParser(prog="tools extractseq")
    p.add_argument("genome")
    p.add_argument("region", help="<contig>:<start>-<end> (0-based)")
    args = p.parse_args(argv)

    from blasr_tpu_torch.core.encode import codes_to_seq
    from blasr_tpu_torch.io.fasta import read_fasta

    name, _, span = args.region.rpartition(":")
    lo, hi = (int(x) for x in span.split("-"))
    for n, codes in read_fasta(args.genome):
        if n == name or n.split()[0] == name:
            print(f">{name}:{lo}-{hi}")
            print(codes_to_seq(codes[lo:hi]))
            return 0
    print(f"contig {name!r} not found", file=sys.stderr)
    return 1


def _cmd_revcomp(argv) -> int:
    """Reverse-complement every record
    (role of sequtils/ReverseComplement.cpp /
    PrintReverseComplements.cpp)."""
    p = argparse.ArgumentParser(prog="tools revcomp")
    p.add_argument("fasta")
    p.add_argument("-out", default="-")
    args = p.parse_args(argv)

    from blasr_tpu_torch.core.encode import codes_to_seq, revcomp_codes
    from blasr_tpu_torch.io.fasta import read_fasta, write_fasta

    recs = [(n, revcomp_codes(c)) for n, c in read_fasta(args.fasta)]
    if args.out == "-":
        for n, c in recs:
            print(f">{n}")
            print(codes_to_seq(c))
    else:
        write_fasta(args.out, recs)
    return 0


def _fit_adapter(ad: "np.ndarray", win: "np.ndarray"):
    """Fit-align ``ad`` fully inside ``win`` (free start/end in the window):
    returns (n_match, read_start, read_end). Row-sweep DP, maximizing
    the SMRT weights (match +5, mismatch -6, indel -3 — the maximization
    mirror of SMRTDistanceMatrix + the reference's -indel default). Note
    the reference's own 0.60 default sits near the random-DNA noise floor
    for a 45 bp adapter; 0.75+ discriminates cleanly."""
    La, Lw = len(ad), len(win)
    if La == 0 or Lw == 0:
        return 0, 0, 0
    NEG = -(10 ** 6)
    H = np.zeros(Lw + 1, np.int32)          # row 0: free start anywhere
    M = np.zeros(Lw + 1, np.int32)          # matches on best path
    S = np.arange(Lw + 1, dtype=np.int32)   # window start of best path
    for i in range(La):
        sub = np.where(win == ad[i], 5, -6).astype(np.int32)
        diag = H[:-1] + sub
        up = H[1:] - 3
        newH = np.empty(Lw + 1, np.int32)
        newM = np.empty(Lw + 1, np.int32)
        newS = np.empty(Lw + 1, np.int32)
        newH[0] = H[0] - 1
        newM[0] = M[0]
        newS[0] = S[0]
        take_d = diag >= up
        newH[1:] = np.where(take_d, diag, up)
        newM[1:] = np.where(take_d, M[:-1] + (sub > 0), M[1:])
        newS[1:] = np.where(take_d, S[:-1], S[1:])
        # in-row (deletion in adapter = skip window base) sequential pass
        acc = newH[0]
        accM = newM[0]
        accS = newS[0]
        for j in range(1, Lw + 1):
            if acc - 3 > newH[j]:
                newH[j] = acc - 3
                newM[j] = accM
                newS[j] = accS
            acc, accM, accS = newH[j], newM[j], newS[j]
        H, M, S = newH, newM, newS
    j = int(np.argmax(H))
    return int(M[j]), int(S[j]), j


def _cmd_removeadapters(argv) -> int:
    """Split SMRTBell reads at adapter hits (role of
    alignment/RemoveAdapters.cpp:13-105 SplitRead: fit-align both adapters
    into the read, split at the better hit when the match fraction clears
    -pctSim, recurse on both halves; passes below -minLength drop)."""
    p = argparse.ArgumentParser(prog="tools removeadapters")
    p.add_argument("-ad1", required=True)
    p.add_argument("-ad2", default=None)
    p.add_argument("-reads", required=True)
    p.add_argument("-readsout", required=True)
    p.add_argument("-pctSim", type=float, default=0.60)
    p.add_argument("-minLength", type=int, default=10)
    args = p.parse_args(argv)

    from blasr_tpu_torch.io.batching import read_records
    from blasr_tpu_torch.io.fasta import write_fasta

    ads = [read_records(args.ad1)[0].codes]
    if args.ad2:
        ads.append(read_records(args.ad2)[0].codes)

    def split(codes, lo, hi, out):
        if hi - lo < args.minLength:
            return
        best = None
        for ad in ads:
            nm, ws, we = _fit_adapter(ad, codes[lo:hi])
            if nm / max(len(ad), 1) >= args.pctSim:
                if best is None or nm > best[0]:
                    best = (nm, lo + ws, lo + we)
        if best is None:
            out.append((lo, hi))
            return
        _, a_lo, a_hi = best
        if a_hi <= a_lo:  # degenerate span: stop recursion
            out.append((lo, hi))
            return
        split(codes, lo, a_lo, out)
        split(codes, a_hi, hi, out)

    out_recs = []
    for r in read_records(args.reads):
        passes: list[tuple[int, int]] = []
        split(r.codes, 0, len(r.codes), passes)
        for i, (lo, hi) in enumerate(passes):
            if hi - lo >= args.minLength:
                print(f"read: {r.index} pass: {i} {lo} {hi - lo}")
                out_recs.append((f"{r.name}/{lo}_{hi}", r.codes[lo:hi]))
    write_fasta(args.readsout, out_recs)
    return 0


def _cmd_longestrepeat(argv) -> int:
    """Longest exact repeat in a genome (role of
    alignment/FindLongestRepeat.cpp:26-53: per-adjacent-SA-row character
    loops) — here one vectorized adjacent-LCP pass (index/lcp.py), the
    max of which IS the longest repeated substring length."""
    p = argparse.ArgumentParser(prog="tools longestrepeat")
    p.add_argument("genome")
    args = p.parse_args(argv)

    from blasr_tpu_torch.core.encode import codes_to_seq
    from blasr_tpu_torch.index.lcp import adjacent_lcp
    from blasr_tpu_torch.index.suffix_array import build_suffix_array
    from blasr_tpu_torch.io.fasta import read_fasta

    # N-spacered concatenation: cross-contig windows hit the spacer and
    # are clipped below, so no phantom repeats span contig boundaries but
    # repeats BETWEEN contigs are still found (ReadAllSequencesIntoOne
    # inserts the same spacer, FASTAReader.h:126-130)
    recs = read_fasta(args.genome)
    parts = []
    names = []
    offs = []
    pos = 0
    for name, codes in recs:
        names.append(name.split()[0])
        offs.append(pos)
        parts.append(codes)
        parts.append(np.full(1, 4, np.uint8))
        pos += len(codes) + 1
    genome = np.concatenate(parts)
    offs_arr = np.asarray(offs + [pos], np.int64)
    sa = build_suffix_array((genome & 3).astype(np.uint8))
    lcp = adjacent_lcp((genome & 3).astype(np.uint8), sa)
    # clip each pair's LCP at the first N in either suffix (the reference
    # skips N, FindLongestRepeat.cpp:32-34); vectorized suffix-min scan
    isn = genome >= 4
    if isn.any():
        idx = np.where(isn, np.arange(len(genome)), len(genome))
        next_n = np.minimum.accumulate(idx[::-1])[::-1]
        next_n = np.concatenate([next_n, [len(genome)]]).astype(np.int64)
        a = sa[:-1].astype(np.int64)
        b = sa[1:].astype(np.int64)
        cap = np.minimum(next_n[a] - a, next_n[b] - b)
        lcp = np.minimum(lcp, np.maximum(cap, 0))
    i = int(np.argmax(lcp))
    ln = int(lcp[i])

    def _loc(p):
        ci = int(np.searchsorted(offs_arr, p, side="right")) - 1
        return f"{names[ci]}:{p - offs_arr[ci]}"

    pa, pb = int(sa[i]), int(sa[i + 1])
    print(f"repeat length {ln} at {_loc(pa)} and {_loc(pb)}")
    if ln:
        print(codes_to_seq(genome[pa : pa + min(ln, 80)]))
    return 0


def _cmd_countnmers(argv) -> int:
    """Count unique (frequency-1) k-mers
    (role of sequtils/CountUniqueNMers.cpp: prints '<nUnique> <nKmers>')."""
    p = argparse.ArgumentParser(prog="tools countnmers")
    p.add_argument("fasta")
    p.add_argument("-wordsize", type=int, default=14)
    args = p.parse_args(argv)

    from blasr_tpu_torch.core.encode import pack_kmers
    from blasr_tpu_torch.io.fasta import read_fasta

    # N-spacered concatenation: no phantom k-mers across contig joins
    # (pack_kmers marks windows containing N invalid)
    parts = []
    for _, codes in read_fasta(args.fasta):
        parts.append(codes)
        parts.append(np.full(1, 4, np.uint8))
    genome = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    keys, valid = pack_kmers(genome, args.wordsize)
    kk = np.sort(keys[valid])
    if len(kk) == 0:
        print("0 0")
        return 0
    uniq, counts = np.unique(kk, return_counts=True)
    print(f"{int((counts == 1).sum())} {len(kk)}")
    return 0


def _cmd_extract_gff_sequences(argv) -> int:
    """Print the subsequences a GFF-style interval file names (role of
    gffutils/ExtractGFFSequences.cpp:7-59): each row is
    ``seqName dupType sim startPos endPos``; the sequence for ``seqName``
    is read from ``<seqDir>/<seqName>.fa`` and the [start, end) slice is
    emitted as a FASTA record titled ``<seqName>_<start>_<end>``."""
    p = argparse.ArgumentParser(prog="tools extractGFFSequences")
    p.add_argument("gff")
    p.add_argument("seqdir", nargs="?", default=".")
    args = p.parse_args(argv)

    from blasr_tpu_torch.core.encode import codes_to_seq
    from blasr_tpu_torch.io.fasta import read_fasta

    cur_name, cur_codes = None, None
    for line in open(args.gff):
        f = line.split()
        if len(f) < 5:
            continue
        seq_name, start, end = f[0], int(f[3]), int(f[4])
        if seq_name != cur_name:
            cur_name = seq_name
            cur_codes = read_fasta(os.path.join(args.seqdir, seq_name + ".fa"))[0][1]
        print(f">{seq_name}_{start}_{end}")
        print(codes_to_seq(cur_codes[start:end]))
    return 0


def _cmd_match_gtf_exons(argv) -> int:
    """Match alignment intervals against a GENCODE GTF exon database (role
    of cdna/MatchGTFExons.cpp:32-124 + common/cdna/GTFDB.h): for each
    alignment row (gff3 or -m4 format; m4 reverse-strand rows are flipped
    to forward coordinates like MatchGTFExons.cpp:76-80), report the
    best-overlap GTF entry (percent overlap of the interval union) or
    ``*** NO MATCHES ***``. Overlap search here is a correct sorted
    interval scan (the reference's lower_bound walk misses entries that
    start more than one slot before the query; same output on its
    intended inputs)."""
    p = argparse.ArgumentParser(prog="tools matchGTFExons")
    p.add_argument("align_file")
    p.add_argument("gtf")
    p.add_argument("-format", default="gff3", choices=["gff3", "m4"])
    args = p.parse_args(argv)

    import bisect
    import collections
    import re as _re

    db = collections.defaultdict(list)  # chr -> [(start, end, type, gene, tid)]
    for line in open(args.gtf):
        if not line.strip() or line[0] == "#":
            continue
        f = line.split("\t") if "\t" in line else line.split(None, 8)
        if len(f) < 9:
            continue
        chrom, _src, ltype, start, end = f[0], f[1], f[2], int(f[3]), int(f[4])
        attrs = dict(_re.findall(r'(\w+) "([^"]*)"', f[8]))
        db[chrom].append(
            (start, end, ltype, attrs.get("gene_name", ""),
             attrs.get("transcript_id", ""))
        )
    for chrom in db:
        db[chrom].sort()
    starts = {c: [e[0] for e in v] for c, v in db.items()}

    for line in open(args.align_file):
        line = line.rstrip("\n")
        if not line.strip() or line[0] == "#":
            continue
        f = line.split()
        if args.format == "gff3":
            chrom, ltype = f[0], f[2]
            if ltype in ("gene", "mRNA"):
                continue
            a_start, a_end = int(f[3]), int(f[4])
        else:
            chrom = f[1]
            strand = int(f[8])
            a_start, a_end, tlen = int(f[9]), int(f[10]), int(f[11])
            if strand == 1:
                a_start, a_end = tlen - a_end, tlen - a_start + 1
        entries = db.get(chrom, [])
        print(f"searching for {chrom} {a_start} {a_end}")
        best, best_ov = None, 0
        lo = bisect.bisect_right(starts.get(chrom, []), a_end)
        for e in entries[:lo]:
            if e[1] < a_start:
                continue
            ov_s, ov_e = max(a_start, e[0]), min(a_end, e[1])
            u_s, u_e = min(a_start, e[0]), max(a_end, e[1])
            if ov_e < ov_s or a_end <= a_start or u_e <= u_s:
                ov = 0
            else:
                ov = 100 * (ov_e - ov_s) / (u_e - u_s)
            if ov > best_ov:
                best, best_ov = e, int(ov)
        if best is None or best_ov == 0:
            print(line)
            print("   *** NO MATCHES ***")
        else:
            print(f" {best_ov} match {chrom} {best[0]} {best[1]} {best[2]} "
                  f"{best[3]} {best[4]}")
    return 0


COMMANDS = {
    "samtom4": _cmd_samtom4,
    "onegap": _cmd_onegap,
    "masksequence": _cmd_masksequence,
    "exciserepeats": _cmd_exciserepeats,
    "extractseq": _cmd_extractseq,
    "revcomp": _cmd_revcomp,
    "countnmers": _cmd_countnmers,
    "longestrepeat": _cmd_longestrepeat,
    "removeadapters": _cmd_removeadapters,
    "saquery": _cmd_saquery,
    "saprint": _cmd_saprint,
    "svrealign": _cmd_svrealign,
    "samcoverage": _cmd_samcoverage,
    "samconsensus": _cmd_samconsensus,
    "maxalignedread": _cmd_maxalignedread,
    "printgaps": _cmd_printgaps,
    "samtom0": _cmd_samtom0,
    "samfilter": _cmd_samfilter,
    "ctab": _cmd_ctab,
    "shredder": _cmd_shredder,
    "evolve": _cmd_evolve,
    "wordcount": _cmd_wordcount,
    "exhalign": _cmd_exhalign,
    "alchemy": _cmd_alchemy,
    "buildErrorModel": _cmd_build_error_model,
    "condense": _cmd_condense,
    "dotplot": _cmd_dotplot,
    "extractGFFSequences": _cmd_extract_gff_sequences,
    "matchGTFExons": _cmd_match_gtf_exons,
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m blasr_tpu_torch.cli.tools {{{','.join(COMMANDS)}}} ...",
              file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
