"""SAM output (L6); the port's copy of ``blasr_tpu/output/sam_writer.py``.

Role of reference ``printers/SAMPrinter.h`` (flag building :30-51, clipping
modes :59-102, CIGAR emission with X/= ops :120-260, PrintAlignment tag set
:419-545) and the header emission in main() (Blasr.cpp:4628-4700 @RG per
movie, MakeSAMHDString/MakeSAMPGString Blasr.cpp:284-297).

Reference conventions reproduced here:
  - For FASTA/FASTQ input the "movie name" is the input FILE NAME
    (ReaderAgglomerate.h:119-126) and the read-group id is the first 10 hex
    chars of its MD5 (ReaderAgglomerate.h:209-211).
  - CIGAR match blocks are split into X (mismatch) and = (match) runs
    (SAMPrinter.h AddUngappedOperations); clips are S (soft) or H (hard).
  - RNEXT/PNEXT are always */0 (SAMPrinter.h:455-462 prints literal values);
    TLEN is the genomic span (SAMPrinter.h:464-466).
  - SEQ is reverse-complemented when FLAG 16 is set.

The lines are the JAX package's, byte for byte, with one repair:
``write_sam`` finds a record's read by stream index (``records_by_read``),
where the JAX writer takes the record's stream index for a position in
``reads``; under a read selector (``-start``, ``-stride``, ...) the JAX
writer puts a record under another read's SEQ. Its two routes to a CIGAR
are kept: a record whose path carries the walk's packed move string
(each record of a mapped batch, refined secondaries too) goes through
``native.sam_fields`` (CIGAR, SEQ and QUAL in one pass); a record whose
path carries only ops (one stitched from segments, the JAX package's
SDP-block secondaries) goes through ``native.xeq_cigar``. Both run the C++
helpers, with their plain versions behind them, so the JAX writer's numpy
CIGAR route (``_xeq_runs``, which runs there only without its library)
has no caller here and is not copied. The @PG line is the JAX package's text, ``blasr_tpu`` as its ID
and PN included, with the command line as its CL (``program_line``, the
port's name when none is given): the port's header is the JAX package's
but for the command line.
"""

from __future__ import annotations

import hashlib
from typing import IO, Iterable, Optional, Sequence

import numpy as np

from blasr_tpu_torch import native
from blasr_tpu_torch.core.encode import codes_to_seq, revcomp_codes
from blasr_tpu_torch.io.batching import Read
from blasr_tpu_torch.io.seqdb import SeqDB
from blasr_tpu_torch.output.m4 import ref_qname
from blasr_tpu_torch.pipeline.runner import AlignmentRecord

FLAG_UNMAPPED = 4
FLAG_REVERSE = 16
FLAG_SECONDARY = 256


def read_group_id(movie_name: str) -> str:
    """First 10 hex chars of MD5(movie) — ReaderAgglomerate.h:211."""
    return hashlib.md5(movie_name.encode()).hexdigest()[:10]


def chip_id_of(movie_name: str) -> str:
    """Tokenize movie on '_': 1 field -> itself, >4 -> field 3, else
    NO_CHIP_ID (Blasr.cpp:299-311 ParseChipIdFromMovieName)."""
    fields = movie_name.split("_")
    if len(fields) == 1:
        return fields[0]
    if len(fields) > 4:
        return fields[3]
    return "NO_CHIP_ID"


def sam_header(
    seqdb: SeqDB,
    program_line: str = "blasr_tpu_torch",
    movie_names: Sequence[str] = ("default",),
) -> list[str]:
    lines = ["@HD\tVN:1.5\tpb:3.0.1"]
    seen = set()
    for movie in movie_names:
        if movie in seen:
            continue
        seen.add(movie)
        lines.append(
            "@RG\tID:{}\tPU:{}\tSM:{}\tPL:PACBIO\tDS:READTYPE=SUBREAD;"
            "CHANGELISTID=;BINDINGKIT=;SEQUENCINGKIT=;FRAMERATEHZ=100;"
            "BASECALLERVERSION=;InsertionQV=iq;DeletionQV=dq;"
            "SubstitutionQV=sq;MergeQV=mq;SubstitutionTag=st;"
            "DeletionTag=dt;Ipd=ip".format(
                read_group_id(movie), movie, chip_id_of(movie)
            )
        )
    lines.extend(seqdb.sam_sq_lines())
    lines.append(f"@PG\tID:blasr_tpu\tPN:blasr_tpu\tVN:2.0\tCL:{program_line}")
    return lines


def _cigar_string(
    rec: AlignmentRecord,
    read_len: int,
    clipping: str,
    q_aln: np.ndarray | None,
    t_aln: np.ndarray | None,
) -> str:
    path = rec.path
    assert path is not None
    pre = path.q_start
    post = read_len - path.q_end
    # "subread" clips to the subread region (SAMPrinter.h:81-84); without
    # region tables (HDF5-only) the subread IS the whole read, so it
    # behaves as soft clipping here
    clip_op = "S" if clipping in ("soft", "subread") else "H"
    ops = np.asarray(path.ops)
    if q_aln is not None and t_aln is not None:
        clipped = clipping != "none"
        return native.xeq_cigar(
            ops, q_aln, t_aln, path.q_start, path.t_start,
            pre if clipped else 0, post if clipped else 0, clip_op,
        )
    parts = []
    if pre and clipping != "none":
        parts.append(f"{pre}{clip_op}")
    parts.extend(f"{ln}{op}" for op, ln in path.cigar_runs())
    if post and clipping != "none":
        parts.append(f"{post}{clip_op}")
    return "".join(parts)


def _parse_zmw(name: str) -> int:
    """PacBio read names are movie/holeNumber/qs_qe; return holeNumber, or
    -1 like the reference's unset SMRTSequence.holeNumber for FASTA input."""
    parts = name.split("/")
    if len(parts) >= 2 and parts[1].isdigit():
        return int(parts[1])
    return -1


def format_sam_record(
    rec: AlignmentRecord,
    read: Read,
    clipping: str = "soft",
    rgid: str = "default",
    genome: np.ndarray | None = None,
    genome_start: int = 0,
    is_primary: bool = True,
    samqv: tuple | None = None,
) -> str:
    n = len(read.codes)
    flag = FLAG_REVERSE if rec.tstrand else 0
    if not is_primary:
        flag |= FLAG_SECONDARY
    pos = rec.tstart_fwd + 1  # 1-based
    p = rec.path
    t_aln = None
    if genome is not None:
        # forward-genome window positioned so that path-local t coords index
        # it directly (t_start maps to contig-forward tstart_fwd)
        w0 = genome_start + rec.tstart_fwd - p.t_start
        lo = max(w0, 0)
        t_aln = genome[lo : w0 + p.t_end]
        if w0 < 0:  # window head clipped; pad to keep local indexing
            t_aln = np.concatenate([np.full(-w0, 5, np.uint8), t_aln])
    if t_aln is not None and p.packed is not None:
        # hot path: ONE native pass over the packed walk output produces
        # CIGAR + SEQ + QUAL (orientation, clipping, =/X splitting all in C)
        cigar, seq, qual_s = native.sam_fields(
            p.packed, p.packed_nops, p.q_start, p.t_start,
            read.codes, read.qual, t_aln, rec.tstrand,
            0 if clipping == "none" else (2 if clipping == "hard" else 1),
            "S" if clipping in ("soft", "subread") else "H",
        )
    else:
        codes = read.codes if rec.tstrand == 0 else revcomp_codes(read.codes)
        qual = read.qual
        if qual is not None and rec.tstrand == 1:
            qual = qual[::-1]
        cigar = _cigar_string(
            rec, n, clipping, codes if t_aln is not None else None, t_aln
        )
        if clipping == "hard":
            codes = codes[p.q_start : p.q_end]
            if qual is not None:
                qual = qual[p.q_start : p.q_end]
        seq = codes_to_seq(codes)
        qual_s = (
            "*" if qual is None
            else (np.asarray(qual) + 33).astype(np.uint8).tobytes().decode()
        )
    # XS/XE are the HARD-clip bounds + 1, not the aligned span
    # (SAMPrinter.h:506-520: xs = prefixHardClip + 1, xe = len - suffix + 1);
    # with soft clipping and no low-quality regions that is 1 .. len+1.
    if clipping == "hard":
        xs = (p.q_start if rec.tstrand == 0 else n - p.q_end) + 1
        xe = (p.q_end if rec.tstrand == 0 else n - p.q_start) + 1
    elif clipping == "none":
        xs, xe = p.q_start + 1, p.q_end + 1
    else:
        xs, xe = 1, n + 1
    # NM is the real edit distance here; the reference leaves context.editDist
    # at 0 for FASTA input (observed: NM:i:0 on every record) — a bug we do
    # not reproduce.
    nm = p.n_mismatch + p.n_ins + p.n_del
    tags = [
        f"RG:Z:{rgid}",
        f"AS:i:{rec.score}",
        f"XS:i:{xs}",
        f"XE:i:{xe}",
    ]
    if clipping in ("soft", "subread", "hard"):
        # read.qs/qe (SMRTSequence subread bounds; 1..len+1 for whole reads)
        tags += [f"qs:i:{1}", f"qe:i:{n + 1}"]
    if read.qvs:
        # echo supplemental QV tracks (SAMPrinter.h:534-549 /
        # SAMSupplementalQVList::PrintQVOptionalFields): oriented with the
        # emitted SEQ and clipped like it
        use = samqv if samqv is not None else ("iq", "dq", "sq", "mq", "st", "dt")
        for tag in use:
            tr = read.qvs.get(tag)
            if tr is None or len(tr) != n:
                continue
            if rec.tstrand == 1:
                tr = revcomp_codes(tr) if tag in ("st", "dt") else tr[::-1]
            if clipping == "hard":
                tr = tr[p.q_start : p.q_end]
            if tag in ("st", "dt"):
                tags.append(f"{tag}:Z:{codes_to_seq(tr)}")
            else:
                s = (np.minimum(np.asarray(tr), 93) + 33).astype(np.uint8)
                tags.append(f"{tag}:Z:{s.tobytes().decode()}")
    tags += [
        f"zm:i:{_parse_zmw(rec.qname)}",
        f"XL:i:{p.q_end - p.q_start}",
        "XT:i:1",
        f"NM:i:{nm}",
        f"FI:i:{p.q_start + 1}",
        f"XQ:i:{rec.qlength}",
        "rq:f:0",
        "np:i:0",
        "cx:i:0",
        "sn:B:f,0,0,0,0",
    ]
    fields = [
        ref_qname(rec.qname, rec.qlength),
        str(flag),
        rec.tname,
        str(pos),
        str(rec.mapqv),
        cigar,
        "*",                                  # RNEXT (SAMPrinter.h:455)
        "0",                                  # PNEXT (SAMPrinter.h:459)
        str(rec.tend_fwd - rec.tstart_fwd),   # TLEN = genomic span (:464)
        seq,
        qual_s,
    ] + tags
    return "\t".join(fields)


def format_unmapped(read: Read, rgid: str = "default") -> str:
    qual_s = "*" if read.qual is None else (np.asarray(read.qual) + 33).astype(np.uint8).tobytes().decode()
    return "\t".join(
        [read.name, str(FLAG_UNMAPPED), "*", "0", "0", "*", "*", "0", "0",
         codes_to_seq(read.codes), qual_s, f"RG:Z:{rgid}"]
    )


def records_by_read(
    records: Iterable[AlignmentRecord], reads: Sequence[Read]
) -> dict[int, list[AlignmentRecord]]:
    """Each read's records, keyed by the read's position in ``reads``. A
    record's ``read_index`` is its read's stream index (``Read.index``),
    which a read selector sets apart from the position; a record whose
    index is unset (negative) or names none of ``reads`` falls back to its
    name (the first read of that name), and one that matches neither is
    left out."""
    pos_of_index: dict[int, int] = {}
    pos_of_name: dict[str, int] = {}
    for i, r in enumerate(reads):
        if r.index >= 0:
            pos_of_index.setdefault(r.index, i)
        pos_of_name.setdefault(r.name, i)
    by_read: dict[int, list[AlignmentRecord]] = {}
    for rec in records:
        i = pos_of_index.get(rec.read_index) if rec.read_index >= 0 else None
        if i is None:
            i = pos_of_name.get(rec.qname)
            if i is None:
                continue
        by_read.setdefault(i, []).append(rec)
    return by_read


def format_read_records(
    recs: Sequence[AlignmentRecord], read: Read, seqdb: SeqDB, clipping: str,
    rgid: str, genome: np.ndarray | None, samqv: tuple | None,
) -> list[str]:
    """The SAM lines of one read's records, its best-scoring record primary."""
    best = min(range(len(recs)), key=lambda j: recs[j].score)
    return [
        format_sam_record(
            rec, read, clipping, rgid=rgid, genome=genome,
            genome_start=int(seqdb.starts[rec.contig_index]) if rec.contig_index >= 0 else 0,
            is_primary=(j == best), samqv=samqv,
        )
        for j, rec in enumerate(recs)
    ]


def write_sam(
    records: Iterable[AlignmentRecord],
    reads: Sequence[Read],
    seqdb: SeqDB,
    out: IO[str],
    clipping: str = "soft",
    program_line: str = "blasr_tpu_torch",
    unmapped: Optional[Sequence[str]] = None,
    movie_name: str = "default",
    genome: np.ndarray | None = None,
    print_unmapped: bool = True,
    samqv: tuple | None = None,
) -> None:
    for line in sam_header(seqdb, program_line, [movie_name]):
        out.write(line + "\n")
    rgid = read_group_id(movie_name)
    # records keyed by read, not by name (duplicate read names are legal in
    # FASTA; keying by name would silently drop records)
    by_read = records_by_read(records, reads)
    unmapped_set = set(unmapped or ())
    for idx, rd in enumerate(reads):
        recs = by_read.get(idx)
        if recs:
            for line in format_read_records(recs, rd, seqdb, clipping, rgid, genome, samqv):
                out.write(line + "\n")
        elif print_unmapped and rd.name in unmapped_set:
            out.write(format_unmapped(rd, rgid=rgid) + "\n")
