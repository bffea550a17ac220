"""Records of the port that the secondary refinement made, held to the
benchmark's plain reference (``portbench/reference/align.py``).

At ``best_n > 1`` a secondary whose SDP chain's span disagrees with its
DP's is refined along the chain (``pipeline/secondary._refine_secondaries``);
the JAX package emits the chain's SDP blocks there instead, so the two
packages differ on exactly those records. Tests compare every other
record with the JAX package (``untouched``) and hold each refined one to
the reference (``check_records``): its CIGAR consumes the read between
its clips and its genome span, SEQ is the read, the CIGAR scores exactly
its AS, and no alignment of its own spans scores better.
"""

import io

import numpy as np

from blasr_tpu_torch.core.encode import codes_to_seq, revcomp_codes
from blasr_tpu_torch.output.sam_writer import write_sam
from portbench.reference.align import cigar_score, span_optimum
from portbench.reference.outputs import parse_sam, read_name

# the stated scoring of the port's defaults (MappingParams), phred-scaled
SCORING = dict(match=-5, mismatch=6, n_score=0, insertion=5, deletion=5,
               affine_open=50, affine_extend=0, qv_scaled=True)


def untouched(jrec, trec):
    """(the JAX package's records less those it emits from SDP blocks, the
    port's records less the refined ones, the refined ones), in order."""
    jkeep = [r for r in jrec if r.path is None or r.path.packed is not None]
    tkeep = [r for r in trec if not r.refined]
    return jkeep, tkeep, [r for r in trec if r.refined]


def check_records(records, reads, index, scoring=SCORING) -> dict:
    """``records`` (the refined ones, or any) written as soft-clipped SAM
    by the port's writer, each held to the plain reference: ``n`` records,
    ``path_off`` (CIGAR, SEQ or AS not consistent with the read and the
    genome) and ``score_off`` / ``below`` (AS other than / better than the
    best score over its own query and genome spans)."""
    buf = io.StringIO()
    write_sam(records, reads, index.seqdb, buf, clipping="soft", genome=index.genome)
    by_name = {r.name: r for r in reads}
    contig = {name: int(s) for name, s in zip(index.seqdb.names, index.seqdb.starts)}
    rnames = {}
    for line in buf.getvalue().splitlines():
        f = line.split("\t")
        if not line.startswith("@") and not int(f[1]) & 4:
            rnames.setdefault(read_name(f[0]), []).append(f[2])
    items, reported, path_off = [], [], 0
    for name, recs in parse_sam(buf.getvalue()).items():
        read = by_name[name]
        for r, rname in zip(recs, rnames[name]):
            codes = revcomp_codes(read.codes) if r["strand"] else read.codes
            qual = None if read.qual is None else (read.qual[::-1] if r["strand"] else read.qual)
            cig = r["cigar"]
            left = cig[0][1] if cig[0][0] == "S" else 0
            right = cig[-1][1] if len(cig) > 1 and cig[-1][0] == "S" else 0
            q0, q1 = left, len(codes) - right
            t0 = contig[rname] + r["pos"]
            t1 = t0 + sum(n for op, n in cig if op in "M=XD")
            q, t = codes[q0:q1], index.genome[t0:t1]
            qq = None if qual is None else np.asarray(qual[q0:q1])
            got = cigar_score([c for c in cig if c[0] not in "SH"], q, t, qq, scoring)
            if got is None or got != r["score"] or r["seq"] != codes_to_seq(codes):
                path_off += 1
            items.append((q, t, qq))
            reported.append(r["score"])
    best = span_optimum(items, scoring) if items else []
    return {"n": len(items), "path_off": path_off,
            "score_off": sum(s != b for s, b in zip(reported, best)),
            "below": sum(s < b for s, b in zip(reported, best))}
