"""The check that decides ``correct``: what the window's run_mapping and
writer produced, held to the plain reference.

Numbers compared (each with its limit from ``checks/<workload>.json``):

- ``missing_reads``: reads of the window's chunks that got neither a
  record nor a report as unmapped (an answer that never came). An
  unmapped read is an answer: it lowers ``true_locus_pct`` instead.
- ``locus_off_pct``: the share of the window's reads (each distinct
  chunk once) whose best record is not on the true strand within 100 bp
  of the simulated start and end, from the output text against the
  truth each read's name carries. A read reported unmapped, or left
  out, counts as off. It holds the placement itself: a record at a
  wrong locus or strand can be aligned optimally there, which
  ``score_off_pct`` cannot see.
- ``score_off_pct``: of a sample of the mapped reads drawn from the seed
  (the longest read always in it), the share whose reported score is not
  the best score of any alignment of the record's own query span against
  its own genome span under the configuration's stated scoring
  (``reference/align.span_optimum``). The port's DP is banded, so a path
  that the band clipped reads as off: that is the lower reading's cause.
- ``path_off`` (SAM only): sampled records whose CIGAR does not consume
  the read between its clips and the genome span, whose SEQ is not the
  read as aligned, or whose CIGAR scores other than its AS tag
  (``reference/align.cigar_score``).

The reference takes the genome and the reads the harness made, and the
program's output text; nothing the program derived.
"""

from __future__ import annotations

import numpy as np

from portbench.generators import codes_to_bytes, parse_truth, revcomp_codes
from portbench.reference.align import cigar_score, span_optimum
from portbench.reference.outputs import parse_m4, parse_sam


def sample_names(mapped: list[str], lengths: dict, k: int, seed: int) -> list[str]:
    """``k`` mapped read names drawn from ``seed``, the longest among them."""
    if not mapped:
        return []
    longest = max(mapped, key=lambda n: (lengths[n], n))
    rest = sorted(n for n in mapped if n != longest)
    rng = np.random.default_rng([seed & (2**63 - 1), 7])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if k > 1 else []
    return [longest] + [rest[i] for i in sorted(pick)]


def _forward_span(fmt: str, r: dict) -> tuple[int, int]:
    if fmt == "sam":
        return r["pos"], r["pos"] + sum(ln for op, ln in r["cigar"] if op in "M=XD")
    return r["tstart"], r["tend"]


def _best(fmt: str, rs: list[dict]) -> dict:
    """A read's best record: in SAM its primary line, else the first with
    the lowest score."""
    if fmt == "sam":
        primary = [r for r in rs if not r["flag"] & (256 | 2048)]
        if primary:
            return primary[0]
    return min(rs, key=lambda r: r["score"])


def locus_off_pct(fmt: str, recs: dict, names: list[str]) -> float:
    """Of ``names``, the share whose best record misses the true strand or
    lies 100 bp or more from the true start or end."""
    off = 0
    for name in names:
        rs = recs.get(name)
        if not rs:
            off += 1
            continue
        r = _best(fmt, rs)
        start, end, strand = parse_truth(name)
        t0, t1 = _forward_span(fmt, r)
        if r["strand"] != strand or abs(t0 - start) >= 100 or abs(t1 - end) >= 100:
            off += 1
    return 100.0 * off / max(len(names), 1)


def judge(fmt: str, texts: list[str], names: list[str], reads: dict, genome: np.ndarray,
          scoring: dict, sample: int, seed: int, missing: int, device: str = "cpu") -> dict:
    """The numbers compared: ``texts`` the output of each distinct chunk,
    ``names`` those chunks' reads, ``reads`` name -> (codes, qual)."""
    parse = parse_sam if fmt == "sam" else parse_m4
    recs: dict[str, list[dict]] = {}
    for t in texts:
        recs.update(parse(t))
    lengths = {n: len(reads[n][0]) for n in recs if n in reads}
    picked = sample_names(sorted(lengths), lengths, sample, seed)
    items, reported, seen = [], [], []
    path_off = 0
    for name in picked:
        codes, qual = reads[name]
        for r in recs[name]:
            q, qq, t, ok = _spans(fmt, r, codes, qual, genome)
            note = {"read": name, "strand": r["strand"], "reported": r["score"],
                    "read_len": len(codes), "query_span": len(q), "genome_span": len(t)}
            if fmt == "sam":
                got = cigar_score([c for c in r["cigar"] if c[0] not in "SH"], q, t, qq, scoring)
                note.update(cigar_score=got, seq_is_read=ok, pos=r["pos"], cigar=r["cigar_text"])
                if not ok or got is None or got != r["score"]:
                    path_off += 1
                    note["path_off"] = True
            else:
                note.update(tstart=r["tstart"], qstart=r["qstart"], qend=r["qend"])
            items.append((q, t, qq))
            reported.append(r["score"])
            seen.append(note)
    best = span_optimum(items, scoring, device=device) if items else []
    off = sum(int(s != b) for s, b in zip(reported, best))
    below = sum(int(s < b) for s, b in zip(reported, best))
    odd = []
    for note, b in zip(seen, best):
        if note["reported"] != b or note.get("path_off"):
            odd.append(dict(note, optimum=b))
    out = {
        "missing_reads": missing,
        "locus_off_pct": locus_off_pct(fmt, recs, names),
        "score_off_pct": 100.0 * off / max(len(items), 1),
    }
    if fmt == "sam":
        out["path_off"] = path_off
    out["_sampled_records"] = len(items)
    out["_below_optimum"] = below
    out["_odd_records"] = odd
    return out


def _spans(fmt: str, r: dict, codes: np.ndarray, qual, genome: np.ndarray):
    """(query span, its phred or None, genome span, record consistent with
    the read) of one record."""
    n = len(codes)
    oriented = revcomp_codes(codes) if r["strand"] else codes
    oq = None if qual is None else (qual[::-1] if r["strand"] else qual)
    if fmt == "sam":
        cig = r["cigar"]
        left = cig[0][1] if cig and cig[0][0] == "S" else 0
        right = cig[-1][1] if len(cig) > 1 and cig[-1][0] == "S" else 0
        q0, q1 = left, n - right
        t0, t1 = _forward_span(fmt, r)
        ok = r["seq"].encode() == codes_to_bytes(oriented) and q0 <= q1
    else:
        q0, q1 = (r["qstart"], r["qend"]) if r["strand"] == 0 else (n - r["qend"], n - r["qstart"])
        t0, t1 = r["tstart"], r["tend"]
        ok = r["qlen"] == n
    q0, q1 = max(0, q0), max(max(0, q0), min(n, q1))
    t0, t1 = max(0, t0), max(max(0, t0), min(len(genome), t1))
    return (oriented[q0:q1], None if oq is None else oq[q0:q1], genome[t0:t1], ok)
