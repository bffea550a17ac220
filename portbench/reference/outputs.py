"""Parsers of the two output formats the cells judge: ``-m 4`` lines and
SAM lines, into plain dicts. Plain Python: nothing of the program."""

from __future__ import annotations

import re

_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")


def read_name(qname: str) -> str:
    """The read's own name: BLASR prints a whole read as ``<name>/0_<len>``."""
    base, _, tail = qname.rpartition("/")
    a, _, b = tail.partition("_")
    if base and a.isdigit() and b.isdigit():
        return base
    return qname


def parse_m4(text: str) -> dict[str, list[dict]]:
    """Read name -> its records: score, strand, forward target span, query
    span and length."""
    out: dict[str, list[dict]] = {}
    for line in text.splitlines():
        if not line or line.startswith("qname"):
            continue
        f = line.split()
        tstrand, tstart, tend, tlen = int(f[8]), int(f[9]), int(f[10]), int(f[11])
        if tstrand:
            tstart, tend = tlen - tend, tlen - tstart
        out.setdefault(read_name(f[0]), []).append(dict(
            score=int(f[2]), qstart=int(f[5]), qend=int(f[6]), qlen=int(f[7]),
            strand=tstrand, tstart=tstart, tend=tend, mapqv=int(f[12])))
    return out


def parse_sam(text: str) -> dict[str, list[dict]]:
    """Read name -> its mapped records: flag, 0-based position, CIGAR runs,
    SEQ and the AS score."""
    out: dict[str, list[dict]] = {}
    for line in text.splitlines():
        if not line or line.startswith("@"):
            continue
        f = line.split("\t")
        flag = int(f[1])
        if flag & 4:
            continue
        tags = {t[:2]: t[5:] for t in f[11:]}
        out.setdefault(read_name(f[0]), []).append(dict(
            flag=flag, strand=1 if flag & 16 else 0, pos=int(f[3]) - 1,
            mapq=int(f[4]), cigar=[(op, int(n)) for n, op in _CIGAR.findall(f[5])],
            cigar_text=f[5], seq=f[9],
            score=int(tags["AS"]) if "AS" in tags else None))
    return out
