"""BAM output/input (SAM spec section 4) with a pure-stdlib BGZF layer; the
port's copy of ``blasr_tpu/io/bam.py``.

The reference emits text SAM only; production serving wants BAM. This
module implements the binary container from the published spec (zlib for
DEFLATE, no external deps): BGZF member blocks with the BC/BSIZE extra
field and the fixed EOF marker, the BAM header (magic, SAM text, reference
dictionary), and alignment records with packed 4-bit sequence nibbles,
binary CIGAR ops, and typed optional tags (A/i/f/Z and B arrays).

``read_bam`` is the inverse — used by the round-trip tests and by
``io/sam.read_sam`` when handed a .bam path.
"""

from __future__ import annotations

import struct
import zlib
from typing import IO, Iterable, Sequence

import numpy as np

BAM_MAGIC = b"BAM\x01"
# BGZF EOF marker (SAM spec 4.1.2)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

CIGAR_OPS = "MIDNSHP=X"
# 4-bit sequence codes (spec: =ACMGRSVTWYHKDBN)
_NIB = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_CODE_TO_NIB = np.array([1, 2, 4, 8, 15, 15], np.uint8)  # ACGTN(sentinel)
_NIB_TO_CODE = np.full(16, 4, np.uint8)
for _i, _c in enumerate("=ACMGRSVTWYHKDBN"):
    _NIB_TO_CODE[_i] = {"A": 0, "C": 1, "G": 2, "T": 3}.get(_c, 4)


def _bgzf_block(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + 25  # total size (hdr 12 + extra 6 + ftr 8 + comp) - 1
    header = (
        b"\x1f\x8b\x08\x04" + b"\x00" * 6 + b"\x06\x00"  # XLEN=6
        + b"BC\x02\x00" + struct.pack("<H", bsize)
    )
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + comp + footer


class BgzfWriter:
    def __init__(self, fh: IO[bytes], block: int = 60000):
        self.fh = fh
        self.block = block
        self.buf = bytearray()

    def write(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= self.block:
            self.fh.write(_bgzf_block(bytes(self.buf[: self.block])))
            del self.buf[: self.block]

    def close(self) -> None:
        if self.buf:
            self.fh.write(_bgzf_block(bytes(self.buf)))
            self.buf.clear()
        self.fh.write(BGZF_EOF)


def bgzf_decompress(path: str) -> bytes:
    """Inflate every BGZF member of a file."""
    out = bytearray()
    raw = open(path, "rb").read()
    pos = 0
    while pos < len(raw):
        if raw[pos : pos + 2] != b"\x1f\x8b":
            raise ValueError(f"{path}: bad BGZF member at {pos}")
        xlen = struct.unpack_from("<H", raw, pos + 10)[0]
        extra = raw[pos + 12 : pos + 12 + xlen]
        bsize = None
        e = 0
        while e < len(extra):
            si1, si2, slen = extra[e], extra[e + 1], struct.unpack_from("<H", extra, e + 2)[0]
            if si1 == 0x42 and si2 == 0x43:
                bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
            e += 4 + slen
        if bsize is None:
            raise ValueError(f"{path}: BGZF member without BSIZE at {pos}")
        cdata = raw[pos + 12 + xlen : pos + bsize - 8]
        out += zlib.decompress(cdata, -15)
        pos += bsize
    return bytes(out)


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _encode_tags(tag_strings: Sequence[str]) -> bytes:
    """SAM text tags ('XX:T:val') -> binary BAM tag block."""
    out = bytearray()
    for t in tag_strings:
        tag, typ, val = t.split(":", 2)
        out += tag.encode()
        if typ == "i":
            out += b"i" + struct.pack("<i", int(val))
        elif typ == "f":
            out += b"f" + struct.pack("<f", float(val))
        elif typ == "A":
            out += b"A" + val[:1].encode()
        elif typ == "Z":
            out += b"Z" + val.encode() + b"\x00"
        elif typ == "B":
            sub, _, items = val.partition(",")
            vals = [x for x in items.split(",") if x] if items else []
            out += b"B" + sub.encode() + struct.pack("<i", len(vals))
            fmtc = {"f": "<f", "i": "<i", "I": "<I", "s": "<h", "S": "<H",
                    "c": "<b", "C": "<B"}[sub]
            caster = float if sub == "f" else int
            for v in vals:
                out += struct.pack(fmtc, caster(v))
        else:
            raise ValueError(f"unsupported tag type {typ!r} in {t!r}")
    return bytes(out)


def _sam_line_to_bam_record(fields: list[str], ref_ids: dict[str, int]) -> bytes:
    qname = fields[0].encode() + b"\x00"
    flag = int(fields[1])
    refid = ref_ids.get(fields[2], -1)
    pos = int(fields[3]) - 1
    mapq = int(fields[4])
    cigar = fields[5]
    seq = fields[9]
    qual = fields[10]
    cig_ops = []
    if cigar != "*":
        n = ""
        for ch in cigar:
            if ch.isdigit():
                n += ch
            else:
                cig_ops.append((int(n), CIGAR_OPS.index(ch)))
                n = ""
    l_seq = 0 if seq == "*" else len(seq)
    end = pos + sum(ln for ln, op in cig_ops if op in (0, 2, 3, 7, 8))
    nib = bytearray((l_seq + 1) // 2)
    for i, ch in enumerate(seq if seq != "*" else ""):
        v = _NIB.get(ch.upper(), 15)
        nib[i // 2] |= v << (4 if i % 2 == 0 else 0)
    q = (
        b"\xff" * l_seq
        if qual == "*"
        else bytes((min(ord(c) - 33, 93) for c in qual))
    )
    tags = _encode_tags(fields[11:])
    # mate fields (RNEXT/PNEXT/TLEN) carry through; "=" means same ref
    rnext = fields[6] if len(fields) > 6 else "*"
    next_refid = refid if rnext == "=" else ref_ids.get(rnext, -1)
    next_pos = (int(fields[7]) - 1) if len(fields) > 7 else -1
    tlen = int(fields[8]) if len(fields) > 8 else 0
    body = struct.pack(
        "<iiBBHHHiiii",
        refid, pos, len(qname), mapq,
        _reg2bin(pos, max(end, pos + 1)), len(cig_ops), flag, l_seq,
        next_refid, next_pos, tlen,
    ) + qname + b"".join(
        struct.pack("<I", (ln << 4) | op) for ln, op in cig_ops
    ) + bytes(nib) + q + tags
    return struct.pack("<i", len(body)) + body


def write_bam_from_sam_lines(
    header_lines: Sequence[str],
    record_lines: Iterable[str],
    path: str,
) -> int:
    """Serialize SAM text (header + tab-separated record lines) as BAM."""
    text = "\n".join(header_lines) + "\n"
    refs: list[tuple[str, int]] = []
    for line in header_lines:
        if line.startswith("@SQ"):
            d = dict(
                f.split(":", 1) for f in line.split("\t")[1:] if ":" in f
            )
            refs.append((d["SN"], int(d["LN"])))
    ref_ids = {name: i for i, (name, _) in enumerate(refs)}
    n = 0
    with open(path, "wb") as fh:
        w = BgzfWriter(fh)
        w.write(BAM_MAGIC)
        t = text.encode()
        w.write(struct.pack("<i", len(t)) + t)
        w.write(struct.pack("<i", len(refs)))
        for name, ln in refs:
            nm = name.encode() + b"\x00"
            w.write(struct.pack("<i", len(nm)) + nm + struct.pack("<i", ln))
        for line in record_lines:
            if not line or line.startswith("@"):
                continue
            w.write(_sam_line_to_bam_record(line.rstrip("\n").split("\t"), ref_ids))
            n += 1
        w.close()
    return n


def read_bam(path: str) -> tuple[list[str], list[list[str]]]:
    """BAM -> (SAM header lines, record field lists) — the writer's inverse."""
    data = bgzf_decompress(path)
    if data[:4] != BAM_MAGIC:
        raise ValueError(f"{path}: not BAM")
    off = 4
    l_text = struct.unpack_from("<i", data, off)[0]
    off += 4
    text = data[off : off + l_text].decode().rstrip("\x00")
    off += l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        off += 4
        name = data[off : off + l_name - 1].decode()
        off += l_name
        ln = struct.unpack_from("<i", data, off)[0]
        off += 4
        refs.append((name, ln))
    records = []
    while off < len(data):
        block = struct.unpack_from("<i", data, off)[0]
        off += 4
        (refid, pos, l_qname, mapq, _bin, n_cig, flag, l_seq,
         nrid, npos, tlen) = struct.unpack_from("<iiBBHHHiiii", data, off)
        p = off + 32
        qname = data[p : p + l_qname - 1].decode()
        p += l_qname
        cig = []
        for _ in range(n_cig):
            v = struct.unpack_from("<I", data, p)[0]
            cig.append(f"{v >> 4}{CIGAR_OPS[v & 15]}")
            p += 4
        nib = data[p : p + (l_seq + 1) // 2]
        p += (l_seq + 1) // 2
        seq = "".join(
            "=ACMGRSVTWYHKDBN"[(nib[i // 2] >> (4 if i % 2 == 0 else 0)) & 15]
            for i in range(l_seq)
        )
        q = data[p : p + l_seq]
        p += l_seq
        qual = (
            "*" if (l_seq and q[0] == 0xFF) or not l_seq
            else "".join(chr(v + 33) for v in q)
        )
        tags = []
        end = off + block
        while p < end:
            tg = data[p : p + 2].decode()
            ty = chr(data[p + 2])
            p += 3
            if ty in "cCsSiI":
                fmtc, sz = {"c": ("<b", 1), "C": ("<B", 1), "s": ("<h", 2),
                            "S": ("<H", 2), "i": ("<i", 4), "I": ("<I", 4)}[ty]
                tags.append(
                    f"{tg}:i:{struct.unpack_from(fmtc, data, p)[0]}"
                )
                p += sz
            elif ty == "f":
                tags.append(f"{tg}:f:{struct.unpack_from('<f', data, p)[0]:g}")
                p += 4
            elif ty == "A":
                tags.append(f"{tg}:A:{chr(data[p])}")
                p += 1
            elif ty == "Z":
                z = data.index(b"\x00", p)
                tags.append(f"{tg}:Z:{data[p:z].decode()}")
                p = z + 1
            elif ty == "B":
                sub = chr(data[p])
                cnt = struct.unpack_from("<i", data, p + 1)[0]
                fmtc, sz = {"f": ("<f", 4), "i": ("<i", 4), "I": ("<I", 4),
                            "s": ("<h", 2), "S": ("<H", 2), "c": ("<b", 1),
                            "C": ("<B", 1)}[sub]
                p += 5
                vals = []
                for _ in range(cnt):
                    v = struct.unpack_from(fmtc, data, p)[0]
                    vals.append(f"{v:g}" if sub == "f" else str(v))
                    p += sz
                tags.append(f"{tg}:B:{sub}," + ",".join(vals) if vals else f"{tg}:B:{sub}")
            else:
                raise ValueError(f"unsupported BAM tag type {ty!r}")
        rname = refs[refid][0] if refid >= 0 else "*"
        if nrid < 0:
            rnext = "*"
        elif nrid == refid:
            rnext = "="
        else:
            rnext = refs[nrid][0]
        records.append(
            [qname, str(flag), rname, str(pos + 1), str(mapq),
             "".join(cig) or "*", rnext, str(npos + 1), str(tlen),
             seq or "*", qual] + tags
        )
        off = end
    header_lines = [l for l in text.split("\n") if l]
    return header_lines, records
