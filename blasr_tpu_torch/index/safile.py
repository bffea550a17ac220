"""Reference-format ``.sa`` file interop; the port's copy of
``blasr_tpu/index/safile.py``.

Binary layout (reference ``common/datastructures/suffixarray/SuffixArray.h``:
``Write`` :505-532, ``WriteArray`` :470-473, ``WriteLookupTable`` :475-481,
magic at :102):

    int32  magic = 0xacac0001
    int32  componentList[2]      # [has suffix array, has lookup table]
    -- if componentList[0]:
    uint32 length
    uint32 index[length]         # the suffix array
    -- if componentList[1]:
    uint32 lookupTableLength     # == 4^lookupPrefixLength
    uint32 lookupPrefixLength
    uint32 startPosTable[lookupTableLength]
    uint32 endPosTable[lookupTableLength]

Everything little-endian (x86 reference binaries). The suffix array is over
the concatenated genome exactly as ``sawriter`` builds it, so files written
here load in reference ``blasr -sa`` and vice versa.
"""

from __future__ import annotations

import numpy as np

SA_MAGIC = 0xACAC0001


def read_sa_file(path: str, genome_len: int | None = None) -> np.ndarray:
    """Read a reference-format .sa file; returns the suffix array (int64).

    The reference stores N+1 rows — the empty suffix (position N) sorts
    LAST in its order (larsson qsufsort convention). When ``genome_len``
    is given, that sentinel row is stripped.
    """
    with open(path, "rb") as f:
        magic = np.fromfile(f, dtype="<u4", count=1)
        if magic.size != 1 or int(magic[0]) != SA_MAGIC:
            got = f"{int(magic[0]):#x}" if magic.size else "EOF"
            raise ValueError(
                f"{path}: not a reference .sa file (magic {got} != "
                f"{SA_MAGIC:#x})"
            )
        comp = np.fromfile(f, dtype="<i4", count=2)
        if comp.size != 2:
            raise ValueError(f"{path}: truncated component list")
        if not comp[0]:
            raise ValueError(f"{path}: file has no suffix array component")
        n = int(np.fromfile(f, dtype="<u4", count=1)[0])
        sa = np.fromfile(f, dtype="<u4", count=n)
        if sa.size != n:
            raise ValueError(f"{path}: truncated suffix array ({sa.size}/{n})")
        out = sa.astype(np.int64)
        if genome_len is not None and n == genome_len + 1 and out[-1] == genome_len:
            out = out[:-1]
        return out


def read_sa_lookup(path: str):
    """Read the optional lookup table: (prefix_len, start, end) or None."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, dtype="<u4", count=1)
        if magic.size != 1 or int(magic[0]) != SA_MAGIC:
            raise ValueError(f"{path}: not a reference .sa file")
        comp = np.fromfile(f, dtype="<i4", count=2)
        if comp[0]:
            n = int(np.fromfile(f, dtype="<u4", count=1)[0])
            f.seek(4 * n, 1)
        if not comp[1]:
            return None
        tl = int(np.fromfile(f, dtype="<u4", count=1)[0])
        pl = int(np.fromfile(f, dtype="<u4", count=1)[0])
        start = np.fromfile(f, dtype="<u4", count=tl)
        end = np.fromfile(f, dtype="<u4", count=tl)
        return pl, start.astype(np.int64), end.astype(np.int64)


def reference_order_sa(genome: np.ndarray) -> np.ndarray:
    """Suffix array in the REFERENCE's convention: end-of-string compares
    LARGEST (larsson qsufsort treats the terminator as the highest rank), so
    a proper prefix sorts AFTER its extensions and the empty suffix is the
    last row. Returns N+1 rows (sentinel row included), matching the binary
    .sa layout.

    Achieved by appending a character above the alphabet before SA-IS: any
    short suffix then diverges upward at its end.
    """
    from blasr_tpu_torch.index.suffix_array import build_suffix_array

    proj = (genome & 3).astype(np.uint8)
    ext = np.concatenate([proj, np.asarray([4], np.uint8)])
    return build_suffix_array(ext)


def write_sa_file(
    path: str, sa_rows: np.ndarray, genome: np.ndarray | None = None,
    lookup_prefix_len: int = 0,
) -> None:
    """Write a reference-format .sa file. ``sa_rows`` must be in the
    reference's order INCLUDING the sentinel row (use reference_order_sa);
    optionally adds the prefix lookup table (BuildLookupTable role,
    SuffixArray.h:193)."""
    if len(sa_rows) >= 1 << 32:
        raise ValueError(".sa format is 32-bit; genome too large")
    n = len(sa_rows)
    with open(path, "wb") as f:
        np.asarray([SA_MAGIC], dtype="<u4").tofile(f)
        has_lut = 1 if (lookup_prefix_len > 0 and genome is not None) else 0
        np.asarray([1, has_lut], dtype="<i4").tofile(f)
        np.asarray([n], dtype="<u4").tofile(f)
        sa_rows.astype("<u4").tofile(f)
        if has_lut:
            from blasr_tpu_torch.core.encode import pack_kmers

            pl = lookup_prefix_len
            tl = 1 << (2 * pl)
            N = len(genome)
            keys, _ = pack_kmers(genome, pl)
            # [start, end) SA-row ranges per prefix over FULL-length rows
            # (short suffixes can interleave in reference order; the
            # reference's scan skips them too, SuffixArray.h:216-227)
            full = np.flatnonzero(np.asarray(sa_rows) + pl <= N)
            pb = keys[np.asarray(sa_rows)[full]].astype(np.int64)
            lo = np.searchsorted(pb, np.arange(tl), side="left")
            hi = np.searchsorted(pb, np.arange(tl), side="right")
            start = np.zeros(tl, np.int64)
            end = np.zeros(tl, np.int64)
            nonempty = hi > lo
            start[nonempty] = full[lo[nonempty]]
            end[nonempty] = full[hi[nonempty] - 1] + 1
            np.asarray([tl, pl], dtype="<u4").tofile(f)
            start.astype("<u4").tofile(f)
            end.astype("<u4").tofile(f)
