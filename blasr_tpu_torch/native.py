"""The C++ host helpers of the port and their plain numpy versions.

The port's copy of the three entry points of ``blasr_tpu/native`` that it
calls: the SA-IS suffix-array builder, the FASTA body encoder and the
move-string unpacker (``csrc/host_native.cpp``, built by ``g++`` through
``ops/_build.py`` at first use). Each function runs the C++ code when the
library is built and its plain version, which gives the same result, when
no ``g++`` is present.
"""

from __future__ import annotations

import ctypes

import numpy as np

from blasr_tpu_torch.core.encode import seq_to_codes
from blasr_tpu_torch.ops import _build


def available() -> bool:
    """True when the C++ helpers are built (else the plain versions run)."""
    return _build.load_host_library() is not None


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data_as(ctypes.c_void_p).value or 0


def sais(codes: np.ndarray) -> np.ndarray:
    """int64 suffix array of ``codes`` (past-the-end suffix smallest)."""
    lib = _build.load_host_library()
    if lib is None:
        from blasr_tpu_torch.index.suffix_array import build_suffix_array_plain

        return build_suffix_array_plain(codes)
    n = int(len(codes))
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if n < 2**31:
        sa = np.empty(n, np.int32)
        lib.bn_sais_i32(_ptr(codes), n, _ptr(sa))
        return sa.astype(np.int64)
    sa = np.empty(n, np.int64)
    lib.bn_sais_i64(_ptr(codes), n, _ptr(sa))
    return sa


def encode_strip_plain(data: bytes) -> np.ndarray:
    return seq_to_codes(b"".join(data.split()))


def encode_strip(data: bytes) -> np.ndarray:
    """ASCII sequence bytes -> uint8 codes, whitespace skipped."""
    lib = _build.load_host_library()
    if lib is None:
        return encode_strip_plain(data)
    out = np.empty(len(data), np.uint8)
    m = lib.bn_encode_strip(data, len(data), _ptr(out))
    return out[:m].copy()


def unpack_moves_plain(packed_row: np.ndarray, nops: int) -> np.ndarray:
    b = packed_row[:, None] >> np.array([0, 2, 4, 6], np.uint8)[None, :]
    ops_rev = (b & 3).reshape(-1)[:nops]
    return ops_rev[::-1].copy()


def unpack_moves(packed_row: np.ndarray, nops: int) -> np.ndarray:
    """One 2-bit packed move string (END->START) -> START->END ops (uint8)."""
    lib = _build.load_host_library()
    if lib is None:
        return unpack_moves_plain(packed_row, nops)
    packed_row = np.ascontiguousarray(packed_row, dtype=np.uint8)
    out = np.empty(max(nops, 1), np.uint8)
    lib.bn_unpack_moves(_ptr(packed_row), nops, _ptr(out))
    return out[:nops]
