"""Build and load the package's native code: the CUDA kernels and the C++
host helpers.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, and ``csrc/host_native.cpp``
by ``g++``; all compilers start together and the build waits for them all.
The libraries land in ``build/blasr_tpu_torch/`` at the repository root
under names keyed by a hash of each source and its flags, so an edited
source rebuilds and an unchanged one loads at once. Loading happens at
first use, never at import.

The CUDA kernels have no fallback: a missing ``nvcc`` or a failed compile
raises with the compiler's output. The host helpers are optional: without
``g++`` the callers in ``native.py`` run their plain numpy versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "blasr_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# no -march=native: the library may be loaded on another host than the
# one that built it
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
CUDA_SOURCES = ("banded_dp.cu", "gather.cu", "traceback_walk.cu", "mapqv.cu")
HOST_SOURCE = "host_native.cpp"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
# C signatures of the exported functions (each CUDA launcher returns a
# cudaError_t)
_SIGNATURES = {
    "banded_dp_launch": ([
        _P, _P, _P, _P, _P,          # query qlen target tlo thi
        _P, _P, _I,                  # qoff (S,) or NULL, knots (I, NK) or NULL, NK
        _P, _I,                      # qual (I, L) uint8 / uint16 or NULL, qmode
        _P, _P,                      # best (3, I) int32, arrows (S, I, W) uint16
        _I, _I, _I, _I, _I,          # I L T S W
        _I, _I, _I, _I, _I, _I, _I,  # match mismatch n ins del open extend
        _PI,                         # host int[25] score matrix or NULL
        _P,                          # cudaStream_t
    ], ctypes.c_int),
    "gather_spans_launch": ([_P, _LL, _P, _P, _I, _I, _P], ctypes.c_int),
    "gather_rows_launch": ([_P, _I, _I, _P, _P, _I, _I, _P], ctypes.c_int),  # ... vec, stream
    "traceback_walk_launch": ([
        _P, _P, _P, _P,              # arrows (S, I, W) uint16, best_a best_w scores (I,) int32
        _I, _P, _P, _I,              # band form, qoff (S,) or NULL, knots (I, nk) or NULL, nk
        _P, _I, _I, _I, _I,          # num on the device or NULL, num, diag, half, hi
        _P, _P, _I,                  # out (9, I) int32, moves (I, row) int32 or NULL, row
        _I, _I, _I, _I,              # I S W max_steps
        _P,                          # cudaStream_t
    ], ctypes.c_int),
    "mapqv_launch": ([
        _P, _P, _P, _P,              # scores valid q_lo q_hi (B, CD)
        _P, _P, _P, _P,              # n_match n_mismatch n_ins n_del (B, CD)
        _I, _I, _I,                  # mismatch_prob ins_cost del_cost
        _P, _P, _P,                  # out (B, CD) int32, q_float (B, CD) float32, scratch or NULL
        _I, _I,                      # B CD
        _P,                          # cudaStream_t
    ], ctypes.c_int),
    "mapqv_scratch_words": ([_I, _I], ctypes.c_longlong),
    "bn_sais_i32": ([_P, ctypes.c_int32, _P], ctypes.c_int),
    "bn_sais_i64": ([_P, ctypes.c_int64, _P], ctypes.c_int),
    "bn_encode_strip": ([ctypes.c_char_p, ctypes.c_int64, _P], ctypes.c_int64),
    "bn_unpack_moves": ([_P, ctypes.c_int64, _P], None),
    # ops nops q t qpos tpos pre_clip post_clip clip_op out out_cap
    "bn_xeq_cigar": ([_P, _LL, _P, _P, _LL, _LL, _LL, _LL, ctypes.c_char, _P, _LL],
                     ctypes.c_int64),
    # packed nops q_start t_start codes read_len qual has_qual t_aln t_len
    # strand clip_mode clip_op out out_cap lens_out
    "bn_sam_fields": ([_P, _LL, _LL, _LL, _P, _LL, _P, _LL, _P, _LL, _LL, _LL,
                       ctypes.c_char, _P, _LL, _P], ctypes.c_int64),
    # q qn t tn match mismatch nscore ins del ops_out score_out
    "bn_global_align": ([_P, _LL, _P, _LL, _I, _I, _I, _I, _I, _P, _P], ctypes.c_int64),
    # q qn t tn word sdp_ins sdp_del match mismatch n_score ins del indel_rate
    # prefix_len recurse no_recurse_under cap affine affine_open affine_extend
    # local blocks_out max_blocks score_out
    "bn_sdp_interval_align": ([_P, _LL, _P, _LL, *[_LL] * 8, ctypes.c_double, *[_LL] * 8,
                               _P, _LL, _P], ctypes.c_int64),
    # q n genome G sa sa_is64 sa_kmers kmers_is64 nsa k min_match trim max_ext
    # max_range max_anchors_per_position length_deficit lut lut_bits q_out t_out
    # l_out cap
    "bn_reference_anchor_list": ([_P, _LL, _P, _LL, _P, _LL, _P, *[_LL] * 9, _P, _LL, _P, _P,
                                  _P, _LL], ctypes.c_int64),
}

_lock = threading.Lock()
_cuda = None
_host = None
_host_tried = False
BUILD_SECONDS = 0.0  # wall time of the last build in this process (0 = cached)
# each compiler run of this process: the library and the seconds from its
# build's start to its end (the compilers of a build run together)
COMPILER_RUNS: list[dict] = []


def _which(name: str, env: str | None = None) -> str | None:
    cand = shutil.which(name)
    if cand is None and env is not None:
        path = os.path.join(os.environ.get(env) or "/usr/local/cuda", "bin", name)
        if os.path.exists(path):
            cand = path
    return cand


def _nvcc() -> str:
    cand = _which("nvcc", "CUDA_HOME")
    if cand is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "blasr_tpu_torch cannot be built"
        )
    return cand


def library_path(source: str) -> str:
    """Where the library of ``csrc/<source>`` lands: keyed by the source,
    every header of ``csrc/`` and the compiler flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith((".cuh", ".h")))
    for name in (source, *headers):
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    flags = GXX_FLAGS if source == HOST_SOURCE else NVCC_FLAGS
    h.update(" ".join(flags).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def _build(jobs: list[tuple[str, list[str]]]) -> None:
    """Run the compile commands of ``jobs`` (output path, command) all at
    once; raise with the compiler's output if any fails."""
    global BUILD_SECONDS
    jobs = [(out, cmd) for out, cmd in jobs if not os.path.exists(out)]
    if not jobs:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    procs = []
    for out, cmd in jobs:
        tmp = f"{out}.{os.getpid()}.tmp"
        procs.append((out, tmp, cmd + ["-o", tmp], subprocess.Popen(
            cmd + ["-o", tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for out, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        COMPILER_RUNS.append({"library": os.path.basename(out),
                              "seconds": round(time.time() - t0, 3)})
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent builder never loads a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    BUILD_SECONDS = time.time() - t0


def _host_job() -> tuple[str, list[str]] | None:
    gxx = _which("g++")
    if gxx is None:
        return None
    return library_path(HOST_SOURCE), [gxx, *GXX_FLAGS, os.path.join(CSRC, HOST_SOURCE)]


def _load(paths: list[str]) -> types.SimpleNamespace:
    fns = {}
    for path in paths:
        lib = ctypes.CDLL(path)
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = restype
                fns[name] = fn
    return types.SimpleNamespace(**fns)


def load_library() -> types.SimpleNamespace:
    """The CUDA launchers, compiled on first use. The host helpers' library
    is compiled in the same parallel build when ``g++`` is present."""
    global _cuda
    with _lock:
        if _cuda is None:
            nvcc = _nvcc()
            jobs = [
                (library_path(src), [nvcc, *NVCC_FLAGS, "-I", CSRC, os.path.join(CSRC, src)])
                for src in CUDA_SOURCES
            ]
            host = _host_job()
            _build(jobs + ([host] if host else []))
            _cuda = _load([out for out, _ in jobs])
        return _cuda


def load_host_library() -> types.SimpleNamespace | None:
    """The C++ host helpers (``csrc/host_native.cpp``), compiled by ``g++``
    on first use; None when no ``g++`` is on the PATH."""
    global _host, _host_tried
    with _lock:
        if not _host_tried:
            _host_tried = True
            job = _host_job()
            if job is not None:
                _build([job])
                _host = _load([job[0]])
        return _host


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
