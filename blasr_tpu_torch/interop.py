"""State carried across from the JAX package: the device genome index.

The system has no model weights; its state is the device index. A JAX
``DeviceIndex`` handed over as numpy arrays (``np.asarray`` of each field)
becomes the port's ``DeviceIndex`` on a given device, array for array.
"""

from __future__ import annotations

import numpy as np
import torch

from blasr_tpu_torch.pipeline.mapper import DeviceIndex


def device_index_from_numpy(
    genome_pad: np.ndarray,
    arrays: tuple,
    starts: np.ndarray,
    *,
    pad: int,
    k: int,
    genome_len: int,
    kind: str = "sa",
    lut_meta: tuple | None = (0, 0),
    fm_n: int = 0,
    device: str | torch.device = "cpu",
) -> DeviceIndex:
    """The port's DeviceIndex from the numpy images of a JAX DeviceIndex of
    the suffix-array kind (``kind="sa"``), whose array set the JAX package
    tells apart by ``k`` and ``lut_meta``, as the port's "wide", "direct"
    or "bisect" kind: wide keys (k > 15), ``arrays = (sa_masked, kmer_hi,
    kmer_lo, lut)``; the direct tables (``lut_meta == (0, 0)``),
    ``(sa_valid, ctab16, lut_full, lut_valid)`` (``ctab16``, uint16, moves
    as its bit pattern in int16); else bisection, ``(sa_masked, sa_kmers,
    lut, run_len)``; all int32 but ctab16. Or of the FM
    kind (``kind="fm"``, ``fm_n`` rows), ``arrays = (bwt_rows, occ_bins,
    C, ssa_mask, ssa_base, ssa_vals, pos_ok)`` (the uint32 ``ssa_mask``
    moves as int64 words holding its values)."""

    def dev(a: np.ndarray, dtype) -> torch.Tensor:
        # a private writable copy: numpy views of device arrays are read-only
        return torch.from_numpy(np.array(a, copy=True, order="C").view(dtype)).to(device)

    common = dict(
        genome_pad=dev(genome_pad, np.int32),
        starts=dev(starts, np.int32),
        pad=int(pad),
        k=int(k),
        genome_len=int(genome_len),
    )
    if kind == "fm":
        bwt_rows, occ_bins, C, ssa_mask, ssa_base, ssa_vals, pos_ok = (
            np.asarray(a) for a in arrays)
        return DeviceIndex(
            arrays=(
                dev(bwt_rows, np.uint8),
                dev(occ_bins, np.int32),
                dev(C.astype(np.int32), np.int32),
                dev(ssa_mask.astype(np.uint32).astype(np.int64), np.int64),
                dev(ssa_base, np.int32),
                dev(ssa_vals.astype(np.int32), np.int32),
                dev(pos_ok, np.bool_),
            ),
            lut_meta=None, kind="fm", fm_n=int(fm_n), **common,
        )
    if kind != "sa" or lut_meta is None:
        raise ValueError(f"unknown device index kind {kind!r} (lut_meta {lut_meta})")
    arrays = tuple(np.asarray(a) for a in arrays)
    lut_meta = tuple(int(v) for v in lut_meta)
    sa_kind = "wide" if k > 15 else ("direct" if lut_meta[1] == 0 else "bisect")
    if sa_kind == "direct":
        sa_valid, ctab16, lut_full, lut_valid = arrays
        arrays = (dev(sa_valid, np.int32), dev(ctab16, np.int16),
                  dev(lut_full, np.int32), dev(lut_valid, np.int32))
    else:
        arrays = tuple(dev(a.astype(np.int32, copy=False), np.int32) for a in arrays)
    return DeviceIndex(arrays=arrays, lut_meta=lut_meta, kind=sa_kind, **common)
