"""A batch split over devices (``-ndevices``); the port of
``blasr_tpu/parallel/mesh.py``.

The JAX package shards the batch axis over a 1-D device mesh, replicates
the index and runs the one jitted map step SPMD. Here each device maps
its slice of the batch with its own copy of the index, and the slices'
results are put together in batch order on the first device, so the
result equals the one-device result byte for byte.

That holds because every step of ``pipeline/mapper.map_batch_steps``
works on one read, one read-strand row or one DP item, with shapes fixed
by the params and the batch's padded length L (which every slice keeps),
except one. Checked step by step:

  * anchors: per row; the width of a row's anchor list is
    ``max_anchors_per_read``, not a maximum over the batch;
  * candidate windows, chain evidence, the cross-strand ``topk_desc``:
    per row and per read;
  * the band width W and the target length T: from the params and L;
  * the drift slope fit: per item, each sum over that item's anchors
    (``ordered_sum`` along the anchor axis), but the slope the band
    schedule follows (``qoff_num``) is the median over every item of the
    batch. That median is the one reduction over the batch: each slice
    yields its items' slopes, they are gathered to the first device, one
    ``slope_median`` runs over them all and the scalar goes back to every
    slice before its DP;
  * the guided knots: per item, clamped to the shared schedule above;
  * the genome windows and contig bounds, the DP, the walk: per item;
  * containment, best_n, MAPQ: over one read's CD items.

A split batch's wire is not the slices' wires end to end (each is
``sel_ints | moves_packed | read_ints``): the slices' three arrays are
joined field by field, then packed once (``mapper.wire_bytes``).
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

from blasr_tpu_torch.index.artifacts import GenomeIndex
from blasr_tpu_torch.ops.transfer import to_device
from blasr_tpu_torch.params import MappingParams
from blasr_tpu_torch.pipeline.mapper import (
    DeviceIndex,
    MapBatchResult,
    finish_steps,
    make_device_index,
    map_batch_steps,
    require_device,
    slope_median,
)


def make_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The first ``n_devices`` visible CUDA devices, or all of them when
    it is 0 or None. Raises when fewer are visible."""
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = avail if not n_devices else n_devices
    if n == 0 or avail < n:
        raise ValueError(f"need {n or 'a'} CUDA device(s), have {avail}")
    return [torch.device("cuda", i) for i in range(n)]


def on_device(dev: torch.device):
    """Make ``dev`` the thread's current CUDA device for a block of work
    (the kernels launch on the current device's stream)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def mapper_devices(
    params: MappingParams, device: torch.device, devices: Sequence | None
) -> list[torch.device] | None:
    """The devices ``Mapper`` maps on: a list to split each batch over, one
    device, or None for ``device``. Given ``devices`` (which may repeat
    one device) it takes them and raises when the batch does not divide;
    otherwise it follows
    the JAX ``Mapper``: ``params.ndevices`` 0 means every visible CUDA
    device, N means min(N, visible), and the batch is split only when
    that is more than one and divides ``batch_size``. On the CPU one
    device is visible."""
    if devices is not None:
        devs = [require_device(d) for d in devices]
        if params.batch_size % len(devs):
            raise ValueError(
                f"batch size {params.batch_size} not divisible by {len(devs)} devices")
        return devs
    nd = params.ndevices
    if nd == 1 or device.type != "cuda":
        return None
    avail = torch.cuda.device_count()
    nd = avail if nd == 0 else min(nd, avail)
    if nd > 1 and params.batch_size % nd == 0:
        return make_mesh(nd)
    return None


def replicate_index(
    devices: Sequence, index: GenomeIndex, params: MappingParams, fm=None
) -> dict[torch.device, DeviceIndex]:
    """One device index per distinct device of ``devices``, from
    ``make_device_index``'s cache (never two copies on one device)."""
    return {d: make_device_index(index, params, d, fm=fm)
            for d in dict.fromkeys(torch.device(x) for x in devices)}


def sharded_map_batch(
    devices: Sequence,
    index: GenomeIndex,
    params: MappingParams,
    codes: np.ndarray,
    lengths: np.ndarray,
    qual: np.ndarray | None = None,
    fm=None,
    replicas: dict[torch.device, DeviceIndex] | None = None,
) -> MapBatchResult:
    """Map one padded batch split into ``len(devices)`` equal slices, each
    on its device; the result, in batch order, lies on the first device.
    ``qual`` is the DP's view of the phred rows (``mapper.host_qual``);
    ``replicas`` is ``replicate_index``'s dict, looked up when not given."""
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    B = codes.shape[0]
    if B % n != 0:
        raise ValueError(f"batch size {B} not divisible by {n} devices")
    dis = replicas if replicas is not None else replicate_index(devs, index, params, fm=fm)
    s = B // n

    def put(a, i, dev):
        return to_device(a[i * s : (i + 1) * s], dev)

    steps, slopes = [], []
    for i, dev in enumerate(devs):
        with on_device(dev):
            st = map_batch_steps(
                put(codes, i, dev), put(lengths.astype(np.int32, copy=False), i, dev),
                dis[dev], params, None if qual is None else put(qual, i, dev))
            slopes.append(next(st))
        steps.append(st)
    home = devs[0]
    med = None
    if slopes[0] is not None:
        med = slope_median(torch.cat([x.to(home) for x in slopes]))
    parts = []
    for st, dev in zip(steps, devs):
        with on_device(dev):
            parts.append(finish_steps(st, None if med is None else med.to(dev)))
    return MapBatchResult(
        sel_ints=torch.cat([r.sel_ints.to(home) for r in parts], dim=1),
        moves_packed=torch.cat([r.moves_packed.to(home) for r in parts], dim=0),
        read_ints=torch.cat([r.read_ints.to(home) for r in parts], dim=0),
    )
