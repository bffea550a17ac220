"""The -anchors dump (role of the reference's anchor side channel,
Blasr.cpp:2309-2333); the port of ``blasr_tpu/pipeline/debug.py``.

The anchor searches run on ``device``; the file holds the JAX package's
lines. It takes the JAX dump's engines, not the mapper's: FM backward
search when an FM index is given (``-bwt``), wide keys above k = 15, and
otherwise bisection over the prefix table of ``GenomeIndex.lut()`` with a
second search for each interval's end, even where the mapper uses the
direct 4^k tables; every read position seeds (stride 1) at expand 0,
whatever ``-anchorStride`` and ``-minExpand`` say.

One departure: a read position's anchors (its hits in the genome) are
written by ascending genome position. The JAX dump orders each read's
anchors with numpy's default ``argsort`` of the read positions, which is
not stable (on x86 with AVX-512 it dispatches to a vectorised sort), so
the order of one position's hits there depends on the machine and the
numpy build. ``canonical_anchor_lines`` puts a JAX file in this order.
"""

from __future__ import annotations

from typing import IO, Sequence

import numpy as np
import torch

from blasr_tpu_torch.index.artifacts import GenomeIndex
from blasr_tpu_torch.io.batching import Read, batch_reads
from blasr_tpu_torch.ops.anchors import find_anchors_bisect, find_anchors_wide
from blasr_tpu_torch.ops.fm_search import find_anchors_fm
from blasr_tpu_torch.params import MappingParams
from blasr_tpu_torch.pipeline.mapper import _fm_arrays, _revcomp_rows


def dump_anchors(
    index: GenomeIndex,
    reads: Sequence[Read],
    params: MappingParams,
    out: IO[str],
    *,
    device: str | torch.device,
    fm=None,
) -> None:
    """Write every anchor as 'read_name strand qpos tpos nhits', per batch
    and strand, each read's anchors by read position."""
    device = torch.device(device)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    k = index.k
    kw = dict(k=k, max_hits_per_pos=params.max_anchors_per_position,
              max_anchors_per_read=params.max_anchors_per_read)
    if fm is None:
        sa32 = index.sa.astype(np.int32)
        sa_m = dev(np.where(index.pos_ok[sa32], sa32, np.int32(-1)))
        lut, shift, max_steps = index.lut()
        kw["lut_meta"] = (shift, max_steps)
        if 2 * k > 31:
            full = index.sa_kmers.astype(np.int64)
            lo_bits = 2 * k - 30
            arrays = (sa_m, dev((full >> lo_bits).astype(np.int32)),
                      dev((full & ((1 << lo_bits) - 1)).astype(np.int32)), dev(lut))
            search = find_anchors_wide
        else:
            arrays = (sa_m, dev(index.sa_kmers), dev(lut), None)
            search = find_anchors_bisect
    else:
        arrays = _fm_arrays(fm, index, device)
        kw["n"] = int(fm.n)
        search = find_anchors_fm
    for batch in batch_reads(reads, params.batch_size, params.max_read_len):
        codes = dev(batch.codes)
        lengths = dev(batch.lengths)
        rc = _revcomp_rows(codes, lengths)
        for strand, strand_codes in ((0, codes), (1, rc)):
            t, q, nh, valid = (x.cpu().numpy() for x in search(
                strand_codes, lengths, *arrays, **kw))
            for b in range(batch.codes.shape[0]):
                if batch.indices[b] < 0:
                    continue
                name = batch.names[b]
                for i in np.lexsort((t[b], q[b])):
                    if valid[b][i]:
                        out.write(f"{name} {strand} {q[b][i]} {t[b][i]} {nh[b][i]}\n")


def canonical_anchor_lines(lines: Sequence[str]) -> list[str]:
    """An -anchors file's lines with each run of lines for one read,
    strand and read position put in ascending genome position: the order
    ``dump_anchors`` writes, whatever order a sort that is not stable gave
    that run."""
    out: list[str] = []
    run: list[tuple[int, str]] = []
    key = None
    for ln in lines:
        f = ln.split()
        if f[:3] != key:
            out += [x for _, x in sorted(run)]
            run, key = [], f[:3]
        run.append((int(f[3]), ln))
    out += [x for _, x in sorted(run)]
    return out
