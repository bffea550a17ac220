"""Multi-host mapping: deterministic input sharding + ordered merge; the
port of ``blasr_tpu/parallel/multihost.py``.

Role of reference §2.9 "process-level sharding" (-start/-stride let
independent processes split an input file, ReaderAgglomerate.h:81-95) made
first-class: each host maps a deterministic stride-slice of the read
stream on its local card(s) and writes a part file; a final merge restores
global read order. Between hosts nothing moves but files — the
reference's independent-process model (its only multi-node story) with
the bookkeeping automated. The part files and the merged file are the JAX
package's, byte for byte.

`init_distributed` joins a ``torch.distributed`` group for real multi-host
runs (coordinator + process ids, or torchrun's environment); on a single
host every function degenerates to the identity so the same script
runs anywhere.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import torch

from blasr_tpu_torch.index.artifacts import GenomeIndex
from blasr_tpu_torch.io.batching import Read
from blasr_tpu_torch.params import MappingParams
from blasr_tpu_torch.pipeline.runner import AlignmentRecord, run_mapping


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> tuple[int, int]:
    """Join a ``torch.distributed`` process group when multi-host
    arguments or torchrun's environment (``MASTER_ADDR``, ``RANK``,
    ``WORLD_SIZE``) are present. The group is ``gloo``: the parts are
    exchanged as files, not tensors. ``coordinator`` is ``host:port``.

    Returns (process_id, num_processes); (0, 1) on a single host.
    """
    env = os.environ
    if not coordinator and not all(v in env for v in ("MASTER_ADDR", "RANK", "WORLD_SIZE")):
        return 0, 1
    import torch.distributed as dist

    if not dist.is_initialized():
        kw = {}
        if coordinator:
            kw = dict(init_method=f"tcp://{coordinator}",
                      world_size=int(num_processes if num_processes is not None
                                     else env.get("WORLD_SIZE", 1)),
                      rank=int(process_id if process_id is not None else env.get("RANK", 0)))
        dist.init_process_group("gloo", **kw)
    return dist.get_rank(), dist.get_world_size()


def host_shard(
    reads: Sequence[Read], process_id: int, num_processes: int
) -> list[Read]:
    """Deterministic stride slice of the read stream for this host
    (the reference's -start/-stride contract)."""
    return [r for i, r in enumerate(reads) if i % num_processes == process_id]


def part_path(out_prefix: str, process_id: int) -> str:
    return f"{out_prefix}.part{process_id:04d}"


def run_mapping_host_part(
    index: GenomeIndex,
    reads: Sequence[Read],
    params: MappingParams,
    out_prefix: str,
    process_id: int = 0,
    num_processes: int = 1,
    fm=None,
    fmt: str = "m4",
    clipping: str = "soft",
    movie_name: str = "default",
    *,
    device: str | torch.device = "cuda",
) -> tuple[list[AlignmentRecord], list[str]]:
    """Map this host's shard and write its part file (read_index-tagged so
    the merge can restore global order). ``fmt`` is "m4" or "sam"; SAM
    parts are headerless record lines — merge_host_parts writes the header
    once (the multi-host analogue of the writer-semaphore ordering).
    The host maps on ``device``, the card unless the caller asks for the
    CPU."""
    mine = host_shard(reads, process_id, num_processes)
    recs, unmapped = run_mapping(index, mine, params, fm=fm, device=device)
    with open(part_path(out_prefix, process_id), "w") as f:
        if fmt == "m4":
            from blasr_tpu_torch.output.m4 import format_m4

            for rec in recs:
                # read_index is the GLOBAL stream index (Read.index survives
                # batching), so duplicate read names stay correctly ordered
                f.write(f"{rec.read_index}\t{_esc(format_m4(rec))}\n")
        elif fmt == "sam":
            from blasr_tpu_torch.output.sam_writer import (
                format_sam_record,
                format_unmapped,
                read_group_id,
            )

            rgid = read_group_id(movie_name)
            by_index: dict[int, list[AlignmentRecord]] = {}
            for rec in recs:
                by_index.setdefault(rec.read_index, []).append(rec)
            unm = set(unmapped)
            for rd in mine:
                rr = by_index.get(rd.index)
                if rr:
                    best = min(range(len(rr)), key=lambda j: rr[j].score)
                    for j, rec in enumerate(rr):
                        line = format_sam_record(
                            rec, rd, clipping, rgid=rgid,
                            genome=index.genome,
                            genome_start=int(index.seqdb.starts[rec.contig_index])
                            if rec.contig_index >= 0 else 0,
                            is_primary=(j == best),
                        )
                        f.write(f"{rd.index}\t{_esc(line)}\n")
                elif rd.name in unm:
                    f.write(
                        f"{rd.index}\t{_esc(format_unmapped(rd, rgid=rgid))}\n"
                    )
        elif fmt in ("m0", "m1", "m2", "m3", "m5"):
            from blasr_tpu_torch.output import verbose as _v

            fns = {
                "m0": lambda r, rd: _v.format_m0(r, rd, index),
                "m1": lambda r, rd: _v.format_m1(r),
                "m2": lambda r, rd: _v.format_m2(r, rd, index),
                "m3": lambda r, rd: _v.format_m3(r),
                "m5": lambda r, rd: _v.format_m5(r, rd, index),
            }
            fn = fns[fmt]
            by_name = {rd.name: rd for rd in mine}
            for rec in recs:
                rd = by_name.get(rec.qname)
                if rd is None and fmt in ("m0", "m2", "m5"):
                    continue
                f.write(f"{rec.read_index}\t{_esc(fn(rec, rd))}\n")
        else:
            raise ValueError(f"unknown part format {fmt!r}")
    return recs, unmapped


def _esc(block: str) -> str:
    """Newline-escape a (possibly multi-line, e.g. m0/m2) record block so a
    part file stays one tagged line per record."""
    return block.replace("\\", "\\\\").replace("\n", "\\n")


def _unesc(s: str) -> str:
    import re

    return re.sub(
        r"\\(.)", lambda m: "\n" if m.group(1) == "n" else m.group(1), s
    )


def merge_host_parts(
    out_prefix: str, out_path: str, num_processes: Optional[int] = None,
    header_lines: Optional[Sequence[str]] = None,
) -> int:
    """Merge part files into one output in global read order; returns the
    record count. Pass ``num_processes`` to read exactly that many parts
    (guards against stale part files from a previous differently-sized
    run); None globs whatever exists. ``header_lines`` (e.g. a SAM header
    from output.sam_writer.sam_header) are written once before the body."""
    if num_processes is not None:
        paths = [part_path(out_prefix, i) for i in range(num_processes)]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(f"missing part files: {missing}")
    else:
        paths = sorted(glob.glob(f"{out_prefix}.part*"))
    rows: list[tuple[int, str]] = []
    for p in paths:
        with open(p) as f:
            for line in f:
                gi, _, rest = line.partition("\t")
                rows.append((int(gi), rest.rstrip("\n")))
    rows.sort(key=lambda x: x[0])
    with open(out_path, "w") as f:
        for line in header_lines or ():
            f.write(line + "\n")
        for _, rest in rows:
            f.write(_unesc(rest) + "\n")
    return len(rows)
