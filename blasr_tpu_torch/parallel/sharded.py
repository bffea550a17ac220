"""Contig-block sharded index: large genomes across devices; the port of
``blasr_tpu/parallel/sharded.py``, whose design it keeps:

  * ownership: shard s owns genome positions [lo, hi); its block extends
    ``ovl`` bases on both sides so any candidate window seeded by an owned
    anchor is fully contained in the block. The per-position seed-validity
    mask (pos_ok) is false outside the owned range, so each anchor is found
    by exactly one shard — no duplicate evidence, at most one extra
    (clipped, lower-scoring) alignment when a read straddles a boundary,
    which the best-n merge discards.
  * coordinates: shards map into block-local segment databases; the merge
    re-derives global contig coordinates from (shard offset + local pos)
    against the true SeqDB.
  * MAPQ: per-shard mapQV knows only local competitors; the merge combines
    it with a cross-shard logsumexp over the merged record scores.
  * placement: each shard maps with ``run_mapping(..., device=dev)`` on
    ``devices[s % len(devices)]``; on one card the shards share it. The
    shard caches (``.btshard...npz``, uncompressed) and the routing
    sketches (``.sketch.npy``) are the JAX package's files: either
    package loads what the other wrote.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from blasr_tpu_torch.index.artifacts import GenomeIndex
from blasr_tpu_torch.index.suffix_array import build_suffix_array
from blasr_tpu_torch.core.encode import pack_kmers
from blasr_tpu_torch.io.batching import Read
from blasr_tpu_torch.io.seqdb import SeqDB
from blasr_tpu_torch.params import MappingParams
from blasr_tpu_torch.parallel.mesh import make_mesh, on_device
from blasr_tpu_torch.pipeline.mapper import require_device
from blasr_tpu_torch.pipeline.runner import AlignmentRecord, run_mapping


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    lo: int         # first owned genome position
    hi: int         # one past last owned position
    block_lo: int   # block start (with left overlap)
    block_hi: int   # block end (with right overlap)


def make_shards(
    genome_len: int, n_shards: int, overlap: int
) -> list[ShardSpec]:
    """Split [0, G) into n_shards owned ranges with symmetric overlap."""
    size = math.ceil(genome_len / n_shards)
    out = []
    for s in range(n_shards):
        lo = s * size
        hi = min((s + 1) * size, genome_len)
        if lo >= genome_len:
            break
        out.append(
            ShardSpec(
                lo=lo,
                hi=hi,
                block_lo=max(0, lo - overlap),
                block_hi=min(genome_len, hi + overlap),
            )
        )
    return out


def build_shard_index(
    genome: np.ndarray, seqdb: SeqDB, spec: ShardSpec, k: int
) -> GenomeIndex:
    """Index one genome block; seeds valid only inside the owned range and
    never crossing a true contig boundary."""
    block = genome[spec.block_lo : spec.block_hi]
    # segment database: true contig boundaries clipped to the block
    cuts = [spec.block_lo]
    names = []
    ci0 = int(seqdb.contig_of(spec.block_lo))
    for ci in range(ci0, seqdb.num_contigs):
        s = int(seqdb.starts[ci])
        e = int(seqdb.starts[ci + 1])
        if s >= spec.block_hi:
            break
        names.append(seqdb.names[ci])
        cuts.append(min(e, spec.block_hi))
    starts_local = np.asarray(cuts, dtype=np.int64) - spec.block_lo
    # carry the TRUE per-contig MD5s (SAM @SQ integrity across shards);
    # indexed by contig position, not name (duplicate names are legal)
    md5s = [seqdb.md5s[ci0 + i] for i in range(len(names))]
    seg_db = SeqDB(names, starts_local, md5s)

    proj = (block & 3).astype(np.uint8)
    sa = build_suffix_array(proj)
    keys, valid = pack_kmers(block, k)
    sa_kmers = keys[sa].astype(np.int32)
    pos_ok = valid.copy()
    # ownership mask (anchor dedup across shards)
    own_lo = spec.lo - spec.block_lo
    own_hi = spec.hi - spec.block_lo
    pos_ok[:own_lo] = False
    pos_ok[own_hi:] = False
    # no seed may span a contig boundary
    for s in starts_local[1:-1]:
        pos_ok[max(0, int(s) - (k - 1)) : int(s)] = False
    if len(sa) < 2**31:
        sa = sa.astype(np.int32)
    return GenomeIndex(block.astype(np.uint8), sa, sa_kmers, pos_ok, k, seg_db)


def _globalize(
    rec: AlignmentRecord,
    spec: ShardSpec,
    shard_db: SeqDB,
    seqdb: SeqDB,
) -> Optional[AlignmentRecord]:
    """Re-derive global contig coordinates for a shard-local record."""
    p = rec.path
    g_start = spec.block_lo + int(shard_db.starts[rec.contig_index]) + rec.tstart_fwd
    g_end = g_start + (rec.tend_fwd - rec.tstart_fwd)
    if g_end > seqdb.total_length:
        return None
    ci = int(seqdb.contig_of(g_start))
    c_off = int(seqdb.starts[ci])
    c_len = int(seqdb.starts[ci + 1]) - c_off
    ts_f = g_start - c_off
    te_f = g_end - c_off
    n = rec.qlength
    if rec.tstrand == 0:
        qs, qe = p.q_start, p.q_end
        ts, te = ts_f, te_f
    else:
        qs, qe = n - p.q_end, n - p.q_start
        ts, te = c_len - te_f, c_len - ts_f
    return dataclasses.replace(
        rec,
        tname=seqdb.names[ci],
        qstart=qs,
        qend=qe,
        tstrand=rec.tstrand,
        tstart=ts,
        tend=te,
        tlength=c_len,
        contig_index=ci,
        tstart_fwd=ts_f,
        tend_fwd=te_f,
    )


def _merge_mapqv(records: list[AlignmentRecord]) -> None:
    """Cross-shard MAPQ: per-shard mapQV capped by the logsumexp over the
    merged record scores (Blasr.cpp:2875-2945 math, host-side)."""
    if len(records) < 2:
        return
    ps = np.array([-r.score / 10.0 for r in records])  # log10 prob units
    lse = ps.max() + np.log10(np.sum(np.power(10.0, ps - ps.max())))
    best = int(np.argmax(ps))
    one_minus = max(1.0 - 10.0 ** (ps[best] - lse), 1e-26)
    cross = int(np.clip(-10.0 * np.log10(one_minus), 0, 254))
    for r in records:
        r.mapqv = min(r.mapqv, cross)


def shard_cache_path(
    genome_path: str, n_shards: int, k: int, s: int, overlap: int = 0
) -> str:
    # overlap participates in the key: block bounds depend on it, and a
    # stale cache built for different bounds would silently shift every
    # _globalize coordinate by the overlap delta
    ov = f"o{overlap}" if overlap else ""
    return f"{genome_path}.btshard{n_shards}k{k}{ov}.{s}.npz"


SKETCH_K = 14


def _revcomp_keys(keys: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse-complement of 2-bit-packed k-mers."""
    x = keys.astype(np.int64) ^ ((1 << (2 * k)) - 1)     # complement (b^3)
    # reverse the 2-bit groups within 32 positions, then shift down
    m2 = 0x3333333333333333
    m4 = 0x0F0F0F0F0F0F0F0F
    m8 = 0x00FF00FF00FF00FF
    m16 = 0x0000FFFF0000FFFF
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    x = ((x & m16) << 16) | ((x >> 16) & m16)
    x = ((x & 0xFFFFFFFF) << 32) | ((x >> 32) & 0xFFFFFFFF)
    return x >> (64 - 2 * k)


def _canonical_keys(keys: np.ndarray, k: int) -> np.ndarray:
    rc = _revcomp_keys(keys, k)
    return np.minimum(keys.astype(np.int64), rc)


def build_shard_sketch(block: np.ndarray, k: int = SKETCH_K) -> np.ndarray:
    """Canonical-k-mer presence bitmask of a genome block: 4^k bits packed
    into a (4^k / 8,) uint8 array (~32 MB at k=14). Strand-canonical so one
    probe covers both read orientations."""
    keys, valid = pack_kmers(np.asarray(block, np.uint8), k)
    kk = _canonical_keys(keys[valid], k)
    present = np.zeros(1 << (2 * k), bool)
    present[kk] = True
    return np.packbits(present, bitorder="little")


def sketch_cache_path(
    genome_path: str, n_shards: int, s: int, overlap: int
) -> str:
    return f"{genome_path}.btshard{n_shards}o{overlap}.{s}.sketch.npy"


def load_or_build_sketches(
    genome: np.ndarray, specs: Sequence[ShardSpec], genome_path: Optional[str],
    overlap: int,
) -> list[np.ndarray]:
    """Every shard's routing sketch: loaded from its cache beside
    ``genome_path`` when that is newer than the genome, else built (and
    cached when there is a path)."""
    import os

    sketches = []
    for s_i, spec in enumerate(specs):
        sp = sketch_cache_path(genome_path, len(specs), s_i, overlap) if genome_path else None
        if sp and os.path.exists(sp) and (
            os.path.getmtime(sp) >= os.path.getmtime(genome_path)
        ):
            sketches.append(np.load(sp))
            continue
        sk = build_shard_sketch(genome[spec.block_lo : spec.block_hi])
        if sp:
            try:
                np.save(sp, sk)
            except OSError:
                pass
        sketches.append(sk)
    return sketches


def route_reads(
    reads: Sequence[Read],
    sketches: Sequence[np.ndarray],
    k: int = SKETCH_K,
    max_probes: int = 512,
) -> list[np.ndarray]:
    """Which shards can contain each read? Probes the read's canonical
    k-mers against every shard's presence sketch; a shard whose hit
    fraction clears its own background rate (bit density) by a signal
    margin receives the read, and the TOP-signal shard is always included
    so a marginal true shard cannot be dropped just because some repeat
    copy elsewhere cleared its threshold. Falls back to ALL shards for
    short reads (too few probes to discriminate)."""
    n_shards = len(sketches)
    all_ids = np.arange(n_shards)
    # per-shard background hit rate for a random k-mer (one popcount per
    # sketch, no 268 MB unpackbits temporaries)
    _pop = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)
    fp = np.array([
        float(_pop[sk].sum()) / (len(sk) * 8.0) for sk in sketches
    ])
    out: list[np.ndarray] = []
    for r in reads:
        keys, valid = pack_kmers(np.asarray(r.codes, np.uint8), k)
        kk = _canonical_keys(keys[valid], k)
        if len(kk) > max_probes:
            kk = kk[:: len(kk) // max_probes + 1]
        n = len(kk)
        if n < 64:
            out.append(all_ids)
            continue
        byte = (kk >> 3).astype(np.int64)
        bit = (kk & 7).astype(np.int64)
        fracs = np.array([
            ((sketches[s][byte] >> bit) & 1).mean() for s in range(n_shards)
        ])
        sigma = np.sqrt(np.maximum(fp * (1 - fp), 1e-6) / n)
        excess = fracs - fp
        hit = excess >= np.maximum(0.04, 4 * sigma)
        hit[int(np.argmax(excess))] = True   # top-signal shard always runs
        out.append(all_ids[hit])
    return out


def build_or_load_shards(
    genome: np.ndarray,
    seqdb: SeqDB,
    specs: Sequence[ShardSpec],
    k: int,
    genome_path: Optional[str] = None,
    overlap: int = 0,
) -> list[GenomeIndex]:
    """Shard indexes with on-disk caching (role of the reference's .sa
    auto-discovery, Blasr.cpp:4375-4394 — per shard). Building SA-IS over
    each block inside the serving call costs minutes at hg19 scale; cached
    artifacts load in seconds."""
    import os

    out = []
    for s, spec in enumerate(specs):
        path = (
            shard_cache_path(genome_path, len(specs), k, s, overlap)
            if genome_path else None
        )
        if path and os.path.exists(path) and (
            os.path.getmtime(path) >= os.path.getmtime(genome_path)
        ):
            out.append(GenomeIndex.load(path))
            continue
        idx = build_shard_index(genome, seqdb, spec, k)
        if path:
            try:
                idx.save(path, compress=False)
            except OSError:
                pass
        out.append(idx)
    return out


def run_mapping_sharded(
    genome: np.ndarray,
    seqdb: SeqDB,
    reads: Sequence[Read],
    params: MappingParams,
    n_shards: int,
    k: int = 14,
    devices: Optional[list] = None,
    shard_indexes: Optional[Sequence[GenomeIndex]] = None,
    genome_path: Optional[str] = None,
    concurrent: bool = True,
    lazy_load: bool = False,
    route: bool = False,
    routes: Optional[Sequence[np.ndarray]] = None,
) -> tuple[list[AlignmentRecord], list[str]]:
    """Map reads against an n_shards-way sharded index; merge on host.

    Shards dispatch CONCURRENTLY (one host thread per device, mapping its
    shards in order) so per-device compute and host drains overlap — the
    serving layout for one index too large for a card; shards that share
    a device run one after another. ``devices`` (default: the visible
    CUDA devices) may repeat one device; a device that does not exist
    raises. The records merge in shard order, whatever the threads'
    schedule. Pass ``shard_indexes`` (or ``genome_path`` for the on-disk
    cache) to skip the in-call SA builds.

    ``lazy_load`` (hg19-scale on few devices): each shard's index is
    loaded from the on-disk cache inside its worker and ALL its
    host+device buffers are dropped before the next shard starts — peak
    device memory is one shard's arrays instead of n_shards x. Implies
    serial shard execution when there are fewer devices than shards.
    """
    overlap = params.max_read_len + params.target_pad
    specs = make_shards(len(genome), n_shards, overlap)
    devs = [require_device(d) for d in devices] if devices is not None else make_mesh(0)
    if lazy_load:
        if genome_path is None and shard_indexes is None:
            raise ValueError("lazy_load needs genome_path or shard_indexes")
        if len(devs) < len(specs):
            concurrent = False
    elif shard_indexes is None:
        shard_indexes = build_or_load_shards(
            genome, seqdb, specs, k, genome_path, overlap
        )

    per_read: dict[str, list[AlignmentRecord]] = {}
    all_names = [r.name for r in reads]

    # read routing (``route``): a canonical-k-mer presence sketch per
    # shard decides which shards can contain each read, so a shard only
    # maps (or, in lazy mode, only LOADS) for its candidates — the
    # prefilter that turns all-shards broadcast into ~1-2 shard visits
    shard_reads: list[Sequence[Read]] = [reads] * len(specs)
    if routes is not None and len(specs) > 1:
        # caller-precomputed routing (ShardedServer: one route pass shared
        # with its residency bookkeeping)
        shard_reads = [
            [r for r, rt in zip(reads, routes) if s_i in rt]
            for s_i in range(len(specs))
        ]
    elif route and len(specs) > 1:
        sketches = load_or_build_sketches(genome, specs, genome_path, overlap)
        routes = route_reads(reads, sketches)
        shard_reads = [
            [r for r, rt in zip(reads, routes) if s_i in rt]
            for s_i in range(len(specs))
        ]

    def _load_shard(s: int) -> GenomeIndex:
        if shard_indexes is not None:
            return shard_indexes[s]
        import os

        path = shard_cache_path(genome_path, len(specs), k, s, overlap)
        if os.path.exists(path):
            return GenomeIndex.load(path)
        idx = build_shard_index(genome, seqdb, specs[s], k)
        try:
            idx.save(path, compress=False)
        except OSError:
            pass
        return idx

    def _run_shard(s: int):
        spec = specs[s]
        my_reads = shard_reads[s]
        if not my_reads:
            return []
        idx = _load_shard(s)
        dev = devs[s % len(devs)]
        with on_device(dev):
            recs, _ = run_mapping(idx, my_reads, params, device=dev)
        out = []
        for rec in recs:
            g = _globalize(rec, spec, idx.seqdb, seqdb)
            if g is not None:
                out.append(g)
        if lazy_load:
            # drop this shard's device buffers before the next shard loads
            # (the DeviceIndex cache on the GenomeIndex holds them live)
            idx.__dict__.pop("_torch_device_index_cache", None)
        return out

    # one host thread per device, each mapping its shards in order: threads
    # that share a card contend for the interpreter lock while the walk
    # dispatches its launches (with 4 resident shards on one H100, one
    # thread a shard took 3.4x a one-thread loop's wall and two threads
    # 1.9x; tools/torch_shard_threads.py, PERF.md §6)
    groups: dict = {}
    for s in range(len(specs)):
        groups.setdefault(devs[s % len(devs)], []).append(s)
    if concurrent and len(groups) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(len(groups), 8)) as pool:
            done = list(pool.map(lambda ss: [_run_shard(s) for s in ss], groups.values()))
        by_shard = {s: r for ss, recs in zip(groups.values(), done) for s, r in zip(ss, recs)}
        shard_recs = [by_shard[s] for s in range(len(specs))]
    else:
        shard_recs = [_run_shard(s) for s in range(len(specs))]
    for recs in shard_recs:
        for g in recs:
            per_read.setdefault(g.qname, []).append(g)

    out: list[AlignmentRecord] = []
    unmapped: list[str] = []
    for name in all_names:
        recs = per_read.get(name, [])
        if not recs:
            unmapped.append(name)
            continue
        recs.sort(key=lambda r: r.score)
        keep = recs[: params.best_n]
        _merge_mapqv(recs)
        out.extend(keep)
    return out, unmapped


class ShardedServer:
    """Load-once, serve-many wrapper over ``run_mapping_sharded``.

    Builds (or loads) every shard index and routing sketch ONCE at
    construction; each ``map()`` call then pays only per-call routing +
    mapping — the serving-daemon layout (the lazy per-call loads of
    run_mapping_sharded(lazy_load=True) exist for the one-shot CLI case).
    """

    def __init__(
        self,
        genome: np.ndarray,
        seqdb: SeqDB,
        params: MappingParams,
        n_shards: int,
        k: int = 14,
        genome_path: Optional[str] = None,
        devices=None,
        route: bool = True,
        max_resident: int = 0,
    ):
        self.genome = genome
        self.seqdb = seqdb
        self.params = params
        self.k = k
        self.devices = devices
        self.route = route
        # max_resident > 0: cap how many shards keep DEVICE arrays between
        # calls (LRU eviction): a routed serve that eventually touches
        # every shard must evict or run out of device memory — eviction
        # drops only the device copy; host arrays stay resident and
        # re-upload on the next visit.
        self.max_resident = max_resident
        self._lru: list[int] = []
        overlap = params.max_read_len + params.target_pad
        self.specs = make_shards(len(genome), n_shards, overlap)
        self.indexes = build_or_load_shards(
            genome, seqdb, self.specs, k, genome_path, overlap
        )
        self.genome_path = genome_path
        self._sketches: Optional[list[np.ndarray]] = None
        if route and len(self.specs) > 1:
            self._sketches = load_or_build_sketches(genome, self.specs, genome_path, overlap)

    def map(
        self, reads: Sequence[Read], params: Optional[MappingParams] = None
    ) -> tuple[list[AlignmentRecord], list[str]]:
        p = params or self.params
        # shard geometry (overlap = max_read_len + target_pad) is baked
        # into the cached indexes; a different per-call geometry would
        # shift every _globalize coordinate by the overlap delta
        if (
            p.max_read_len + p.target_pad
            != self.params.max_read_len + self.params.target_pad
        ):
            raise ValueError(
                "per-call params change the shard overlap; construct a new "
                "ShardedServer for a different max_read_len/target_pad"
            )
        routes = (
            route_reads(reads, self._sketches)
            if self._sketches is not None else None
        )
        out = run_mapping_sharded(
            self.genome, self.seqdb, reads, p,
            n_shards=len(self.specs), k=self.k, devices=self.devices,
            shard_indexes=self.indexes, genome_path=self.genome_path,
            route=self.route, routes=routes,
        )
        if self.max_resident:
            used = (
                sorted({int(s) for rt in routes for s in rt})
                if routes is not None else list(range(len(self.specs)))
            )
            self._lru = [s for s in self._lru if s not in used] + used
            resident = [
                s for s in self._lru
                if "_torch_device_index_cache" in self.indexes[s].__dict__
            ]
            for victim in resident[: max(0, len(resident) - self.max_resident)]:
                self.indexes[victim].__dict__.pop("_torch_device_index_cache", None)
        return out
