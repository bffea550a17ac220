"""End-to-end mapping run: reads -> alignment records, on one device or a
batch split over several (``devices``, ``params.ndevices``).

Port of ``blasr_tpu.pipeline.runner.run_mapping``: padded
length-bucketed batches go through ``Mapper.map_batch`` on ``device``
while earlier batches finalize on the host (dispatch-ahead), records are
converted to contig coordinates and filtered. Then the JAX runner's
passes re-map some reads, each through a nested run: the full-depth
re-map under ``adaptive_cd``, the ``-maxExpand`` cascade, band
escalation (reads whose best record shows the narrow-band clipping
signature, through the wide unguided band, keeping the better score) and
the ``-useSensitiveSearch`` retry; ``-placeRepeatsRandomly`` orders tied
records at random. A caller may stream the records batch by batch
(``on_batch``) and resume a run whose first batches were flushed
(``skip_batches``, ``carried``). With
``best_n > 1`` each batch's secondaries (rank >= 1) pass the reference's
host admission and refinement (``pipeline/secondary.py``). A run that
holds reads longer than ``max_read_len`` maps them piecewise
(``pipeline/piecewise.py``).

m4 coordinates: qstrand is always 0; when tstrand == 1 the target interval
is in reverse-complement coordinates of the contig; qstart/qend always
refer to the forward read.
"""

from __future__ import annotations

import dataclasses
import inspect
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from blasr_tpu_torch.index.artifacts import GenomeIndex
from blasr_tpu_torch.io.batching import Read, ReadBatch, batch_reads
from blasr_tpu_torch.ops.transfer import to_host
from blasr_tpu_torch.params import MappingParams
from blasr_tpu_torch.pipeline import secondary, trace
from blasr_tpu_torch.pipeline.mapper import Mapper, WireResult, unpack_result
from blasr_tpu_torch.pipeline.trace import StageClock
from blasr_tpu_torch.pipeline.traceback import AlignmentPath


@dataclasses.dataclass
class MappingMetrics:
    """Per-run counters and host-clock stage timers (``perf_counter``, the
    tracer's clock: with a tracer on, each timer reads its span's
    boundaries)."""

    n_reads: int = 0
    n_batches: int = 0
    n_records: int = 0
    n_unmapped: int = 0
    total_aligned_bases: int = 0
    total_dp_cells: int = 0
    # the DP cells of the batches of the last run_mapping call that
    # finished, its escalation pass aside (under piecewise mapping, the
    # last inner run's): the figure -fullMetrics prints per read, which the
    # JAX package takes from that call's own metrics. ``add`` leaves it
    last_run_dp_cells: int = 0
    dispatch_seconds: float = 0.0   # host time enqueueing device work
    wait_seconds: float = 0.0       # host time blocked on the device + d2h
    finalize_seconds: float = 0.0   # host time turning results into records
    wall_seconds: float = 0.0
    # the passes after the first (each a nested run): reads re-mapped at
    # full depth under adaptive_cd and those whose records it changed;
    # per expand level, [reads re-mapped, reads it mapped]; reads
    # re-mapped through the wide band and those whose score it improved;
    # reads the sensitive retry re-mapped and those whose score it improved
    adaptive_reads: int = 0
    adaptive_changed: int = 0
    expand_levels: dict = dataclasses.field(default_factory=dict)
    escalated_reads: int = 0
    escalation_won: int = 0
    sensitive_reads: int = 0
    sensitive_won: int = 0
    # the -bestn secondary path (inside finalize): host seconds of the
    # admission and the refinement, rank >= 1 records it took, those the
    # min_interval gate dropped, and those that took the SDP chain's span
    # (refined along the chain; ``ops.counters()["secondary"]`` has the rest)
    secondary_seconds: float = 0.0
    secondary_checked: int = 0
    secondary_gated: int = 0
    secondary_replaced: int = 0
    # piecewise mapping (-alignContigs, reads longer than max_read_len):
    # segments and reads passed through the inner runs, records stitched
    # from segments, the SDP fills of the gaps between them, and the host
    # seconds of stitching (fills included)
    piecewise_segments: int = 0
    piecewise_pass_through: int = 0
    piecewise_stitched: int = 0
    piecewise_gap_fills: int = 0
    piecewise_seconds: float = 0.0
    buckets: dict = dataclasses.field(default_factory=dict)

    def add(self, other: "MappingMetrics", fields=None) -> None:
        """Add ``other``'s counters and timers into these: the ``fields``
        named, else every one, the per-bucket counts too. A dict field
        (key -> list of counts) adds key by key."""
        if fields is None:
            fields = [f.name for f in dataclasses.fields(self)
                      if f.name != "last_run_dp_cells"]
        for f in fields:
            mine, theirs = getattr(self, f), getattr(other, f)
            if isinstance(mine, dict):
                for key, counts in theirs.items():
                    acc = mine.setdefault(key, [0] * len(counts))
                    for i, n in enumerate(counts):
                        acc[i] += n
            else:
                setattr(self, f, mine + theirs)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.wall_seconds > 0:
            d["readsPerSecond"] = round(self.n_reads / self.wall_seconds, 2)
        return d


# what a pass's nested run adds into the run's metrics: host time, DP
# cells, the secondary admission and the nested run's own passes
PASS_FIELDS = ("dispatch_seconds", "wait_seconds", "finalize_seconds", "total_dp_cells",
               "secondary_seconds", "secondary_checked", "secondary_gated",
               "secondary_replaced", "adaptive_reads", "adaptive_changed", "expand_levels",
               "escalated_reads", "escalation_won", "sensitive_reads", "sensitive_won")
SENSITIVE_PCT = 80.0   # the sensitive retry's similarity trigger (Blasr.cpp:3498)


@dataclasses.dataclass
class AlignmentRecord:
    """One reported alignment (all coordinates ready for m4 printing)."""

    qname: str
    tname: str
    score: int
    pct_similarity: float
    qstrand: int          # always 0 (blasr convention)
    qstart: int           # forward-read coords
    qend: int
    qlength: int
    tstrand: int          # 0/1
    tstart: int           # fwd coords if tstrand==0 else RC-of-contig coords
    tend: int
    tlength: int
    mapqv: int
    contig_index: int = -1
    tstart_fwd: int = 0   # contig-forward coords, always
    tend_fwd: int = 0
    path: Optional[AlignmentPath] = None
    read_index: int = -1
    nhits_considered: int = 0
    refined: bool = False  # a secondary refined along its SDP chain


def _best_by_read(records) -> dict:
    """Read name -> its best (lowest-score) record, the first of equals."""
    best_by: dict = {}
    for r in records:
        cur = best_by.get(r.qname)
        if cur is None or r.score < cur.score:
            best_by[r.qname] = r
    return best_by


def _escalation_candidates(best_by: dict, params) -> set:
    """Read names whose best record shows the narrow-band clipping signature
    (similarity < 80%, or query coverage < 0.90, < 0.97 above 1536 bp, on a
    narrow-band bucket)."""
    names = set()
    for nm, rec in best_by.items():
        if params.band_width_for(rec.qlength) >= 128:
            continue  # already mapped with a wide band
        qcov = (rec.qend - rec.qstart) / max(rec.qlength, 1)
        cov_thr = 0.97 if rec.qlength > 1536 else 0.90
        if rec.pct_similarity < 80.0 or qcov < cov_thr:
            names.add(nm)
    return names


def _best_pct(records) -> dict:
    """Read name -> the highest similarity among its records."""
    best: dict = {}
    for r in records:
        best[r.qname] = max(best.get(r.qname, 0.0), r.pct_similarity)
    return best


def _replaceable(records, params) -> set:
    """Read names whose records band escalation or the sensitive retry may
    still replace, from the reads' first-pass records: the same triggers
    the passes apply."""
    names: set = set()
    if params.band_escalation and params.narrow_band:
        names |= _escalation_candidates(_best_by_read(records), params)
    if params.sensitive_retry:
        names |= {n for n, p in _best_pct(records).items() if p < SENSITIVE_PCT}
    return names


def _record_keys(records, names) -> dict:
    """Read name -> what its -m 4 lines show of its records, for ``names``."""
    keys: dict = {}
    for r in records:
        if r.qname in names:
            keys.setdefault(r.qname, []).append(
                (r.tname, r.tstrand, r.tstart, r.tend, r.qstart, r.qend, r.score,
                 r.pct_similarity, r.mapqv))
    return keys


def passes_input_filters(read: Read, params: MappingParams) -> bool:
    """The reference's length and quality input filters: a read that fails
    is reported unaligned without entering the pipeline."""
    if len(read) < params.min_read_length:
        return False
    return not (
        params.min_avg_qual > 0 and read.qual is not None
        and len(read.qual) and float(read.qual.mean()) < params.min_avg_qual
    )


def _n_parameters(fn) -> int:
    try:
        return len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return 0


@dataclasses.dataclass
class HeldRead:
    """A read held back from the batch stream because a later pass may
    still replace its records or map it: its first-pass records (none when
    it is unmapped) and whether adaptive_cd's full-depth re-map replaces
    them."""

    records: list
    amb: bool = False

    def summary(self) -> dict:
        """What a resumed run needs of the read (``run_mapping``'s
        ``carried``): the flag, and each record's score, similarity and
        query span in order, which the passes' triggers and merges read."""
        return {"amb": self.amb,
                "records": [[r.score, r.pct_similarity, r.qstart, r.qend, r.qlength]
                            for r in self.records]}


def _carried_record(name: str, row) -> AlignmentRecord:
    """A stand-in for a record of a skipped batch's held read, with the
    fields the passes read."""
    score, pct, qstart, qend, qlength = row
    return AlignmentRecord(qname=name, tname="", score=int(score), pct_similarity=pct,
                           qstrand=0, qstart=int(qstart), qend=int(qend),
                           qlength=int(qlength), tstrand=0, tstart=0, tend=0, tlength=0,
                           mapqv=0)


def run_mapping(
    index: GenomeIndex,
    reads: Sequence[Read],
    params: MappingParams,
    *,
    device: str | torch.device,
    metrics: MappingMetrics | None = None,
    clock: StageClock | None = None,
    fm=None,
    on_batch=None,
    skip_batches: int = 0,
    carried: dict | None = None,
    devices: list | None = None,
    _pass: str = "first",
) -> tuple[list[AlignmentRecord], list[str]]:
    """Map reads on ``device``; returns (alignments, unmapped read names).
    ``devices`` (or ``params.ndevices``) splits each batch over several
    devices, as ``Mapper`` says.

    After the first pass over the batches come the JAX package's passes,
    in its order, each a nested run over the reads it re-maps: the
    full-depth re-map of the reads with a second admitted window
    (``adaptive_cd``: the first pass runs one DP window a read), the
    expand cascade (``max_expand`` above ``min_expand``: unmapped reads at
    each wider seed level), band escalation, and the sensitive retry
    (``sensitive_retry``: unmapped reads and those below 80% similarity,
    with twice the candidates and anchors); ``place_repeats_randomly``
    orders a read's tied records at random from ``random_seed``.

    ``metrics``, when given, receives the run's counters and timers;
    ``clock`` (``pipeline/trace.StageClock``) the run's spans: ``run``
    (its pass, ``_pass``; each pass's nested run opens its own), per batch
    ``dispatch`` (the copies to the device and the step's stages),
    ``fetch`` (the wait for the result) and ``finalize`` (with a
    ``secondary`` span per rank >= 1 record admitted and a ``refine`` span
    per batch whose secondaries are refined), and ``stitch`` under
    piecewise mapping; a
    synchronising clock also splits the device work by stage (use it only
    in a measurement run); ``fm`` (an
    ``index.fm.FMIndex``) anchors by FM backward search (``-bwt``), and
    ``index`` may then hold no suffix array. With ``auto_segment`` on,
    a run holding reads longer than ``max_read_len`` goes through
    ``pipeline/piecewise.run_mapping_piecewise``, which maps those reads
    as segments and stitches them.

    ``on_batch(bi, records, unmapped_names[, held])`` fires after each
    batch finalizes, in batch order. The reads a later pass may still
    replace or map are held back from it; a callback of 4 parameters also
    gets ``held``, a dict from each of those names to its ``HeldRead``.
    Their resolved records and unmapped names go out in one final
    ``on_batch(-1, records, unmapped_names[, {}])``: the streamed records
    are the returned ones. ``skip_batches`` skips the first batches of the
    deterministic batching (a resumed run). ``carried`` maps the names
    held back in those batches to their ``HeldRead.summary()``: they join
    this run's passes as they stood after the first pass, so each pass
    maps the run's whole candidate set with the batch mates of the
    uninterrupted run; the final call delivers those a pass replaced or
    left unmapped, the others keep their first-pass records. With
    ``on_batch`` or ``skip_batches``, reads longer than ``max_read_len``
    are truncated to it, as the JAX package does, not mapped piecewise."""
    streamed = on_batch is not None or skip_batches > 0
    if (params.auto_segment and not streamed and reads
            and max(len(r) for r in reads) > params.max_read_len):
        # segmentation bounds each DP's indel drift (W/2 per segment) and
        # the stitcher restores whole-read records
        from blasr_tpu_torch.pipeline.piecewise import run_mapping_piecewise

        return run_mapping_piecewise(
            index, reads, params, device=device, metrics=metrics, clock=clock, fm=fm,
            split_if_longer=params.max_read_len, devices=devices, _pass=_pass,
        )
    met = metrics if metrics is not None else MappingMetrics()
    t_run0 = trace.begin(clock, "run", pass_name=_pass)
    # adaptive candidate depth: a read without a second admitted window
    # maps alike at any depth, so the first pass runs one DP window a read
    # and the flagged reads are re-mapped at full depth, their records
    # replaced wholesale
    adaptive = params.adaptive_cd and params.best_n == 1 and params.dp_candidates > 1
    map_params = dataclasses.replace(params, n_dp_candidates=1) if adaptive else params
    mapper = Mapper(index, map_params, device=device, clock=clock, fm=fm, devices=devices)
    out: list[AlignmentRecord] = []
    unmapped: list[str] = []
    if params.min_read_length > 0 or params.min_avg_qual > 0:
        unmapped.extend(r.name for r in reads if not passes_input_filters(r, params))
        reads = [r for r in reads if passes_input_filters(r, params)]

    inflight: deque = deque()
    escalate = params.band_escalation and bool(params.narrow_band)
    expand = params.max_expand > params.min_expand
    # streamed == returned: hold back the reads a later pass may replace,
    # and the unmapped reads when a pass may still map them
    hold_mapped = on_batch is not None and (escalate or params.sensitive_retry)
    hold_unmapped = on_batch is not None and (expand or params.sensitive_retry)
    held_names: set[str] = set()
    adaptive_names: set[str] = set()
    on_batch_4 = on_batch is not None and _n_parameters(on_batch) >= 4
    first_pass_cells = 0

    def drain_one():
        bi, batch, res = inflight.popleft()
        t0 = trace.begin(clock, "fetch", batch=(_pass, bi))
        # one d2h copy per batch; it waits for the batch's device work
        res = res._replace(wire=to_host(res.wire, clock))
        t1 = trace.end(clock)
        met.wait_seconds += (t1 - t0) * 1e-9
        t1 = trace.begin(clock, "finalize", batch=(_pass, bi))
        out_b, unm_b = _finalize_batch(mapper, batch, res, met)
        amb: set[str] = set()
        if adaptive:
            ambig = unpack_result(res, map_params.dp_candidates).cand_ambig
            amb = {batch.names[b] for b in range(len(batch.names))
                   if batch.indices[b] >= 0 and ambig[b]}
            adaptive_names.update(amb)
        out.extend(out_b)
        unmapped.extend(unm_b)
        if on_batch is not None:
            hold = set(amb)
            if hold_mapped:
                hold |= _replaceable(out_b, params)
            if hold_unmapped:
                hold.update(unm_b)
            held = {n: HeldRead([], n in amb) for n in batch.names if n in hold}
            for r in out_b:
                if r.qname in hold:
                    held[r.qname].records.append(r)
            held_names.update(hold)
            stream_b = [r for r in out_b if r.qname not in hold]
            stream_u = [n for n in unm_b if n not in hold]
            if on_batch_4:
                on_batch(bi, stream_b, stream_u, held)
            else:
                on_batch(bi, stream_b, stream_u)
        met.finalize_seconds += (trace.end(clock) - t1) * 1e-9
        met.n_batches += 1
        met.n_records += len(out_b)
        for r in out_b:
            if r.path is not None:
                met.total_aligned_bases += r.path.n_aligned

    for bi, batch in enumerate(batch_reads(reads, params.batch_size, params.max_read_len)):
        if bi < skip_batches:
            continue
        t0 = trace.begin(clock, "dispatch", batch=(_pass, bi))
        res = mapper.map_batch(batch.codes, batch.lengths, batch.qual)
        inflight.append((bi, batch, res))
        met.dispatch_seconds += (trace.end(clock) - t0) * 1e-9
        bk = met.buckets.setdefault(int(batch.codes.shape[1]), [0, 0])
        bk[0] += 1
        bk[1] += int((batch.indices >= 0).sum())
        # at the full depth under adaptive_cd, as the JAX package counts them
        first_pass_cells += (
            (2 * batch.max_len + params.target_pad - 1)
            * params.band_width_for(batch.max_len)
            * params.dp_candidates
            * batch.batch_size
        )
        if len(inflight) > params.dispatch_ahead:
            drain_one()
    while inflight:
        drain_one()
    met.total_dp_cells += first_pass_cells

    # the held reads of skipped batches enter the passes as stand-ins for
    # their first-pass records, ahead of this run's, as their batches were
    carried = carried or {}
    stand_ins: list[AlignmentRecord] = []
    for name, c in carried.items():
        if c["amb"]:
            adaptive_names.add(name)
        stand_ins += [_carried_record(name, row) for row in c["records"]]
    out = stand_ins + out
    unmapped = [n for n, c in carried.items() if not c["records"]] + unmapped
    stand_in_ids = {id(r) for r in stand_ins}

    def nested(name, sub_reads, p):
        sub = MappingMetrics()
        recs, unm = run_mapping(index, sub_reads, p, device=device, metrics=sub,
                                clock=clock, fm=fm, devices=devices, _pass=name)
        met.add(sub, PASS_FIELDS)
        return recs, unm

    if adaptive and adaptive_names:
        retry_reads = [r for r in reads if r.name in adaptive_names]
        r2, u2 = nested("adaptive", retry_reads, dataclasses.replace(
            params, adaptive_cd=False, band_escalation=False, sensitive_retry=False,
            max_expand=params.min_expand))
        before, after = _record_keys(out, adaptive_names), _record_keys(r2, adaptive_names)
        met.adaptive_reads += len(retry_reads)
        met.adaptive_changed += sum(before.get(n) != after.get(n) for n in adaptive_names)
        out = [r for r in out if r.qname not in adaptive_names] + r2
        unmapped = [u for u in unmapped if u not in adaptive_names] + u2
    if expand and unmapped:
        # the expand cascade (Blasr.cpp:2554-2578): reads with no
        # sufficient match re-run at each wider seed level in turn
        retry_names = set(unmapped)
        retry_reads = [r for r in reads if r.name in retry_names]
        for e in range(params.min_expand + 1, params.max_expand + 1):
            if not retry_reads:
                break
            r2, u2 = nested(f"expand.{e}", retry_reads, dataclasses.replace(
                params, min_expand=e, max_expand=e, sensitive_retry=False))
            got = {rec.qname for rec in r2}
            level = met.expand_levels.setdefault(e, [0, 0])
            level[0] += len(retry_reads)
            level[1] += len(got)
            out.extend(r2)
            unmapped = [u for u in unmapped if u not in got]
            still = set(u2)
            retry_reads = [r for r in retry_reads if r.name in still]
    if escalate:
        # re-map only the reads the narrow band visibly clipped, through the
        # length-scaled wide unguided band, and keep the better best score
        best_by = _best_by_read(out)
        retry_names = _escalation_candidates(best_by, params)
        retry_reads = [r for r in reads if r.name in retry_names]
        if retry_reads:
            r2, _ = nested("escalate", retry_reads, dataclasses.replace(
                params, band_escalation=False, sensitive_retry=False,
                narrow_band=0, guided_band=False))
            best2: dict[str, int] = {}
            for r in r2:
                best2[r.qname] = min(best2.get(r.qname, 0), r.score)
            use_retry = {n for n, s2 in best2.items() if s2 < best_by[n].score}
            met.escalated_reads += len(retry_reads)
            met.escalation_won += len(use_retry)
            out = [r for r in out if r.qname not in use_retry] + [
                r for r in r2 if r.qname in use_retry
            ]
    if params.sensitive_retry:
        # the reference's sensitive retry (Blasr.cpp:3498-3507): unmapped
        # reads and those below 80% similarity re-map with twice the
        # candidates and anchors; the better best score wins (a read with
        # no first-pass record takes any retry record, as in the JAX runner)
        retry_names = set(unmapped) | {
            n for n, pct in _best_pct(out).items() if pct < SENSITIVE_PCT}
        retry_reads = [r for r in reads if r.name in retry_names]
        if retry_reads:
            r2, u2 = nested("sensitive", retry_reads, dataclasses.replace(
                params, sensitive_retry=False,
                n_candidates=min(params.n_candidates * 2, 16),
                max_anchors_per_read=params.max_anchors_per_read * 2,
                max_anchors_per_position=params.max_anchors_per_position * 2))
            best2 = {}
            for r in r2:
                best2[r.qname] = min(best2.get(r.qname, 0), r.score)
            best1: dict[str, int] = {}
            for r in out:
                if r.qname in retry_names:
                    best1[r.qname] = min(best1.get(r.qname, 0), r.score)
            use_retry = {n for n, s2 in best2.items() if s2 < best1.get(n, 0)}
            met.sensitive_reads += len(retry_reads)
            met.sensitive_won += len(use_retry)
            out = [r for r in out if r.qname not in use_retry] + [
                r for r in r2 if r.qname in use_retry
            ]
            unmapped = [u for u in unmapped if u not in best2]
    late = held_names | set(carried)
    if on_batch is not None and late:
        extra = [r for r in out if r.qname in late and id(r) not in stand_in_ids]
        extra_u = [u for u in unmapped if u in late]
        if extra or extra_u:
            if on_batch_4:
                on_batch(-1, extra, extra_u, {})
            else:
                on_batch(-1, extra, extra_u)
    if stand_ins:
        out = [r for r in out if id(r) not in stand_in_ids]
    order = {r.name: i for i, r in enumerate(reads)}
    if params.place_repeats_randomly:
        # -placeRepeatsRandomly (Blasr.cpp:3041-3086): a read's tied records
        # in a random order, one draw per record in the order of ``out``
        rng = np.random.default_rng(params.random_seed)
        tie = {id(a): rng.random() for a in out}
        out.sort(key=lambda a: (order.get(a.qname, 1 << 30), a.score, tie[id(a)]))
    else:
        out.sort(key=lambda a: (order.get(a.qname, 1 << 30), a.score))
    met.n_reads = len(reads)
    met.n_unmapped = len(unmapped)
    met.last_run_dp_cells = first_pass_cells
    met.wall_seconds = (trace.end(clock) - t_run0) * 1e-9
    return out, unmapped


def _paths_from_device(res) -> list[Optional[AlignmentPath]]:
    """AlignmentPath objects from the compact device traceback."""
    out: list[Optional[AlignmentPath]] = []
    for i in range(len(res.sel_score)):
        if res.sel_score[i] >= 0 or res.nops[i] == 0:
            out.append(None)
            continue
        out.append(
            AlignmentPath(
                q_start=int(res.q_start[i]),
                q_end=int(res.q_end[i]),
                t_start=int(res.t_start[i]),
                t_end=int(res.t_end[i]),
                ops=None,
                packed=res.moves_packed[i] if res.moves_packed.shape[1] else None,
                packed_nops=int(res.nops[i]),
                score=int(res.sel_score[i]),
                n_match=int(res.n_match[i]),
                n_mismatch=int(res.n_mismatch[i]),
                n_ins=int(res.n_ins[i]),
                n_del=int(res.n_del[i]),
            )
        )
    return out


def _finalize_batch(
    mapper: Mapper, batch: ReadBatch, device_res: WireResult, met: MappingMetrics
) -> tuple[list[AlignmentRecord], list[str]]:
    """Records of one batch: the -bestn secondary tail
    (``secondary.admit_and_refine``), contig coordinates and the reporting
    filters (maxScore, pct identity, alignment length, mapQV)."""
    params = mapper.params
    seqdb = mapper.index.seqdb
    res = unpack_result(device_res, params.dp_candidates)

    scores = res.sel_score
    t0 = res.sel_t0.astype(np.int64)
    strand = res.sel_strand
    valid = res.sel_valid
    mapqv = res.mapqv
    qlens_sel = np.repeat(batch.lengths, params.best_n)
    paths = _paths_from_device(res)

    records: list[AlignmentRecord] = []
    mapped_reads: set[int] = set()
    B = batch.codes.shape[0]
    lens = seqdb.lengths()
    found = [(i2, path, int(scores[i2])) for i2, path in enumerate(paths)
             if path is not None and valid[i2] and batch.indices[i2 // params.best_n] >= 0]
    kept = secondary.admit_and_refine(mapper, batch, res, found, met)
    for i2, path, score, refined in kept:
        b = i2 // params.best_n
        if score > params.max_score:
            continue
        if path.pct_similarity < params.min_pct_similarity:
            continue
        if path.pct_similarity > params.max_pct_identity:
            continue
        if path.n_aligned < params.min_align_length:
            continue
        if int(mapqv[i2]) < params.min_map_qv:
            continue
        g_start = int(t0[i2]) + path.t_start
        g_end = int(t0[i2]) + path.t_end
        if g_start < 0 or g_end > seqdb.total_length:
            continue
        ci = int(seqdb.contig_of(g_start))
        c_off = int(seqdb.starts[ci])
        c_len = int(lens[ci])
        ts_f = g_start - c_off
        te_f = g_end - c_off
        n = int(qlens_sel[i2])
        st = int(strand[i2])
        if st == 0:
            qs, qe = path.q_start, path.q_end
            ts, te = ts_f, te_f
        else:
            qs, qe = n - path.q_end, n - path.q_start
            ts, te = c_len - te_f, c_len - ts_f
        records.append(
            AlignmentRecord(
                qname=batch.names[b],
                tname=seqdb.names[ci],
                score=score,
                pct_similarity=round(path.pct_similarity, 4),
                qstrand=0,
                qstart=qs,
                qend=qe,
                qlength=n,
                tstrand=st,
                tstart=ts,
                tend=te,
                tlength=c_len,
                mapqv=int(mapqv[i2]),
                contig_index=ci,
                tstart_fwd=ts_f,
                tend_fwd=te_f,
                path=path,
                read_index=int(batch.indices[b]),
                refined=refined,
            )
        )
        mapped_reads.add(b)

    unmapped = [
        batch.names[b]
        for b in range(B)
        if batch.indices[b] >= 0 and b not in mapped_reads
    ]
    return records, unmapped
