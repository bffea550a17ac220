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
``best_n > 1`` each secondary (rank >= 1) passes the reference's host
admission (``pipeline/secondary_refine.py``: SDP over the candidate's
chain, the ``min_interval`` anchor gate, ``-maxScore`` on the SDP score);
where the SDP chain's span and the DP's disagree, the secondary is
refined along the chain (the reference's RefineAlignment: one guided DP
call and one walk a batch) and ``-maxScore`` cuts the refined score. A
run that
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
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from blasr_tpu_torch import native
from blasr_tpu_torch.index.artifacts import GenomeIndex
from blasr_tpu_torch.io.batching import Read, ReadBatch, batch_reads
from blasr_tpu_torch.ops import count_secondary
from blasr_tpu_torch.ops.banded_align import (
    KNOT_SPACING,
    QOFF_NUM_HALF,
    QV_NEUTRAL,
    QV_NEUTRAL_DUAL,
    AlignScores,
    make_qoff_knots,
)
from blasr_tpu_torch.ops.traceback_device import (
    pack_codes_rows,
    packed_width,
    walk_arrows_device,
)
from blasr_tpu_torch.ops.transfer import to_device, to_host
from blasr_tpu_torch.params import MappingParams
from blasr_tpu_torch.pipeline import mapper as mapper_mod
from blasr_tpu_torch.pipeline import trace
from blasr_tpu_torch.pipeline.mapper import (
    Mapper,
    WireResult,
    host_qual,
    unpack_result,
)
from blasr_tpu_torch.pipeline.secondary_refine import revcomp_codes, sum_anchors_window
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


# RefineAlignment's band (GuidedAlign, 16 cells each side of the guide,
# Blasr.cpp:833-916)
REFINE_BAND = 32


class _Guide(NamedTuple):
    """A secondary that took the SDP chain's span, as its refinement takes
    it: its batch row and strand, the chain's span of the oriented read,
    the genome window around the chain's span (global, inside its contig),
    the chain's blocks as (oriented read, global genome, length), and the
    DP item's window start, the origin of the record's target coordinates."""

    row: int
    strand: int
    q_lo: int
    q_hi: int
    g_lo: int
    g_hi: int
    blocks: list
    t0: int


def _count(met: Optional[MappingMetrics], name: str) -> None:
    """One event of the secondary path: the process's counter
    (``ops.counters()["secondary"]``) and the run's ``secondary_<name>``
    where ``MappingMetrics`` has one."""
    count_secondary(name)
    field = "secondary_" + name
    if met is not None and hasattr(met, field):
        setattr(met, field, getattr(met, field) + 1)


def _host_lut(index: GenomeIndex) -> np.ndarray:
    """``index.lut()``'s key-prefix table, made once per index: the C++
    anchor list's searches start from it."""
    lut = getattr(index, "_host_lut", None)
    if lut is None:
        lut = index._host_lut = index.lut()[0]
    return lut


def _admit_secondary(
    mapper: Mapper, batch: ReadBatch, res, b: int, i2: int,
    path: AlignmentPath, anchor_cache: dict, met: MappingMetrics,
) -> Optional[tuple[Optional[AlignmentPath], int, Optional[_Guide]]]:
    """The -bestn secondary admission of rank >= 1 record ``i2`` (row ``b``
    of the batch), reference semantics: each candidate interval's reported
    alignment is its SDPAlign (Local, detailed) result and the -maxScore cut
    acts on THAT score (AlignIntervals Blasr.cpp:1716-1724 ->
    RemoveLowQualityAlignments :2618 truncation). Returns None when the
    reference never emits the record: no chain, an anchor sum over the
    interval window at or below ``min_interval``, or an SDP score above
    ``max_score``. Else (path, score, None) with the DP's path and score
    when the SDP chain covers the same span (0.9 overlap on both axes), or
    (None, SDP score, guide) when the record takes the chain's span: the
    batch's refinement aligns it along the chain (``_refine_secondaries``).
    Both SDP passes and the anchor list run in C++ (``native``) when the
    host library is built, and are counted ``native`` then."""
    params = mapper.params
    index = mapper.index
    seqdb = index.seqdb
    genome = index.genome
    _count(met, "checked")
    use_native = native.available()
    if use_native:
        _count(met, "native")
    sdp_align = native.sdp_interval_align if use_native else native.sdp_interval_align_plain
    st = int(res.sel_strand[i2])
    n_b = int(batch.lengths[b])
    qc = batch.codes[b, :n_b]
    if st == 1:
        qc = revcomp_codes(qc)
    t0_i = int(res.sel_t0[i2])
    # PASS 1, chain discovery: SDP Local on an unstretched window around
    # the device chain corners with end matching off (prefix_len=0, so
    # window-edge junk cannot seed the chain); its span reproduces the
    # reference's interval corners
    cd_i = int(res.sel_cd[i2])
    g_lo_ch = int(res.cand_tlo[b, cd_i])
    g_hi_ch = int(res.cand_thi[b, cd_i])
    g_mid = (g_lo_ch + g_hi_ch) // 2
    ci_w = int(seqdb.contig_of(min(max(g_mid, 0), seqdb.total_length - 1)))
    c_lo, c_hi = int(seqdb.starts[ci_w]), int(seqdb.starts[ci_w + 1])
    w0_lo = max(g_lo_ch - 64, c_lo)
    w0_hi = min(g_hi_ch + 64, c_hi)
    sdp_kw = dict(
        word=params.sdp_tuple_size,
        match=params.match_score, mismatch=params.mismatch_score,
        ins=params.insertion_score, dele=params.deletion_score,
        indel_rate=params.indel_rate * 3,
        affine_open=params.affine_open,
        affine_extend=params.affine_extend,
    )
    _, b0 = sdp_align(qc, genome[w0_lo:w0_hi], prefix_len=0, **sdp_kw)
    if not b0:
        _count(met, "cut_sdp")
        return None
    q_lo0 = b0[0][0]
    q_hi0 = b0[-1][0] + b0[-1][2]
    t_lo0 = w0_lo + b0[0][1]
    t_hi0 = w0_lo + b0[-1][1] + b0[-1][2]
    # interval-formation gate (StoreLargestIntervals minSize: SumAnchors
    # over a readLen*(1+indelRate) window holding the cluster must EXCEED
    # minInterval, FindMaxInterval.h:479); the anchor list of a (row,
    # strand) is built once per batch, from the host's suffix array.
    # FM-only indexes (-bwt) hold no suffix array and skip the gate, as the
    # JAX runner does
    if len(index.sa):
        L_int = int(n_b * (1 + params.indel_rate))
        ws_lo = max(min(t_lo0, t_hi0 - L_int), c_lo)
        ws_hi = min(max(t_hi0, t_lo0 + L_int), c_hi)
        akey = (b, st)
        if akey not in anchor_cache:
            args = (qc, genome, index.sa, index.sa_kmers, index.k)
            anchor_cache[akey] = (
                native.reference_anchor_list(*args, min_match=params.min_match_length,
                                             lut=_host_lut(index))
                if use_native else
                native.reference_anchor_list_plain(*args, min_match=params.min_match_length))
        _aq, at_r, al_r = anchor_cache[akey]
        if sum_anchors_window(at_r, al_r, ws_lo, ws_hi) <= params.min_interval:
            _count(met, "gated")
            return None
    # PASS 2, the reference's aligned interval: chain corners stretched by
    # approximateMaxInsertionRate=1.3 times the unaligned read prefix and
    # suffix (Blasr.cpp:1247-1263), full SDPAlign (Local, detailed,
    # sdpPrefix=50)
    w_lo = max(int(t_lo0 - q_lo0 * 1.3), c_lo)
    w_hi = min(int(t_hi0 + (n_b - q_hi0) * 1.3), c_hi)
    sdp_sc, sdp_blocks = sdp_align(qc, genome[w_lo:w_hi], **sdp_kw)
    if not sdp_blocks or sdp_sc > params.max_score:
        _count(met, "cut_sdp")
        return None
    q_s2 = sdp_blocks[0][0]
    q_e2 = sdp_blocks[-1][0] + sdp_blocks[-1][2]
    t_s2 = w_lo + sdp_blocks[0][1] - t0_i
    t_e2 = w_lo + sdp_blocks[-1][1] + sdp_blocks[-1][2] - t0_i

    def _agree(lo1, hi1, lo2, hi2):
        ov = min(hi1, hi2) - max(lo1, lo2)
        return ov / max(hi1 - lo1, hi2 - lo2, 1) >= 0.9

    if _agree(path.q_start, path.q_end, q_s2, q_e2) and _agree(
            path.t_start, path.t_end, t_s2, t_e2):
        return path, int(res.sel_score[i2]), None
    _count(met, "replaced")
    # the genome window: the chain's span, widened by the band after it and
    # by a knot spacing before it, so that the chain's first cell sits on a
    # knot (query 0, target KNOT_SPACING) and the band's clip at query 0
    # bends the knots' lerp only before it
    guide = _Guide(
        row=b, strand=st, q_lo=q_s2, q_hi=q_e2,
        g_lo=max(t0_i + t_s2 - KNOT_SPACING, c_lo),
        g_hi=min(t0_i + t_e2 + REFINE_BAND // 2, c_hi),
        blocks=[(bq, w_lo + bt, bl) for bq, bt, bl in sdp_blocks], t0=t0_i,
    )
    return None, sdp_sc, guide


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _chain_knots(guides: Sequence[_Guide], S: int, L: int, W: int) -> np.ndarray:
    """(I, NK) guide knots of the refinement's band, the role of the guide
    that RefineAlignment's GuidedAlign builds from the alignment's blocks
    (Blasr.cpp:833-916): the guided DP's knots (``make_qoff_knots``) with
    each block's first and last cell as anchors in the item's frame (query
    from ``q_lo``, target from ``g_lo``), so the band of ``W`` cells is
    centred on them, lerped between them and along the diagonal (slope
    1/2, ``QOFF_NUM_HALF``) before the first and after the last."""
    A = 2 * max(len(g.blocks) for g in guides)
    a = np.zeros((len(guides), A), np.int32)
    v = np.zeros((len(guides), A), np.int32)
    mask = np.zeros((len(guides), A), bool)
    for i, g in enumerate(guides):
        bl = np.asarray(g.blocks, np.int64)
        q, t, last = bl[:, 0] - g.q_lo, bl[:, 1] - g.g_lo, bl[:, 2] - 1
        n = 2 * len(bl)
        a[i, :n] = np.stack([q + t, q + t + 2 * last], axis=1).ravel()
        v[i, :n] = np.stack([q, q + last], axis=1).ravel() - W // 2
        mask[i, :n] = True
    return make_qoff_knots(torch.from_numpy(a), torch.from_numpy(v), torch.from_numpy(mask),
                           S, L, W, diag=0, num=QOFF_NUM_HALF).numpy()


def _refine_secondaries(mapper: Mapper, batch: ReadBatch,
                        guides: list[_Guide]) -> list[Optional[AlignmentPath]]:
    """RefineAlignment (Blasr.cpp:799; its default guided mode, :833-916)
    of a batch's secondaries that took the SDP chain's span: each chain's
    query span against its genome window, with the read's phred stream,
    in one guided DP call with arrows whose band of ``REFINE_BAND`` cells
    follows the chain's blocks (``_chain_knots``), then
    one walk with moves; one copy in, one fetch. Returns each guide's
    path (its score the DP's), None where the DP found no alignment. The
    DP is looked up on ``pipeline.mapper`` at the call, as the batch's is."""
    params = mapper.params
    genome = mapper.index.genome
    W = REFINE_BAND
    I = len(guides)
    # room for half a band past the longest span, so the band's clip at
    # L - W leaves the chain's last cells inside it
    L = _round8(max(g.q_hi - g.q_lo for g in guides) + W // 2)
    T = _round8(max(g.g_hi - g.g_lo for g in guides))
    S = L + T - 1
    knots = _chain_knots(guides, S, L, W)
    NK = knots.shape[1]
    qual_rows = host_qual(batch.qual, params)
    query = np.full((I, L), 4, np.uint8)
    target = np.full((I, T), 5, np.uint8)
    bounds = np.zeros((3, I), np.int32)         # qlen, tlo, thi
    qual = None
    if qual_rows is not None:
        neutral = QV_NEUTRAL_DUAL if qual_rows.dtype == np.int16 else QV_NEUTRAL
        qual = np.full((I, L), neutral, qual_rows.dtype)
    for i, g in enumerate(guides):
        n_b = int(batch.lengths[g.row])
        codes = batch.codes[g.row, :n_b]
        if g.strand:
            codes = revcomp_codes(codes)
        n_q = g.q_hi - g.q_lo
        query[i, :n_q] = codes[g.q_lo : g.q_hi]
        if qual is not None:
            row = qual_rows[g.row, :n_b]
            qual[i, :n_q] = (row[::-1] if g.strand else row)[g.q_lo : g.q_hi]
        target[i, : g.g_hi - g.g_lo] = genome[g.g_lo : g.g_hi]
        bounds[0, i] = n_q
        bounds[2, i] = g.g_hi - g.g_lo
    # every input in one copy: the int32 parts first, so each part's byte
    # offset is a multiple of its item size (L and T are multiples of 8)
    parts = [bounds.reshape(-1).view(np.uint8), knots.reshape(-1).view(np.uint8),
             query.reshape(-1), target.reshape(-1)]
    if qual is not None:
        parts.append(qual.reshape(-1).view(np.uint8))
    buf = to_device(np.concatenate(parts), mapper.device, mapper.clock)
    n_int = 4 * (3 + NK) * I
    head = buf[:n_int].view(torch.int32)
    query_t = buf[n_int : n_int + I * L].view(I, L)
    target_t = buf[n_int + I * L : n_int + I * (L + T)].view(I, T)
    qual_t = None
    if qual is not None:
        qual_t = buf[n_int + I * (L + T) :].view(torch.int16 if qual.dtype == np.int16
                                               else torch.uint8).view(I, L)
    knots_t = head[3 * I :].view(I, NK)
    scores = AlignScores(
        match=params.match_score, mismatch=params.mismatch_score,
        insertion=params.insertion_score, deletion=params.deletion_score,
        affine_open=params.affine_open, affine_extend=params.affine_extend,
        matrix=params.score_matrix,
    )
    res = mapper_mod.banded_align(
        query_t, head[:I], target_t, head[I : 2 * I], head[2 * I : 3 * I], None, qual_t,
        knots=knots_t, scores=scores, with_traceback=True, band_width=W,
    )
    tb = walk_arrows_device(res.arrows, None, res.best_a, res.best_w, res.score,
                            with_moves=True, qoff_knots=knots_t)
    P = packed_width(S)
    moves = pack_codes_rows(tb.moves_codes, tb.nops, P)
    fields = torch.stack([res.score, tb.nops, tb.q_start, tb.q_end, tb.t_start, tb.t_end,
                          tb.n_match, tb.n_mismatch, tb.n_ins, tb.n_del]).to(torch.int32)
    host = to_host(torch.cat([fields.reshape(-1).view(torch.uint8), moves.reshape(-1)]),
                   mapper.clock)
    score, nops, qs, qe, ts, te, nm, nx, ni, nd = host[: 40 * I].view(np.int32).reshape(10, I)
    mv = host[40 * I :].reshape(I, P)
    _count(None, "refine_calls")
    out: list[Optional[AlignmentPath]] = []
    for i, g in enumerate(guides):
        if score[i] >= 0 or nops[i] == 0:
            out.append(None)
            continue
        shift = g.g_lo - g.t0
        out.append(AlignmentPath(
            q_start=g.q_lo + int(qs[i]), q_end=g.q_lo + int(qe[i]),
            t_start=shift + int(ts[i]), t_end=shift + int(te[i]),
            ops=None, packed=mv[i], packed_nops=int(nops[i]), score=int(score[i]),
            n_match=int(nm[i]), n_mismatch=int(nx[i]), n_ins=int(ni[i]), n_del=int(nd[i]),
        ))
    return out


def _finalize_batch(
    mapper: Mapper, batch: ReadBatch, device_res: WireResult, met: MappingMetrics
) -> tuple[list[AlignmentRecord], list[str]]:
    """Records of one batch: the secondary admission of rank >= 1 records
    and the refinement of those that took the SDP chain's span (``best_n >
    1``), contig coordinates and the reporting filters (maxScore, pct
    identity, alignment length, mapQV)."""
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
    anchor_cache: dict = {}   # (batch row, strand) -> reference anchor list
    kept: list[tuple[int, Optional[AlignmentPath], int]] = []  # (i2, path, score)
    guides: dict[int, _Guide] = {}                             # kept's index -> guide
    for i2, path in enumerate(paths):
        b = i2 // params.best_n
        if batch.indices[b] < 0:
            continue  # padding row
        if path is None or not valid[i2]:
            continue
        score = int(scores[i2])
        if i2 % params.best_n >= 1:
            t_adm = trace.begin(mapper.clock, "secondary")
            admitted = _admit_secondary(mapper, batch, res, b, i2, path, anchor_cache, met)
            met.secondary_seconds += (trace.end(mapper.clock) - t_adm) * 1e-9
            if admitted is None:
                continue
            path, score, guide = admitted
            if guide is not None:
                guides[len(kept)] = guide
        kept.append((i2, path, score))
    if guides:
        t_ref = trace.begin(mapper.clock, "refine")
        refined = _refine_secondaries(mapper, batch, list(guides.values()))
        met.secondary_seconds += (trace.end(mapper.clock) - t_ref) * 1e-9
        for k, path in zip(guides, refined):
            # RemoveLowQuality after RefineAlignments (Blasr.cpp:2615-2618)
            ok = path is not None and path.score <= params.max_score
            _count(met, "refined" if ok else "cut_refined")
            kept[k] = (kept[k][0], path, path.score) if ok else (kept[k][0], None, 0)
    for k, (i2, path, score) in enumerate(kept):
        if path is None:
            continue
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
                refined=k in guides,
            )
        )
        mapped_reads.add(b)

    unmapped = [
        batch.names[b]
        for b in range(B)
        if batch.indices[b] >= 0 and b not in mapped_reads
    ]
    return records, unmapped
