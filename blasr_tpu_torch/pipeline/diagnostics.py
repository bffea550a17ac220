"""Diagnostic side-channel writers for the CLI (-fullMetrics, -clusters,
-lcpBounds); the port's host copy of ``blasr_tpu/pipeline/diagnostics.py``.

Roles:
  * write_full_metrics — reference MappingMetrics::PrintFullList
    (datastructures/mapping/MappingMetrics.h:307; opened Blasr.cpp:4224,
    printed :4872). The reference emits one row per read of per-stage CPU
    clocks. The device pipeline maps whole batches, so per-read stage
    clocks do not exist; rows carry the real per-read counters (length,
    mapped bases, alignments, best score, mapQV) and the run's DP cells
    and stage seconds amortized per read, with the amortization stated in
    the header.
  * write_clusters — reference -clusters (Blasr.cpp:4536). The reference
    fork writes the header line and no rows (no surviving row-emission
    code in Blasr.cpp); rows here are a superset carrying per-alignment
    cluster stats in the header's column order.
  * write_lcp_bounds — reference -lcpBounds
    (MapBySuffixArray.h:77-85): per MapReadToGenome call, one line of
    space-separated SA match-interval widths, one value per seed position.
    Emitted per read for forward then reverse-complement strands, matching
    the reference's fwd-then-rc call order (Blasr.cpp:2278-2305).

The files are the JAX package's, byte for byte, with one repair:
``write_full_metrics`` finds a record's read by stream index
(``output/sam_writer.records_by_read``). The JAX writer takes the record's
stream index for a position in ``reads``, so under a read selector its
rows carry other reads' records. The Cells column is the DP cells of the
run's last ``run_mapping`` call, escalation aside
(``MappingMetrics.last_run_dp_cells``), as the JAX CLI prints them.
"""

from __future__ import annotations

from typing import IO, Sequence

import numpy as np

from blasr_tpu_torch.core.encode import pack_kmers
from blasr_tpu_torch.output.sam_writer import records_by_read


def write_full_metrics(
    out: IO[str], reads, records, unmapped, run_metrics
) -> None:
    by_read = records_by_read(records, reads)
    n = max(len(reads), 1)
    amort = {
        "DispatchMsPerRead": 1000.0 * run_metrics.dispatch_seconds / n,
        "FinalizeMsPerRead": 1000.0 * run_metrics.finalize_seconds / n,
        "TotalMsPerRead": 1000.0 * run_metrics.wall_seconds / n,
    }
    out.write(
        "# per-stage clocks are per-read amortized (batched device "
        "mapping): "
        + " ".join(f"{k}={v:.4f}" for k, v in amort.items())
        + "\n"
    )
    out.write(
        "Read Length Mapped NAlignments BestScore MapQV MappedBases Cells\n"
    )
    cells = run_metrics.last_run_dp_cells // n
    for i, rd in enumerate(reads):
        recs = by_read.get(i)
        if not recs:
            out.write(f"{rd.name} {len(rd.codes)} 0 0 0 0 0 {cells}\n")
            continue
        best, mapqv, bases = 0, 0, 0
        for rec in recs:
            if rec.score < best:
                best = rec.score
                mapqv = rec.mapqv
            bases = max(bases, rec.qend - rec.qstart)
        out.write(
            f"{rd.name} {len(rd.codes)} 1 {len(recs)} {best} {mapqv} {bases} {cells}\n"
        )


def write_clusters(out: IO[str], reads, records) -> None:
    out.write(
        "total_size p_value n_anchors read_length align_score "
        "read_accuracy anchor_probability min_exp_anchors seq_length\n"
    )
    for rec in records:
        qlen = rec.qlength
        span = rec.qend - rec.qstart
        acc = rec.pct_similarity / 100.0
        # total_size/n_anchors: anchor bases inside the winning cluster.
        # nhits_considered carries the candidate's member-anchor count out
        # of the device program when available; 0 otherwise.
        n_anchors = int(getattr(rec, "nhits_considered", 0) or 0)
        out.write(
            f"{span} {rec.score} {n_anchors} {qlen} {rec.score} "
            f"{acc:.4f} 0 0 {qlen}\n"
        )


def write_lcp_bounds(out: IO[str], reads: Sequence, index) -> None:
    sa_kmers = np.asarray(index.sa_kmers)
    k = index.k
    for rd in reads:
        codes = np.asarray(rd.codes)
        for strand in (0, 1):
            c = (
                codes
                if strand == 0
                else np.where(codes < 4, 3 - codes, codes)[::-1]
            )
            if len(c) < k:
                out.write("\n")
                continue
            keys, valid = pack_kmers(c, k)
            keys = keys[: len(c) - k + 1]
            valid = valid[: len(c) - k + 1]
            lo = np.searchsorted(sa_kmers, keys, side="left")
            hi = np.searchsorted(sa_kmers, keys, side="right")
            widths = np.where(valid, hi - lo, 0)
            out.write(" ".join(str(int(w)) for w in widths) + "\n")
