"""run_mapping's batch stream under every retry pass at once, against the
JAX package on the CPU, on the corpus of test_torch_modes_passes.py.

With adaptive_cd, the expand cascade (to level 2) and the sensitive retry
together (band escalation is on too), the returned -m 4 lines and unmapped
names equal the JAX package's exactly, and each pass re-maps reads. With
a callback of 3 or 4 parameters, the streamed records are the returned
ones and the streamed unmapped names the returned ones: the reads a pass
may replace or map are held back (``HeldRead``: their first-pass records,
empty for an unmapped read, and the adaptive flag) and delivered, once
resolved, in the final ``on_batch(-1, ...)``, so no read is streamed as
unmapped and then with a record. A run that skips the first two batches
and carries their held reads (``HeldRead.summary()``, adaptive_cd's
flagged and unmapped reads among them) into its passes writes, with the
first two batches' stream and the kept lines, the uninterrupted run's
lines. Tolerance 0."""

import dataclasses

import pytest
import torch

from blasr_tpu.output.m4 import format_m4 as jax_format_m4
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping

from test_torch_modes_passes import BASE, corpus, jax_run  # noqa: F401

torch.set_num_threads(1)

ALL = dataclasses.replace(BASE, adaptive_cd=True, max_expand=2, sensitive_retry=True)


@pytest.fixture(scope="module")
def jax_all(corpus):  # noqa: F811
    index, reads = corpus
    recs, unm = jax_run(index, reads, ALL)
    return [jax_format_m4(r) for r in recs], unm


def test_every_pass_at_once_equals_jax(corpus, jax_all):  # noqa: F811
    index, reads = corpus
    met = MappingMetrics()
    recs, unm = run_mapping(index, reads, ALL, device="cpu", metrics=met)
    assert ([format_m4(r) for r in recs], unm) == jax_all
    assert met.adaptive_reads >= 4 and met.escalated_reads >= 2 and met.sensitive_reads >= 1
    assert met.expand_levels[1][0] >= 2 and met.expand_levels[2][1] >= 2


@pytest.mark.parametrize("n_args", [3, 4])
def test_streamed_equals_returned_under_every_pass(corpus, jax_all, n_args):  # noqa: F811
    index, reads = corpus
    streamed, streamed_unm, calls, held = [], [], [], {}

    def on_batch3(bi, recs, unm):
        calls.append(bi)
        streamed.extend(recs)
        streamed_unm.extend(unm)

    def on_batch4(bi, recs, unm, h):
        on_batch3(bi, recs, unm)
        held.update(h)
        assert bi >= 0 or not h

    recs, unm = run_mapping(index, reads, ALL, device="cpu",
                            on_batch=on_batch3 if n_args == 3 else on_batch4)
    assert ([format_m4(r) for r in recs], unm) == jax_all
    assert calls == [0, 1, 2, -1]
    assert sorted(format_m4(r) for r in streamed) == sorted(format_m4(r) for r in recs)
    assert sorted(streamed_unm) == sorted(unm)
    assert not {r.qname for r in streamed} & set(streamed_unm)
    if n_args == 4:
        # the dense reads are held unmapped, the repeat reads for adaptive_cd
        assert held["dense/0"].records == [] and not held["dense/0"].amb
        assert sum(h.amb for h in held.values()) >= 4
        assert all(r.qname == n for n, h in held.items() for r in h.records)
        summary = held["noisy/0"].summary()
        assert summary["records"] and summary["records"][0][1] < 80.0


def test_a_resumed_stream_ends_with_the_uninterrupted_lines(corpus, jax_all):  # noqa: F811
    """What a kill after batch 1 leaves (the stream of batches 0 and 1 and
    their held reads' summaries and lines), then a run that skips those
    batches and carries the held reads into its passes: the lines written
    by both runs, with the kept lines of the carried reads no pass
    replaced, are the uninterrupted run's. The carried reads include
    adaptive_cd's flagged ones."""
    index, reads = corpus
    first: dict = {}
    run_mapping(index, reads, ALL, device="cpu",
                on_batch=lambda bi, recs, unm, held: first.setdefault(bi, (recs, held)))
    written = [format_m4(r) for bi in (0, 1) for r in first[bi][0]]
    held = {n: h for bi in (0, 1) for n, h in first[bi][1].items()}
    assert any(h.amb for h in held.values()) and any(not h.records for h in held.values())
    later, delivered = [], set()

    def on_batch(bi, recs, unm, _held):
        later.extend(format_m4(r) for r in recs)
        if bi < 0:
            delivered.update(r.qname for r in recs)
            delivered.update(unm)

    recs, _ = run_mapping(index, reads, ALL, device="cpu", on_batch=on_batch, skip_batches=2,
                          carried={n: h.summary() for n, h in held.items()})
    kept = [format_m4(r) for n, h in held.items() if n not in delivered for r in h.records]
    assert sorted(written + later + kept) == sorted(jax_all[0])
    assert len(written + later + kept) == len(jax_all[0])
    assert not {r.qname for r in recs} - {r.name for r in reads}
