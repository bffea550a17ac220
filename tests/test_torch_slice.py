"""The -m 4 mapping slice of the port against the JAX package, end to end.

A 200 kb random two-contig genome, a k=10 suffix-array index with the
direct 4^k tables, 24 noisy reads of 400-1000 bp (every sixth with an
insertion burst that the narrow band clips, so band escalation runs). The
port's map_batch wire bytes (best_n 1 and 2) and its run_mapping -m 4
lines must equal the JAX package's exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from blasr_tpu.core.encode import revcomp_codes
from blasr_tpu.index.artifacts import build_index_from_arrays
from blasr_tpu.io.batching import Read, batch_reads
from blasr_tpu.io.seqdb import SeqDB
from blasr_tpu.output.m4 import format_m4 as jax_format_m4
from blasr_tpu.params import MappingParams
from blasr_tpu.pipeline import mapper as jmap
from blasr_tpu.pipeline.runner import run_mapping as jax_run_mapping
from blasr_tpu_torch.interop import device_index_from_numpy
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.pipeline import mapper as tmap
from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping

from conftest import mutate_read

# The suite runs in parallel worker processes: one intra-op thread each
# keeps PyTorch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)

BASE = MappingParams(
    batch_size=8, max_read_len=1024, n_candidates=4, n_dp_candidates=2,
    anchor_stride=4, max_anchors_per_read=128, narrow_band=32,
    narrow_band_max=1024, min_match_length=10, direct_lut=True,
    emit_moves=False, best_n=1,
)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    G = 200_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    seqdb = SeqDB(["chrA", "chrB"], np.array([0, 120_000, G], np.int64), ["0" * 32] * 2)
    index = build_index_from_arrays(genome, seqdb, k=10)
    reads = []
    for i in range(24):
        start = int(rng.integers(0, G - 1200))
        r = mutate_read(rng, genome, start, int(rng.integers(400, 1000)))
        if i % 6 == 5:
            mid = len(r) // 2
            r = np.concatenate([r[:mid], rng.integers(0, 4, 90).astype(np.uint8), r[mid:]])
        if rng.integers(0, 2):
            r = revcomp_codes(r)
        reads.append(Read(f"read{i}", r, None, i))
    return index, reads


def _jax_index_numpy(index, params):
    jdi = jmap.make_device_index(index, params)
    return jdi, tuple(np.asarray(a) for a in jdi.arrays)


@pytest.mark.parametrize("W,emit_moves,best_n", [
    pytest.param(32, False, 1, id="32-False"), pytest.param(64, True, 1, id="64-True"),
    pytest.param(32, True, 1, id="32-True"),
    # two rows a read, the second one's moves for the host's secondary admission
    pytest.param(32, True, 2, id="32-bestn2"), pytest.param(64, True, 2, id="64-bestn2"),
])
def test_map_batch_wire_bytes_equal_jax(corpus, W, emit_moves, best_n):
    index, reads = corpus
    params = dataclasses.replace(BASE, narrow_band=W, emit_moves=emit_moves, best_n=best_n)
    jm = jmap.Mapper(index, params)
    tm = tmap.Mapper(index, params, device="cpu")
    n = 0
    for b in batch_reads(reads, params.batch_size, params.max_read_len):
        jr = jm.map_batch(b.codes, b.lengths)
        tr = tm.map_batch(b.codes, b.lengths)
        assert (jr.i2, jr.p, jr.b, jr.rcols) == (tr.i2, tr.p, tr.b, tr.rcols)
        assert tr.i2 == best_n * b.codes.shape[0] and (tr.p > 0) == emit_moves
        np.testing.assert_array_equal(np.asarray(jr.wire), tr.wire.numpy())
        n += 1
    assert n >= 2


@pytest.mark.parametrize("max_anchors", [100, 33])
def test_map_batch_wire_bytes_equal_jax_off_multiples_of_32(corpus, max_anchors):
    """An anchor cap that is no multiple of 32: the window weights, the mean
    diagonals and the slope fit sum over lengths where XLA pads its
    32-wide reduction windows on both ends."""
    index, reads = corpus
    params = dataclasses.replace(BASE, max_anchors_per_read=max_anchors)
    jm = jmap.Mapper(index, params)
    tm = tmap.Mapper(index, params, device="cpu")
    for b in batch_reads(reads, params.batch_size, params.max_read_len):
        jr = jm.map_batch(b.codes, b.lengths)
        tr = tm.map_batch(b.codes, b.lengths)
        np.testing.assert_array_equal(np.asarray(jr.wire), tr.wire.numpy())


def test_run_mapping_m4_equals_jax_with_escalation(corpus):
    index, reads = corpus
    jrec, junm = jax_run_mapping(index, reads, BASE)
    met = MappingMetrics()
    clock = tmap.StageClock(torch.device("cpu"))
    trec, tunm = run_mapping(index, reads, BASE, device="cpu", metrics=met, clock=clock)
    assert [format_m4(r) for r in trec] == [jax_format_m4(r) for r in jrec]
    assert tunm == junm
    assert met.escalated_reads > 0            # the wide-band retry ran
    assert set(clock.seconds) == {"anchors", "candidates", "setup", "dp", "walk", "select"}
    assert len(trec) >= 20


def test_make_device_index_equals_jax_and_maps_the_same(corpus):
    index, reads = corpus
    jdi, jarrays = _jax_index_numpy(index, BASE)
    tdi = tmap.make_device_index(index, BASE, "cpu")
    conv = device_index_from_numpy(
        np.asarray(jdi.genome_pad), jarrays, np.asarray(jdi.starts),
        pad=jdi.pad, k=jdi.k, genome_len=jdi.genome_len, kind=jdi.kind,
        lut_meta=jdi.lut_meta,
    )
    for di in (tdi, conv):
        np.testing.assert_array_equal(np.asarray(jdi.genome_pad), di.genome_pad.numpy())
        np.testing.assert_array_equal(np.asarray(jdi.starts), di.starts.numpy())
        for j, t in zip(jarrays, di.arrays):
            np.testing.assert_array_equal(j, t.numpy().view(j.dtype))
        assert (di.pad, di.k, di.genome_len, di.lut_meta) == (
            jdi.pad, jdi.k, jdi.genome_len, tuple(jdi.lut_meta))
    # the converted index maps batch for batch like the port-built one
    tm = tmap.Mapper(index, BASE, device="cpu")
    b = next(iter(batch_reads(reads, BASE.batch_size, BASE.max_read_len)))
    own = tm.map_batch(b.codes, b.lengths).wire
    tm.device_index = conv
    assert torch.equal(tm.map_batch(b.codes, b.lengths).wire, own)


def test_unported_options_raise(corpus):
    """The options once refused here map: on two reads that map cleanly,
    -placeRepeatsRandomly, the sensitive retry and adaptive_cd print the
    plain run's lines (tests/test_torch_modes_*.py hold each to JAX)."""
    index, reads = corpus
    plain = [format_m4(r) for r in run_mapping(index, reads[:2], BASE, device="cpu")[0]]
    assert plain
    for kw in (dict(place_repeats_randomly=True), dict(sensitive_retry=True),
               dict(adaptive_cd=True)):
        recs, _ = run_mapping(index, reads[:2], dataclasses.replace(BASE, **kw), device="cpu")
        assert [format_m4(r) for r in recs] == plain
    # guided bands are ported: a batch of empty reads maps to no alignment
    res = tmap.Mapper(index, dataclasses.replace(BASE, guided_band=True), device="cpu").map_batch(
        np.full((8, 1024), 4, np.uint8), np.zeros(8, np.int32))
    host = tmap.unpack_result(res, BASE.dp_candidates)
    assert (res.i2, res.b) == (8, 8) and not host.sel_valid.any()


def test_cuda_mapper_refuses_without_a_card(corpus, monkeypatch):
    index, _ = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tmap.Mapper(index, BASE, device="cuda")


def test_device_is_a_required_keyword(corpus):
    index, reads = corpus
    with pytest.raises(TypeError, match="device"):
        run_mapping(index, reads[:2], BASE)
    with pytest.raises(TypeError, match="device"):
        tmap.Mapper(index, BASE)
    with pytest.raises(TypeError):
        tmap.Mapper(index, BASE, "cpu")             # keyword only
