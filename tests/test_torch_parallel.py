"""A batch split over devices (``-ndevices``) in the port against the JAX
package.

The JAX package's ``sharded_map_batch`` runs on the virtual 4-device CPU
mesh of ``tests/conftest.py``; the port's splits the batch into four
slices on ``["cpu"] * 4``. Both must equal the one-device result, wire
byte for wire byte. One batch holds reads whose drift runs one way in
its first half and the other way in its second, so each slice's own
drift median differs from the batch's: a split that took the median per
slice would fail. Then ``run_mapping`` with ``devices=`` against the
one-device run, and the CLI with ``-ndevices 8`` (one visible device on
the CPU: the plain path) against ``-ndevices 1`` and the JAX CLI's file."""

import dataclasses

import numpy as np
import pytest
import torch

from blasr_tpu.io.batching import Read, batch_reads
from blasr_tpu.parallel.mesh import make_mesh as jmake_mesh
from blasr_tpu.parallel.mesh import sharded_map_batch as jsharded_map_batch
from blasr_tpu.pipeline import mapper as jmap
from blasr_tpu_torch.output.m4 import format_m4
from blasr_tpu_torch.parallel import mesh
from blasr_tpu_torch.pipeline import mapper as tmap
from blasr_tpu_torch.pipeline.runner import run_mapping

from test_torch_slice import BASE, corpus  # noqa: F401  (the 200 kb fixture)

torch.set_num_threads(1)


def _drift_batch(index, n=8, seed=4):
    """``n`` reads of 300-450 bases: in the first half a deletion every 15
    bases, in the second an insertion every 15."""
    rng = np.random.default_rng(seed)
    g = index.genome
    reads = []
    for i in range(n):
        s = int(rng.integers(0, len(g) - 1500))
        r = g[s : s + int(rng.integers(300, 450))].copy()
        at = np.arange(0, len(r), 15)
        if i < n // 2:
            r = np.delete(r, at)
        else:
            r = np.insert(r, at, rng.integers(0, 4, len(at)).astype(np.uint8))
        reads.append(Read(f"drift{i}", r, None, i))
    return next(batch_reads(reads, n, BASE.max_read_len))


def _jax_result(index, params, codes, lengths, jmesh):
    jdi = jmap.make_device_index(index, params)
    return [np.asarray(x) for x in jsharded_map_batch(jmesh, jdi, params, codes, lengths)]


@pytest.mark.parametrize("W,best_n,guided", [(32, 1, False), (64, 2, False), (32, 1, True),
                                             (128, 1, False)])
def test_split_batch_equals_jax_and_one_device(corpus, W, best_n, guided):  # noqa: F811
    """The port's split against its one device and against the JAX
    package's SPMD step on the same batch, in every case."""
    index, _ = corpus
    params = dataclasses.replace(BASE, narrow_band=W if W < 128 else 0, band_width=128,
                                 best_n=best_n, emit_moves=best_n > 1, guided_band=guided)
    b = _drift_batch(index)
    port_split = mesh.sharded_map_batch(["cpu"] * 4, index, params, b.codes, b.lengths)
    di = tmap.make_device_index(index, params, "cpu")
    port_one = tmap.map_batch_impl(torch.from_numpy(b.codes), torch.from_numpy(b.lengths),
                                   di, params)
    for p1, p4 in zip(port_one, port_split):
        np.testing.assert_array_equal(p4.numpy(), p1.numpy())
    jax_split = _jax_result(index, params, b.codes, b.lengths, jmake_mesh(4))
    for p4, j4 in zip(port_split, jax_split):
        np.testing.assert_array_equal(p4.numpy(), j4)
    assert tmap.wire_bytes(port_split).numpy().tobytes() == tmap.wire_bytes(port_one).numpy().tobytes()
    # the slices' own medians differ from the batch's (none at W 128)
    meds = set()
    for i in range(4):
        st = tmap.map_batch_steps(torch.from_numpy(b.codes[2 * i : 2 * i + 2]),
                                  torch.from_numpy(b.lengths[2 * i : 2 * i + 2]), di, params)
        slopes = next(st)
        meds.add(None if slopes is None else float(tmap.slope_median(slopes)))
    assert (meds == {None}) if W == 128 else len(meds) > 1


def test_split_batch_with_quality_equals_one_device(corpus):  # noqa: F811
    """Dual-stream quality rows go with their reads' slices."""
    index, _ = corpus
    b = _drift_batch(index, seed=6)
    rng = np.random.default_rng(1)
    qual = rng.integers(5, 40, b.codes.shape).astype(np.uint16)
    qual |= rng.integers(5, 40, b.codes.shape).astype(np.uint16) << 8
    one = tmap.Mapper(index, BASE, device="cpu").map_batch(b.codes, b.lengths, qual)
    split = tmap.Mapper(index, BASE, device="cpu", devices=["cpu"] * 2).map_batch(
        b.codes, b.lengths, qual)
    assert one[1:] == split[1:]
    assert one.wire.numpy().tobytes() == split.wire.numpy().tobytes()


def test_run_mapping_split_equals_one_device(corpus):  # noqa: F811
    """run_mapping with each batch split over four devices, band escalation
    included (its nested run splits too): the one-device lines."""
    index, reads = corpus
    reads = reads[:8]
    one, one_unm = run_mapping(index, reads, BASE, device="cpu")
    trec, tunm = run_mapping(index, reads, BASE, device="cpu", devices=["cpu"] * 4)
    assert [format_m4(r) for r in trec] == [format_m4(r) for r in one]
    assert tunm == one_unm and len(trec) >= 7


def test_device_choice_follows_jax(monkeypatch):
    """-ndevices: 0 = every visible device, N = min(N, visible), split only
    when that is above one and divides the batch; explicit devices may
    repeat one and must divide it."""
    p = BASE
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for nd in (0, 1, 2, 8):
        assert mesh.mapper_devices(dataclasses.replace(p, ndevices=nd), cpu, None) is None
    assert mesh.mapper_devices(p, cpu, ["cpu"]) == [cpu]
    assert mesh.mapper_devices(p, cpu, ["cpu", "cpu"]) == [cpu, cpu]
    with pytest.raises(ValueError, match="not divisible"):
        mesh.mapper_devices(p, cpu, ["cpu"] * 3)
    # a machine with four visible cards, faked: which devices each setting picks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    pick = {(nd, bs): mesh.mapper_devices(dataclasses.replace(p, ndevices=nd, batch_size=bs),
                                          cuda, None)
            for nd, bs in ((0, 8), (2, 8), (8, 8), (3, 9), (3, 8), (1, 8))}
    assert pick == {(0, 8): mesh.make_mesh(4), (2, 8): mesh.make_mesh(2),
                    (8, 8): mesh.make_mesh(4), (3, 9): mesh.make_mesh(3), (3, 8): None,
                    (1, 8): None}
    with pytest.raises(ValueError, match="need 5"):
        mesh.make_mesh(5)


def test_missing_cuda_device_raises(corpus):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a card")
    index, _ = corpus
    with pytest.raises(ValueError, match="CUDA device"):
        mesh.make_mesh(0)
    for kw in (dict(device="cuda"), dict(device="cpu", devices=["cpu", "cuda:1"]),
               dict(device="cuda", devices=None)):
        with pytest.raises(RuntimeError, match="cuda"):
            tmap.Mapper(index, dataclasses.replace(BASE, ndevices=0), **kw)


def test_cli_ndevices_equals_one_device_and_jax(tmp_path):
    """tests/test_parallel.py's CLI case through the port (``-device cpu``),
    on 10 reads: ``-ndevices 8`` writes the bytes of ``-ndevices 1``, which
    are the JAX CLI's at ``-ndevices 8``."""
    from blasr_tpu.cli.blasr import main as jmain
    from blasr_tpu.io.fasta import write_fasta
    from blasr_tpu.sim import simulate_genome, simulate_reads
    from blasr_tpu_torch.cli.blasr import main as tmain

    g = simulate_genome(50_000, seed=77, repeat_fraction=0.0)
    gp = str(tmp_path / "g.fa")
    write_fasta(gp, [("ref", g)])
    reads, _ = simulate_reads(g, 10, mean_len=300, seed=78)
    rp = str(tmp_path / "r.fa")
    write_fasta(rp, [(r.name, r.codes) for r in reads])
    common = [rp, gp, "-m", "4", "-batchSize", "8", "-maxReadLen", "1024", "-minMatch", "13"]
    jmain(common + ["-out", str(tmp_path / "jax8.m4"), "-ndevices", "8"])
    outs = {}
    for nd in ("1", "8"):
        out = str(tmp_path / f"t{nd}.m4")
        assert tmain(common + ["-out", out, "-ndevices", nd, "-device", "cpu"]) == 0
        outs[nd] = open(out).read()
    assert outs["8"] == outs["1"] == open(tmp_path / "jax8.m4").read()
    assert len(outs["1"].splitlines()) >= 8
