"""The hand-written CUDA kernels against their plain versions on the card,
and the port's mapping on the card against its CPU run. Every test here
needs an NVIDIA GPU; without one each skips (run them on the card with
``python -m pytest tests/test_torch_cuda.py -q``)."""

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _dp_case(seed, W, I=64, L=256, T=512, num=33437):
    from blasr_tpu_torch.ops.banded_align import make_qoff_num

    rng = np.random.default_rng(seed)
    Q = rng.integers(0, 4, (I, L)).astype(np.uint8)
    Tc = rng.integers(0, 4, (I, T)).astype(np.uint8)
    for i in range(I):
        off = int(rng.integers(100, 160))
        Tc[i, off : off + L - 40] = Q[i, : L - 40]
    qlen = rng.integers(L // 2, L + 1, I).astype(np.int32)
    tlo = rng.integers(0, 20, I).astype(np.int32)
    thi = (T - rng.integers(0, 20, I)).astype(np.int32)
    qoff = make_qoff_num(L, T, W, (T - L) // 2, num)
    return [torch.from_numpy(a) for a in (Q, qlen, Tc, tlo, thi)] + [qoff]


@pytest.mark.parametrize("W", [32, 64, 128, 256])
def test_banded_dp_kernel_matches_plain(dev, W):
    from blasr_tpu_torch.ops.banded_align import banded_align_plain
    from blasr_tpu_torch.ops.banded_cuda import banded_align

    args = _dp_case(W, W)
    ref = banded_align_plain(*args, with_traceback=True, band_width=W)
    before = banded_align.launches
    got = banded_align(*[a.to(dev) for a in args], with_traceback=True, band_width=W)
    torch.cuda.synchronize()
    assert banded_align.launches == before + 1
    for name in ("score", "best_a", "best_w"):
        assert torch.equal(getattr(got, name).cpu(), getattr(ref, name)), name
    assert torch.equal(got.arrows.view(torch.int16).cpu(), ref.arrows.view(torch.int16))


@pytest.mark.parametrize("W", [32, 64, 128, 256])
@pytest.mark.parametrize("mode", ["single", "dual"])
def test_banded_dp_quality_modes_match_plain(dev, W, mode):
    from blasr_tpu_torch.ops.banded_align import banded_align_plain
    from blasr_tpu_torch.ops.banded_cuda import banded_align

    args = _dp_case(W + 1, W)
    I, L = args[0].shape
    rng = np.random.default_rng(W)
    qual = rng.integers(0, 64, (I, L)).astype(np.uint8)
    if mode == "dual":
        # low byte up to 255, high byte >= 128 on some cells
        qual = (rng.integers(0, 256, (I, L)).astype(np.uint16)
                | (rng.integers(0, 256, (I, L)).astype(np.uint16) << 8)).view(np.int16)
    q = torch.from_numpy(qual)
    ref = banded_align_plain(*args, q, with_traceback=True, band_width=W)
    before = banded_align.launches_by_shape[(W, mode)]
    got = banded_align(*[a.to(dev) for a in args], q.to(dev), with_traceback=True, band_width=W)
    torch.cuda.synchronize()
    assert banded_align.launches_by_shape[(W, mode)] == before + 1
    for name in ("score", "best_a", "best_w"):
        assert torch.equal(getattr(got, name).cpu(), getattr(ref, name)), name
    assert torch.equal(got.arrows.view(torch.int16).cpu(), ref.arrows.view(torch.int16))


def _knots(seed, W, I=64, L=256, T=512):
    """Guided knots for ``_dp_case``'s windows: anchors along each read's
    diagonal with a per-item drift and jitter, clamped to the reference's
    distance from the shared line."""
    from blasr_tpu_torch.ops.banded_align import (
        clamp_knots_to_shared, guided_max_dev, make_qoff_knots, make_qoff_num,
    )

    rng = np.random.default_rng(seed)
    A = 24
    aq = np.sort(rng.integers(0, L, (I, A)), axis=1).astype(np.int32)
    shift = rng.integers(100, 160, (I, 1)) + np.cumsum(rng.integers(-4, 5, (I, A)), axis=1)
    a_anchor = torch.from_numpy((2 * aq + shift).astype(np.int32))
    v_anchor = torch.from_numpy((aq - W // 2).astype(np.int32))
    mask = torch.from_numpy(rng.random((I, A)) < 0.8)
    knots = make_qoff_knots(a_anchor, v_anchor, mask, L + T - 1, L, W, diag=(T - L) // 2,
                            num=33437)
    shared = make_qoff_num(L, T, W, (T - L) // 2, 33437)
    return clamp_knots_to_shared(knots, shared, W, max_dev=guided_max_dev(W))


def _assert_equal_results(got, ref):
    for name in ("score", "best_a", "best_w"):
        assert torch.equal(getattr(got, name).cpu(), getattr(ref, name)), name
    assert torch.equal(got.arrows.view(torch.int16).cpu(), ref.arrows.view(torch.int16))


def _qual(mode, I, L, seed):
    rng = np.random.default_rng(seed)
    if mode == "none":
        return None
    if mode == "single":
        return torch.from_numpy(rng.integers(0, 64, (I, L)).astype(np.uint8))
    return torch.from_numpy((rng.integers(0, 256, (I, L)).astype(np.uint16)
                             | (rng.integers(0, 256, (I, L)).astype(np.uint16) << 8))
                            .view(np.int16))


@pytest.mark.parametrize("W", [32, 64, 128, 256])
@pytest.mark.parametrize("mode", ["none", "single", "dual"])
def test_banded_dp_guided_mode_matches_plain(dev, W, mode):
    from blasr_tpu_torch.ops.banded_align import banded_align_plain, qoff_from_knots
    from blasr_tpu_torch.ops.banded_cuda import banded_align

    args = _dp_case(W + 2, W)[:5]
    knots = _knots(W, W)
    I, L = args[0].shape
    q = _qual(mode, I, L, W + 3)
    S = L + args[2].shape[1] - 1
    ref = banded_align_plain(*args, qoff_from_knots(knots, S), q, with_traceback=True,
                             band_width=W)
    before = banded_align.launches_by_shape[(W, "guided")]
    got = banded_align(*[a.to(dev) for a in args], None, None if q is None else q.to(dev),
                       knots=knots.to(dev), with_traceback=True, band_width=W)
    torch.cuda.synchronize()
    assert banded_align.launches_by_shape[(W, "guided")] == before + 1
    _assert_equal_results(got, ref)


@pytest.mark.parametrize("W", [32, 64, 128, 256])
@pytest.mark.parametrize("mode", ["none", "single"])
@pytest.mark.parametrize("guided", [False, True])
def test_banded_dp_matrix_mode_matches_plain(dev, W, mode, guided):
    from blasr_tpu_torch.ops.banded_align import (
        AlignScores, banded_align_plain, qoff_from_knots,
    )
    from blasr_tpu_torch.ops.banded_cuda import banded_align

    # a negative off-diagonal (A<->C at -2): alignments may start on a mismatch
    sc = AlignScores(matrix=(-5, -2, 6, 6, 0, -2, -5, 6, 6, 0, 6, 6, -5, 6, 1,
                             6, 6, 6, -5, 0, 0, 0, 2, 0, 0))
    args = _dp_case(W + 4, W)
    I, L = args[0].shape
    S = L + args[2].shape[1] - 1
    q = _qual(mode, I, L, W + 5)
    knots = _knots(W + 1, W) if guided else None
    sched = qoff_from_knots(knots, S) if guided else args[5]
    ref = banded_align_plain(*args[:5], sched, q, scores=sc, with_traceback=True, band_width=W)
    before = banded_align.launches_by_shape[(W, "matrix")]
    got = banded_align(*[a.to(dev) for a in args[:5]], None if guided else args[5].to(dev),
                       None if q is None else q.to(dev),
                       knots=knots.to(dev) if guided else None,
                       scores=sc, with_traceback=True, band_width=W)
    torch.cuda.synchronize()
    assert banded_align.launches_by_shape[(W, "matrix")] == before + 1
    _assert_equal_results(got, ref)


MATRIX = (-5, -2, 6, 6, 0, -2, -5, 6, 6, 0, 6, 6, -5, 6, 1, 6, 6, 6, -5, 0, 0, 0, 2, 0, 0)


def _run_both(dev, args, sched, q, W, knots=None, scores=None):
    """The kernel (on the card) and the plain version (on the CPU) on the
    same inputs; ``sched`` is the shared (S,) schedule, or None with
    ``knots``."""
    from blasr_tpu_torch.ops.banded_align import AlignScores, banded_align_plain, qoff_from_knots
    from blasr_tpu_torch.ops.banded_cuda import banded_align

    sc = scores or AlignScores()
    S = args[0].shape[1] + args[2].shape[1] - 1
    ref = banded_align_plain(*args, qoff_from_knots(knots, S) if knots is not None else sched,
                             q, scores=sc, with_traceback=True, band_width=W)
    got = banded_align(*[a.to(dev) for a in args], None if sched is None else sched.to(dev),
                       None if q is None else q.to(dev),
                       knots=None if knots is None else knots.to(dev),
                       scores=sc, with_traceback=True, band_width=W)
    torch.cuda.synchronize()
    _assert_equal_results(got, ref)


@pytest.mark.parametrize("W", [32, 64, 128, 256])
@pytest.mark.parametrize("mode", ["none", "single", "dual"])
@pytest.mark.parametrize("sched", ["shared", "guided"])
@pytest.mark.parametrize("matrix", [False, True])
def test_banded_dp_every_instance_matches_plain(dev, W, mode, sched, matrix):
    """Every instance (band width x quality mode x schedule x scores) on
    ragged reads (qlen) and target cuts (tlo, thi)."""
    from blasr_tpu_torch.ops.banded_align import AlignScores

    args = _dp_case(W + 6, W)
    I, L = args[0].shape
    q = _qual(mode, I, L, W + 7)
    knots = _knots(W + 8, W) if sched == "guided" else None
    _run_both(dev, args[:5], args[5] if sched == "shared" else None, q, W, knots=knots,
              scores=AlignScores(matrix=MATRIX if matrix else None))


@pytest.mark.parametrize("W", [32, 64, 128, 256])
@pytest.mark.parametrize("mode", ["none", "single", "dual"])
def test_banded_dp_schedule_steps_outside_0_1(dev, W, mode):
    """A shared schedule whose steps go back and jump ahead by up to 2 (the
    band shifts by -3..+4), and guided knots that climb past L - W up to
    L (the per-item plain version takes steps in {0, 1}: knots
    nondecreasing, at most 64 apart): bit-equal to the plain version."""
    args = _dp_case(W + 9, W)
    I, L = args[0].shape
    S = L + args[2].shape[1] - 1
    rng = np.random.default_rng(W)
    walk = np.cumsum(rng.integers(-1, 4, S)) // 2
    qoff = torch.from_numpy(np.clip(walk - 40, 0, L).astype(np.int32))
    deltas = np.diff(qoff.numpy())
    assert (deltas < 0).any() and (deltas > 1).any()
    q = _qual(mode, I, L, W + 10)
    _run_both(dev, args[:5], qoff, q, W)
    from blasr_tpu_torch.ops.banded_align import n_knots

    climb = np.cumsum(rng.integers(0, 65, (I, n_knots(S))), axis=1) - 300
    knots = torch.from_numpy(np.clip(climb, 0, L).astype(np.int32))
    assert (knots > L - W).any()
    _run_both(dev, args[:5], None, q, W, knots=knots)


@pytest.mark.parametrize("mode", ["none", "single"])
def test_banded_dp_long_read_at_w256(dev, mode):
    """L = 8192 at W = 256, the longest bucket the band width rule holds
    (params.band_width_for): two items, shared and guided."""
    from blasr_tpu_torch.ops.banded_align import make_qoff_num

    I, L = 2, 8192
    T = L + 256
    rng = np.random.default_rng(8192)
    Q = rng.integers(0, 4, (I, L)).astype(np.uint8)
    Tc = rng.integers(0, 4, (I, T)).astype(np.uint8)
    Tc[:, 128 : 128 + L] = np.where(rng.random((I, L)) < 0.1, (Q + 1) % 4, Q)
    args = [torch.from_numpy(a) for a in (
        Q, np.array([L, L - 1000], np.int32), Tc, np.array([0, 5], np.int32),
        np.array([T, T - 7], np.int32))]
    qoff = make_qoff_num(L, T, 256, 128, 33437)
    q = _qual(mode, I, L, 11)
    _run_both(dev, args, qoff, q, 256)
    from blasr_tpu_torch import bench

    knots = bench.deviating_knots(I, L, T, 256, 128, 33437, seed=3)
    _run_both(dev, args, None, q, 256, knots=knots)


@pytest.mark.parametrize("W", [32, 64, 128, 256])
def test_banded_dp_one_item(dev, W):
    case = _dp_case(W + 12, W)
    args = [a[:1] for a in case[:5]] + [case[5]]
    I, L = args[0].shape
    assert I == 1
    _run_both(dev, args[:5], args[5], _qual("single", I, L, W), W)
    _run_both(dev, args[:5], None, None, W, knots=_knots(W + 13, W)[:1])


def test_gather_kernels_match_plain(dev):
    from blasr_tpu_torch.ops.gather import (
        gather_rows, gather_rows_plain, gather_spans, gather_spans_plain,
    )

    g = torch.Generator().manual_seed(0)
    src = torch.randint(-2**31, 2**31 - 1, (4096,), dtype=torch.int32, generator=g)
    starts = torch.randint(-50, 4200, (300,), dtype=torch.int32, generator=g)
    got = gather_spans(src.to(dev), starts.to(dev), 162)
    assert torch.equal(got.cpu(), gather_spans_plain(src, starts, 162))
    src2 = src[:4000].reshape(100, 40)
    rows = torch.randint(-5, 110, (300,), dtype=torch.int32, generator=g)
    assert torch.equal(gather_rows(src2.to(dev), rows.to(dev)).cpu(), gather_rows_plain(src2, rows))


def _span_source(dev, N=4099, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, (N,), dtype=torch.int32, generator=g)


@pytest.mark.parametrize("span", [1, 3, 4, 5, 162, 450, 482])
@pytest.mark.parametrize("offset", [0, 1])
def test_gather_spans_every_phase_and_clip(dev, span, offset):
    """Starts at each phase 0-3 mod 4 and each output row phase, interior
    and clipped at both ends (whole spans outside [0, N) too), from a source
    whose base is 16-byte aligned or one word past it; bit-equal to the
    plain version, one launch."""
    from blasr_tpu_torch.ops.gather import gather_spans, gather_spans_plain

    N = 4099
    src = _span_source(dev, N, span)
    rng = np.random.default_rng(span)
    inner = [p + 4 * k for k in (0, 1, 7) for p in range(4)]
    inner += list(rng.integers(0, N - span + 1, 40))
    edge = [-1, -2, -3, -4, -span, -span - 1, -span - 9, N - span + 1, N - span + 2,
            N - 1, N, N + 3, N + span + 5, -2**31, 2**31 - 1 - span]
    starts = torch.tensor([s for s in inner if 0 <= s <= N - span] + edge, dtype=torch.int32)
    buf = torch.empty(N + offset, dtype=torch.int32, device=dev)
    src_d = buf[offset:]
    src_d.copy_(src.to(dev))
    before = gather_spans.launches
    got = gather_spans(src_d, starts.to(dev), span)
    torch.cuda.synchronize()
    assert got.shape == (starts.shape[0], span) and got.is_contiguous()
    assert torch.equal(got.cpu(), gather_spans_plain(src, starts, span))
    assert gather_spans.launches == before + 1


@pytest.mark.parametrize("n_items", [0, 1])
def test_gather_spans_zero_and_one_item(dev, n_items):
    from blasr_tpu_torch.ops.gather import gather_spans, gather_spans_plain

    src = _span_source(dev, 1000, 3)
    starts = torch.tensor([997][:n_items], dtype=torch.int32)
    before = gather_spans.launches
    got = gather_spans(src.to(dev), starts.to(dev), 162)
    torch.cuda.synchronize()
    assert got.shape == (n_items, 162)
    assert torch.equal(got.cpu(), gather_spans_plain(src, starts, 162))
    assert gather_spans.launches == before + n_items


@pytest.mark.parametrize("Lr", [1, 3, 4, 5, 128, 416])
@pytest.mark.parametrize("view", ["whole", "row_offset", "word_offset"])
def test_gather_rows_widths_views_and_clip(dev, Lr, view):
    """Rows of 1-416 words from a whole tensor, a row-offset view (base
    Lr words in: not 16-byte aligned unless Lr % 4 == 0) and a word-offset
    view (base 4 bytes off), rows clipped at both ends; the int4 instance
    exactly when the row length and both bases allow it."""
    from blasr_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    R = 37
    g = torch.Generator().manual_seed(Lr)
    big = torch.randint(-2**31, 2**31 - 1, (R + 1, Lr), dtype=torch.int32, generator=g).to(dev)
    if view == "whole":
        src = big
    elif view == "row_offset":
        src = big[1:]
    else:
        buf = torch.empty(R * Lr + 1, dtype=torch.int32, device=dev)
        src = buf[1:].view(R, Lr)
        src.copy_(big[1:])
    assert src.is_contiguous()
    rows = torch.tensor([-1, -2**31, R, R + 5, 2**31 - 1, 0, R - 1]
                        + list(np.random.default_rng(Lr).integers(0, R, 50)), dtype=torch.int32)
    width = 4 if Lr % 4 == 0 and src.data_ptr() % 16 == 0 else 1
    before = dict(gather_rows.launches_by_path)
    got = gather_rows(src, rows.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gather_rows_plain(src.cpu(), rows))
    assert gather_rows.launches_by_path[width] == before[width] + 1
    assert gather_rows.launches_by_path[5 - width] == before[5 - width]


def test_xla_log_is_the_same_on_the_card(dev):
    """The port's copy of XLA's CPU log gives the card the CPU's bits, and
    with it the anchor weights of the JAX mapper."""
    from blasr_tpu_torch.ops.candidates import anchor_weights, xla_log

    rng = np.random.default_rng(4)
    x = torch.from_numpy(np.exp(rng.uniform(-14, 14, 100_000)).astype(np.float32))
    assert torch.equal(xla_log(x.to(dev)).cpu(), xla_log(x))
    nh = torch.arange(0, 100_001, dtype=torch.int32)
    valid = torch.ones(nh.shape, dtype=torch.bool)
    assert torch.equal(anchor_weights(nh.to(dev), valid.to(dev), 4_600_000, 128, 0).cpu(),
                       anchor_weights(nh, valid, 4_600_000, 128, 0))


def test_mapq_math_is_the_same_on_the_card(dev):
    """MAPQ's copies of XLA's exp, log1p, log and pow(10, x), and the
    mapping quality built from them, give the card the CPU's bits."""
    from blasr_tpu_torch.ops import xla_math
    from blasr_tpu_torch.ops.mapqv import map_qv_float

    rng = np.random.default_rng(6)
    cases = {
        xla_math.xla_exp: rng.uniform(-90, 40, 200_000),
        xla_math.xla_log1p: np.concatenate([rng.uniform(0, 1, 100_000),
                                            np.exp(rng.uniform(-40, 0, 100_000))]),
        xla_math.xla_log: np.exp(rng.uniform(-69, 40, 200_000)),
        xla_math.pow10: rng.uniform(-50, 40, 200_000),
    }
    for fn, x in cases.items():
        x = torch.from_numpy(x.astype(np.float32))
        assert torch.equal(fn(x.to(dev)).cpu().view(torch.int32), fn(x).view(torch.int32)), fn
    B, CD = 4096, 4
    n_err = torch.from_numpy(np.sort(rng.integers(0, 80, (B, CD)), axis=1).astype(np.int32))
    z = torch.zeros((B, CD), dtype=torch.int32)
    args = (-4000 + 5 * n_err, torch.ones((B, CD), dtype=torch.bool), z,
            torch.full((B, CD), 900, dtype=torch.int32),
            torch.full((B, CD), 800, dtype=torch.int32), z, n_err, z)
    kw = dict(mismatch_prob=1, ins_cost=1, del_cost=1)
    cpu = map_qv_float(*args, **kw)
    card = map_qv_float(*(a.to(dev) for a in args), **kw).cpu()
    assert torch.equal(card.view(torch.int32), cpu.view(torch.int32))



def _mapqv_on_the_card_equals_cpu(dev, args, kw=None):
    """The MAPQ kernel on the card against ``map_qv_float`` on the CPU:
    one launch, the float32 bits and the int32 result equal; returns the
    result."""
    from blasr_tpu_torch.ops import mapqv

    kw = kw or {}
    cpu = [torch.from_numpy(a) for a in args]
    want_q = mapqv.map_qv_float(*cpu, **kw)
    want = torch.clamp(want_q, 0, mapqv.MAX_PHRED).to(torch.int32)
    before = mapqv.map_qv_reference.launches
    got, got_q = mapqv.map_qv_kernel(*(a.to(dev) for a in cpu), **kw)
    torch.cuda.synchronize()
    assert mapqv.map_qv_reference.launches == before + 1
    assert torch.equal(got_q.cpu().view(torch.int32), want_q.view(torch.int32))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(mapqv.map_qv_reference(*(a.to(dev) for a in cpu), **kw).cpu(), want)
    return want


@pytest.mark.parametrize("CD", [1, 2, 4, 10, 24])
def test_mapqv_kernel_matches_plain(dev, CD):
    """Random reads with near-duplicate placements and score ties, at the
    cells' CD of 10, at small CDs and at 24, wider than any cell's."""
    from mapq_cases import random_case

    want = _mapqv_on_the_card_equals_cpu(dev, random_case(CD, 100 + CD, B=1024))
    assert CD == 1 or len(torch.unique(want)) > 5


def test_mapqv_kernel_branches(dev):
    """Each branch of the plain version (``tests/mapq_cases.BRANCH_ROWS``):
    psize <= 1, sub < -20, one_minus <= 0 and < 0, no valid candidate,
    invalid candidates between valid ones, subnormal intermediates."""
    from mapq_cases import branch_cases

    args, wanted, _ = branch_cases()
    got = _mapqv_on_the_card_equals_cpu(dev, args).numpy()
    np.testing.assert_array_equal(got[wanted >= 0], wanted[wanted >= 0])


def test_mapqv_kernel_near_integer_qualities(dev):
    """Six-candidate partitions under unit costs whose float qualities fall
    near integers (``test_mapq_math_is_the_same_on_the_card``'s rows, six
    candidates wide): the truncation sees the CPU's last bits."""
    rng = np.random.default_rng(8)
    B, CD = 8192, 6
    n_err = np.sort(rng.integers(0, 80, (B, CD)), axis=1).astype(np.int32)
    z = np.zeros((B, CD), np.int32)
    args = (-4000 + 5 * n_err, np.ones((B, CD), bool), z, np.full((B, CD), 900, np.int32),
            np.full((B, CD), 800, np.int32), z, n_err, z)
    _mapqv_on_the_card_equals_cpu(dev, args, dict(mismatch_prob=1, ins_cost=1, del_cost=1))


@pytest.mark.parametrize("fault", ["valid_dtype", "lo_on_cpu", "hi_strided", "nm_shape"])
def test_mapqv_wrapper_validates_inputs(dev, fault):
    from blasr_tpu_torch.ops.mapqv import map_qv_reference
    from mapq_cases import random_case

    args = [torch.from_numpy(a).to(dev) for a in random_case(4, 3, B=8)]
    if fault == "valid_dtype":
        args[1] = args[1].to(torch.uint8)
    elif fault == "lo_on_cpu":
        args[2] = args[2].cpu()
    elif fault == "hi_strided":
        args[3] = torch.cat([args[3], args[3]], dim=1)[:, ::2]
    else:
        args[4] = args[4][:, :3].contiguous()
    with pytest.raises(ValueError):
        map_qv_reference(*args)


def test_mapqv_one_launch_per_main_dp_call(dev):
    """A batch mapped with the ``ecoli_m4`` cell's flags (at this genome's
    seed length): one MAPQ launch per DP call, and the records equal those
    of the same run with MAPQ's plain version on the card."""
    from blasr_tpu_torch import ops
    from blasr_tpu_torch.cli.args import build_arg_parser, params_from_args
    from blasr_tpu_torch.index.artifacts import build_index_from_arrays
    from blasr_tpu_torch.io.batching import Read
    from blasr_tpu_torch.io.seqdb import SeqDB
    from blasr_tpu_torch.ops import mapqv
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.pipeline import mapper
    from blasr_tpu_torch.pipeline.runner import run_mapping

    rng = np.random.default_rng(29)
    G = 200_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[120_000:122_000] = genome[20_000:22_000]   # a repeat: MAPQ below 254
    index = build_index_from_arrays(genome, SeqDB(["ref"], np.array([0, G]), ["0" * 32]), k=10)
    reads = []
    for i in range(48):
        if i % 4 == 0:   # inside the repeat's first copy
            s, n = 20_000 + int(rng.integers(0, 900)), int(rng.integers(300, 1000))
        else:
            s, n = int(rng.integers(0, G - 3000)), int(rng.integers(300, 2500))
        r = genome[s : s + n].copy()
        r[::29] = (r[::29] + 1) % 4
        reads.append(Read(f"r{i}", r, None, i))
    args = build_arg_parser().parse_args(
        ["r.fa", "g.fa", "-m", "4", "-bestn", "1", "-nCandidates", "10", "-maxReadLen", "3328",
         "-batchSize", "1024", "-minMatch", "10"])
    params = params_from_args(args)

    def plain(*a, **kw):
        q = mapqv.map_qv_float(*a, **kw)
        return torch.clamp(q, 0, mapqv.MAX_PHRED).to(torch.int32)

    kept = mapper.map_qv_reference
    mapper.map_qv_reference = plain
    try:
        want = run_mapping(index, reads, params, device="cuda")
    finally:
        mapper.map_qv_reference = kept
    ops.reset_launch_counts()
    got = run_mapping(index, reads, params, device="cuda")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert [format_m4(r) for r in got[0]] == [format_m4(r) for r in want[0]]
    assert got[1] == want[1] and len(got[0]) >= 40
    assert launches["mapqv"] == launches["banded_dp"] >= 1
    assert {r.mapqv for r in got[0]} - {254}


WALK_NUM = 33437


def _walk_case(dev, W, band):
    """The walk's inputs on the card for ``_dp_case``'s items: arrows from
    the DP kernel (with the same items' knots for ``band == "knots"``),
    every fifth score set to 0 and every seventh from the second to 4, so
    those items are never active, and the band in the form ``band``."""
    from blasr_tpu_torch.ops.banded_cuda import banded_align

    args = [a.to(dev) for a in _dp_case(W + 5, W, num=WALK_NUM)]
    L, T = args[0].shape[1], args[2].shape[1]
    drift = dict(qoff_params=((T - L) // 2, W, L), qoff_num=WALK_NUM)
    if band == "knots":
        knots = _knots(W + 5, W).to(dev)
        res = banded_align(*args[:5], None, knots=knots, with_traceback=True, band_width=W)
        kw = dict(drift, qoff_knots=knots)
    else:
        res = banded_align(*args, with_traceback=True, band_width=W)
        kw = {"table": {}, "drift_int": drift,
              "drift_tensor": dict(drift, qoff_num=torch.tensor(WALK_NUM, dtype=torch.int32,
                                                                device=dev))}[band]
    scores = res.score.clone()
    scores[::5] = 0
    scores[1::7] = 4
    assert (scores < 0).sum() > 0 and (scores >= 0).sum() > 0
    return (res.arrows, args[5], res.best_a, res.best_w, scores), kw


def _walk_edge_case(dev, case):
    """Paths that leave the matrix at a < 0 (``left``: deletions from a0 =
    40), at w < 0 (``up``: insertions), that run into the sub-step cap
    (``cap``: a0 far past S - 1, so a path of deletions outlives the loop),
    and random words (``random``: every source, E and F bits, run and
    mismatch fields, starts outside the matrix), with the table band or
    the drift band."""
    from blasr_tpu_torch.ops.banded_align import SRC_LEFT, SRC_UP

    S, I, W = 84, 3, 32
    qoff = torch.zeros(S, dtype=torch.int32)
    kw = {}
    if case == "random":
        rng = np.random.default_rng(5)
        S, I = 60, 256
        arrows = torch.from_numpy(rng.integers(0, 1 << 16, (S, I, W)).astype(np.uint16))
        qoff = torch.from_numpy(np.cumsum(rng.integers(0, 2, S)).astype(np.int32))
        best_a = torch.from_numpy(rng.integers(-2, S + 3, I).astype(np.int32))
        best_w = torch.from_numpy(rng.integers(-1, W + 1, I).astype(np.int32))
        scores = torch.from_numpy(rng.integers(-3, 2, I).astype(np.int32))
        kw = dict(qoff_params=(10, W, 50), qoff_num=30011)
    else:
        arrows = torch.full((S, I, W), SRC_UP if case == "up" else SRC_LEFT, dtype=torch.uint16)
        best_a = torch.full((I,), {"left": 40, "up": 83, "cap": 3 * S}[case], dtype=torch.int32)
        best_w = torch.tensor([0, 5, 31], dtype=torch.int32)
        scores = torch.tensor([-5, 0, -1], dtype=torch.int32)
    return [t.to(dev) for t in (arrows, qoff, best_a, best_w, scores)], kw


def _assert_walk_on_the_card_equals_plain(dev, args, kw, moves):
    """The kernel's walk, made under ``set_sync_debug_mode("error")`` (so
    nothing waits for the device), equals the plain walk on the CPU in
    every field, and counts one launch."""
    from blasr_tpu_torch.ops.traceback_device import walk_arrows_device, walk_arrows_plain

    def cpu(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    ref = walk_arrows_plain(*[cpu(a) for a in args], with_moves=moves,
                            **{k: cpu(v) for k, v in kw.items()})
    torch.cuda.synchronize()
    before = walk_arrows_device.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = walk_arrows_device(*args, with_moves=moves, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert walk_arrows_device.launches == before + 1
    for f in ref._fields:
        r, g = getattr(ref, f), getattr(got, f)
        if r is None:
            assert g is None, f
            continue
        assert g.dtype == r.dtype and g.is_cuda, f
        assert torch.equal(g.cpu(), r), f


@pytest.mark.parametrize("W", [32, 64, 128, 256])
@pytest.mark.parametrize("band", ["table", "drift_int", "drift_tensor", "knots"])
@pytest.mark.parametrize("moves", [False, True])
def test_walk_kernel_matches_plain(dev, W, band, moves):
    args, kw = _walk_case(dev, W, band)
    _assert_walk_on_the_card_equals_plain(dev, args, kw, moves)


@pytest.mark.parametrize("case", ["left", "up", "cap", "random"])
@pytest.mark.parametrize("moves", [False, True])
def test_walk_kernel_edges_match_plain(dev, case, moves):
    args, kw = _walk_edge_case(dev, case)
    _assert_walk_on_the_card_equals_plain(dev, args, kw, moves)


def test_kernel_wrappers_validate_inputs(dev):
    from blasr_tpu_torch.ops.gather import gather_rows, gather_spans

    with pytest.raises(ValueError):
        gather_spans(torch.zeros(64, dtype=torch.int64, device=dev),
                     torch.zeros(4, dtype=torch.int32, device=dev), 8)
    with pytest.raises(ValueError):
        gather_rows(torch.zeros((8, 8), dtype=torch.int32, device=dev)[:, ::2],
                    torch.zeros(4, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        gather_spans(torch.zeros(64, dtype=torch.int32, device=dev),
                     torch.zeros((2, 2), dtype=torch.int32, device=dev), 8)
    with pytest.raises(ValueError):
        gather_spans(torch.zeros(64, dtype=torch.int32, device=dev),
                     torch.zeros(4, dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        gather_spans(torch.zeros(0, dtype=torch.int32, device=dev),
                     torch.zeros(4, dtype=torch.int32, device=dev), 8)
    with pytest.raises(ValueError):
        gather_spans(torch.zeros(64, dtype=torch.int32, device=dev),
                     torch.zeros(4, dtype=torch.int32, device=dev), 0)
    with pytest.raises(ValueError):
        gather_rows(torch.zeros((0, 8), dtype=torch.int32, device=dev),
                    torch.zeros(4, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        gather_rows(torch.zeros((8, 8), dtype=torch.int32, device=dev),
                    torch.zeros(4, dtype=torch.int64, device=dev))



def _walk_inputs(dev, I=4, S=16, W=32):
    i32 = torch.int32
    return [torch.zeros((S, I, W), dtype=torch.uint16, device=dev),
            torch.zeros(S, dtype=i32, device=dev), torch.zeros(I, dtype=i32, device=dev),
            torch.zeros(I, dtype=i32, device=dev), torch.full((I,), -1, dtype=i32, device=dev)]


@pytest.mark.parametrize("fault", ["arrows_dtype", "scores_on_cpu", "best_a_strided",
                                   "knots_shape", "qoff_num_dtype", "qoff_shape"])
def test_walk_wrapper_validates_inputs(dev, fault):
    from blasr_tpu_torch.ops.traceback_device import walk_arrows_device

    args, kw = _walk_inputs(dev), {}
    if fault == "arrows_dtype":
        args[0] = args[0].to(torch.int32)
    elif fault == "scores_on_cpu":
        args[4] = args[4].cpu()
    elif fault == "best_a_strided":
        args[2] = torch.zeros(8, dtype=torch.int32, device=dev)[::2]
    elif fault == "knots_shape":
        kw = dict(qoff_knots=torch.zeros((4, 1), dtype=torch.int32, device=dev))
    elif fault == "qoff_num_dtype":
        kw = dict(qoff_params=(0, 32, 8), qoff_num=torch.tensor(3.0e4, device=dev))
    else:
        args[1] = args[1][:8]
    with pytest.raises(ValueError):
        walk_arrows_device(*args, **kw)


@pytest.mark.parametrize("qual", [None, "single", "dual"])
def test_mapping_on_the_card_equals_cpu(dev, qual):
    from blasr_tpu_torch import bench
    from blasr_tpu_torch.index.artifacts import build_index_from_arrays
    from blasr_tpu_torch.io.batching import Read
    from blasr_tpu_torch.io.seqdb import SeqDB
    from blasr_tpu_torch.ops import launch_counts, reset_launch_counts
    from blasr_tpu_torch.ops.banded_cuda import banded_align
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.pipeline.runner import run_mapping

    rng = np.random.default_rng(11)
    G = 100_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    index = build_index_from_arrays(genome, SeqDB(["ref"], np.array([0, G]), ["0" * 32]), k=10)
    reads = []
    for i in range(16):
        s = int(rng.integers(0, G - 1000))
        r = genome[s : s + int(rng.integers(300, 900))].copy()
        r[::17] = (r[::17] + 1) % 4
        q = rng.integers(3, 45, len(r)).astype(np.uint8) if qual else None
        qvs = {"iq": q[::-1].copy(), "sq": q} if qual == "dual" and i % 2 else None
        reads.append(Read(f"r{i}", r, q, i, qvs=qvs))
    params = bench.bench_params(batch_size=8, max_read_len=1024, min_match_length=10)
    cpu = run_mapping(index, reads, params, device="cpu")
    reset_launch_counts()
    gpu = run_mapping(index, reads, params, device="cuda")
    assert [format_m4(r) for r in gpu[0]] == [format_m4(r) for r in cpu[0]]
    assert gpu[1] == cpu[1]
    assert all(v > 0 for v in launch_counts().values())
    assert launch_counts()["traceback_walk"] == launch_counts()["banded_dp"]
    assert banded_align.launches_by_shape[(32, qual or "none")] > 0


def test_guided_matrix_mapping_on_the_card_equals_cpu(dev):
    from blasr_tpu_torch import bench
    from blasr_tpu_torch.index.artifacts import build_index_from_arrays
    from blasr_tpu_torch.io.batching import Read
    from blasr_tpu_torch.io.seqdb import SeqDB
    from blasr_tpu_torch.ops import reset_launch_counts
    from blasr_tpu_torch.ops.banded_cuda import banded_align
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.pipeline.runner import run_mapping

    rng = np.random.default_rng(13)
    G = 100_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    index = build_index_from_arrays(genome, SeqDB(["ref"], np.array([0, G]), ["0" * 32]), k=10)
    reads = []
    for i in range(16):
        s = int(rng.integers(0, G - 1000))
        r = genome[s : s + int(rng.integers(200, 900))].copy()
        r[::19] = (r[::19] + 2) % 4
        if i % 4 == 1:
            r = np.concatenate([r[:100], rng.integers(0, 4, 40).astype(np.uint8), r[100:]])
        reads.append(Read(f"r{i}", r, rng.integers(3, 45, len(r)).astype(np.uint8), i))
    mat = (-5, 6, -2, 6, 0, 6, -5, 6, -2, 0, -2, 6, -5, 6, 0, 6, -2, 6, -5, 0, 0, 0, 0, 0, 0)
    params = bench.bench_params(batch_size=8, max_read_len=1024, min_match_length=10,
                                narrow_band_max=512, guided_band=True, score_matrix=mat)
    cpu = run_mapping(index, reads, params, device="cpu")
    reset_launch_counts()
    gpu = run_mapping(index, reads, params, device="cuda")
    assert [format_m4(r) for r in gpu[0]] == [format_m4(r) for r in cpu[0]]
    assert gpu[1] == cpu[1]
    by_shape = banded_align.launches_by_shape
    assert by_shape[(32, "guided")] > 0 and by_shape[(128, "guided")] > 0
    assert by_shape[(32, "matrix")] > 0


def test_wire_at_best_n_2_with_moves_on_the_card_equals_cpu(dev):
    """Config 3's settings at a small size: the map_batch wire (two rows a
    read, the walk's packed move strings) byte for byte, and the -m 5
    lines with the host's secondary admission, on a genome with repeats."""
    from blasr_tpu_torch import bench
    from blasr_tpu_torch.index.artifacts import build_index_from_arrays
    from blasr_tpu_torch.io.batching import Read, batch_reads
    from blasr_tpu_torch.io.seqdb import SeqDB
    from blasr_tpu_torch.output.verbose import format_m5
    from blasr_tpu_torch.pipeline.mapper import Mapper
    from blasr_tpu_torch.pipeline.runner import run_mapping

    rng = np.random.default_rng(17)
    G = 100_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    for src, dst, d in ((5_000, 60_000, 0.03), (20_000, 80_000, 0.1)):
        seg = genome[src : src + 1500].copy()
        m = rng.random(1500) < d
        seg[m] = (seg[m] + 1) % 4
        genome[dst : dst + 1500] = seg
    index = build_index_from_arrays(genome, SeqDB(["ref"], np.array([0, G]), ["0" * 32]), k=10)
    reads = []
    for i in range(16):
        s = (5_000, 20_000)[i % 2] + int(rng.integers(0, 700)) if i < 10 else int(
            rng.integers(0, G - 1000))
        r = genome[s : s + int(rng.integers(300, 800))].copy()
        r[::17] = (r[::17] + 1) % 4
        reads.append(Read(f"r{i}", r, None, i))
    params = dataclasses.replace(bench.config3_params(), batch_size=8, max_read_len=1024,
                                 min_match_length=10)
    cpu_m, gpu_m = Mapper(index, params, device="cpu"), Mapper(index, params, device="cuda")
    for b in batch_reads(reads, params.batch_size, params.max_read_len):
        c = cpu_m.map_batch(b.codes, b.lengths)
        g = gpu_m.map_batch(b.codes, b.lengths)
        assert (g.i2, g.p) == (c.i2, c.p) and g.i2 == 2 * b.codes.shape[0] and g.p > 0
        assert torch.equal(g.wire.cpu(), c.wire)
    by = {r.name: r for r in reads}
    cpu = run_mapping(index, reads, params, device="cpu")
    gpu = run_mapping(index, reads, params, device="cuda")
    lines = [format_m5(r, by[r.qname], index) for r in gpu[0]]
    assert lines == [format_m5(r, by[r.qname], index) for r in cpu[0]]
    assert gpu[1] == cpu[1] and len(gpu[0]) > len({r.qname for r in gpu[0]})


@pytest.mark.parametrize("width", [1, 7, 577])
def test_pack_codes_rows_on_the_card_equals_cpu(dev, width):
    from blasr_tpu_torch.ops.traceback_device import pack_codes_rows

    rng = np.random.default_rng(width)
    I2, S = 64, 4 * width + 5
    # boundary codes: a run's code where it starts, 0 inside it, rising
    codes = np.zeros((I2, S), np.int32)
    for i in range(I2):
        at = np.sort(rng.choice(S, size=min(S, 1 + S // 9), replace=False))
        codes[i, at] = 4 * np.arange(1, len(at) + 1) + rng.integers(1, 4, len(at))
    nops = rng.integers(0, 4 * width + 3, I2).astype(np.int32)
    nops[:2] = [0, 4 * width]
    c, n = torch.from_numpy(codes), torch.from_numpy(nops)
    assert torch.equal(pack_codes_rows(c.to(dev), n.to(dev), width).cpu(),
                       pack_codes_rows(c, n, width))


@pytest.mark.parametrize("best_n", [1, 2])
def test_sam_lines_on_the_card_equal_cpu(dev, best_n):
    """Config 2's settings at a small size, and with -bestn 2 on a genome
    with a repeat: the SAM lines (every clip mode) of a card run equal the
    CPU run's, tolerance 0; at best_n 1 reads with an insertion burst
    escalate to the wide band, whose move strings the card's walk returns."""
    import io

    from blasr_tpu_torch import bench
    from blasr_tpu_torch.index.artifacts import build_index_from_arrays
    from blasr_tpu_torch.io.batching import Read
    from blasr_tpu_torch.io.seqdb import SeqDB
    from blasr_tpu_torch.output.sam_writer import write_sam
    from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping

    rng = np.random.default_rng(19 + best_n)
    G = 100_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    seg = genome[5_000:6_500].copy()
    seg[rng.random(1500) < 0.04] = 1
    genome[70_000:71_500] = seg
    seqdb = SeqDB(["chrA", "chrB"], np.array([0, 40_000, G]), ["0" * 32] * 2)
    index = build_index_from_arrays(genome, seqdb, k=10)
    reads = []
    for i in range(24):
        s = 5_000 + int(rng.integers(0, 600)) if i % 3 == 0 else int(rng.integers(0, G - 1500))
        r = genome[s : s + int(rng.integers(300, 1200))].copy()
        r[::17] = (r[::17] + 1) % 4
        if i % 5 == 4:                       # an insertion burst the narrow band clips
            r = np.concatenate([r[:150], rng.integers(0, 4, 80).astype(np.uint8), r[150:]])
        if i % 2:
            r = np.where(r < 4, 3 - r, r)[::-1].copy()
        reads.append(Read(f"r{i}", r, rng.integers(3, 40, len(r)).astype(np.uint8), i))
    params = bench.bench_params(batch_size=8, max_read_len=1536, narrow_band_max=1536,
                                min_match_length=10, emit_moves=True, best_n=best_n)
    out = {}
    for device in ("cpu", "cuda"):
        met = MappingMetrics()
        recs, unm = run_mapping(index, reads, params, device=device, metrics=met)
        texts = []
        for clipping in ("soft", "hard", "none", "subread"):
            buf = io.StringIO()
            write_sam(recs, reads, seqdb, buf, clipping=clipping, unmapped=unm,
                      movie_name="reads.fastq", genome=genome)
            texts.append(buf.getvalue())
        out[device] = (texts, met.escalated_reads, len(recs) - len({r.qname for r in recs}))
    assert out["cuda"] == out["cpu"]
    # best_n 1 escalates reads to the wide band; best_n 2 emits secondaries
    assert out["cpu"][1 if best_n == 1 else 2] > 0


def test_secondary_refinement_on_the_card_equals_cpu(dev):
    """BLASR reference config 2 (``-sam -clipping soft -bestn 10
    -nCandidates 10``, at this genome's seed length) on FASTQ reads over
    two planted repeat copies, each with a 150-base insertion the narrow
    band cannot cross: the secondaries on the copies take the SDP chain's
    span and are refined along it. The card's SAM text and records equal
    the CPU run's, tolerance 0, and the card's refinement costs two
    launches a batch that has such records: one guided DP (``W32/guided``)
    and one walk."""
    import io

    from blasr_tpu_torch import ops
    from blasr_tpu_torch.cli.args import build_arg_parser, params_from_args
    from blasr_tpu_torch.index.artifacts import build_index_from_arrays
    from blasr_tpu_torch.io.batching import Read
    from blasr_tpu_torch.io.seqdb import SeqDB
    from blasr_tpu_torch.output.sam_writer import write_sam
    from blasr_tpu_torch.pipeline.runner import MappingMetrics, run_mapping

    rng = np.random.default_rng(23)
    G = 100_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    for src, dst, ln in ((5_000, 70_000, 1200), (20_000, 50_000, 1000)):
        seg = genome[src : src + ln].copy()
        m = rng.random(ln) < 0.05
        seg[m] = (seg[m] + 1) % 4
        seg = np.concatenate([seg[: ln // 2], rng.integers(0, 4, 150).astype(np.uint8),
                              seg[ln // 2 :]])
        genome[dst : dst + len(seg)] = seg
    seqdb = SeqDB(["chrA", "chrB"], np.array([0, 40_000, G]), ["0" * 32] * 2)
    index = build_index_from_arrays(genome, seqdb, k=10)
    reads = []
    for i in range(8):
        s = (5_000, 20_000)[i % 2] + int(rng.integers(0, 200))
        r = genome[s : s + int(rng.integers(700, 1000))].copy()
        r[::23] = (r[::23] + 1) % 4
        if i % 3 == 1:
            r = np.where(r < 4, 3 - r, r)[::-1].copy()
        reads.append(Read(f"r{i}", r, rng.integers(10, 41, len(r)).astype(np.uint8), i))
    args = build_arg_parser().parse_args(
        ["r.fastq", "g.fa", "-sam", "-clipping", "soft", "-bestn", "10", "-nCandidates", "10",
         "-maxReadLen", "1024", "-batchSize", "8", "-minMatch", "10"])
    params = params_from_args(args)
    out = {}
    for device in ("cpu", "cuda"):
        ops.reset_launch_counts()
        met = MappingMetrics()
        recs, unm = run_mapping(index, reads, params, device=device, metrics=met)
        buf = io.StringIO()
        write_sam(recs, reads, seqdb, buf, clipping="soft", unmapped=unm,
                  movie_name="reads.fastq", genome=genome)
        out[device] = (buf.getvalue(), [(r.qname, r.score, r.refined) for r in recs],
                       ops.counters()["secondary"])
        if device == "cuda":
            torch.cuda.synchronize()
            launches, by_shape, batches = ops.launch_counts(), ops.dp_launch_counts(), met.n_batches
            escalated = met.escalated_reads
    assert out["cuda"] == out["cpu"]
    counts = out["cuda"][2]
    assert counts["refined"] >= 1 and counts["refine_calls"] == 1 and escalated == 0
    # one batch: its DP and walk, then the refinement's guided DP and walk
    assert by_shape["W32/guided"] == counts["refine_calls"]
    assert launches["banded_dp"] == launches["traceback_walk"] == batches + counts["refine_calls"]


@pytest.mark.parametrize("stride", [1, 4])
def test_fm_anchors_on_the_card_equal_cpu(dev, stride):
    """FM backward search, locate and anchor selection: the card's four
    outputs equal the CPU's (integers, tolerance 0), on a genome with an N
    run whose n = G + 1 is a multiple of the 128-byte rank row."""
    from blasr_tpu_torch.index.fm import build_fm_index
    from blasr_tpu_torch.index.suffix_array import build_suffix_array
    from blasr_tpu_torch.ops.fm_search import find_anchors_fm

    rng = np.random.default_rng(stride)
    G = 128 * 400 - 1
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[9_000:9_040] = 4
    genome[30_000:31_000] = genome[2_000:3_000]          # a repeat
    fm = build_fm_index(genome, build_suffix_array(genome))
    B, L = 16, 1024
    codes = np.full((B, L), 4, np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    for b in range(B):
        s = int(rng.integers(0, G - L))
        codes[b, : lengths[b]] = genome[s : s + lengths[b]]
    arrays = (fm.bwt_rows, fm.occ_bins, fm.C.astype(np.int32), fm.ssa_mask.astype(np.int64),
              fm.ssa_base, fm.ssa_vals.astype(np.int32), rng.random(G) > 0.05)
    kw = dict(k=14, n=fm.n, max_hits_per_pos=8, max_anchors_per_read=128,
              anchor_stride=stride)

    def run(device):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (codes, lengths, *arrays)]
        return [x.cpu() for x in find_anchors_fm(*t, **kw)]

    cpu, gpu = run("cpu"), run(dev)
    for a, b in zip(cpu, gpu):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(cpu[3].sum()) > 500


@pytest.mark.parametrize("expand", [0, 1])
@pytest.mark.parametrize("k", [15, 18])
def test_sa_anchors_on_the_card_equal_cpu(dev, k, expand):
    """The bisection (k = 15) and wide-key (k = 18) anchor searches: the
    card's four outputs equal the CPU's (integers, tolerance 0), at the
    bench stride, on a genome with an N run and a ten-copy repeat."""
    from blasr_tpu_torch.index.artifacts import build_index_from_arrays
    from blasr_tpu_torch.io.seqdb import SeqDB
    from blasr_tpu_torch.ops.anchors import find_anchors_bisect, find_anchors_wide
    from blasr_tpu_torch.params import MappingParams
    from blasr_tpu_torch.pipeline.mapper import make_device_index

    rng = np.random.default_rng(k)
    G = 200_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[9_000:9_040] = 4
    for j in range(10):
        genome[50_000 + 700 * j : 50_000 + 700 * j + 600] = genome[2_000:2_600]
    index = build_index_from_arrays(genome, SeqDB(["a", "b"], np.array([0, 120_000, G]),
                                                  ["0" * 32] * 2), k)
    params = MappingParams(max_read_len=1024, min_match_length=k, direct_lut=True)
    B, L = 32, 1024
    codes = np.full((B, L), 4, np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    for b in range(B):
        s = 1_900 if b < 4 else int(rng.integers(0, G - L))
        codes[b, : lengths[b]] = genome[s : s + lengths[b]]
        codes[b, ::53] = rng.integers(0, 4)
    def run(device):
        di = make_device_index(index, params, device)
        assert di.kind == ("wide" if k > 15 else "bisect") and di.lut_meta[1] > 0
        search = find_anchors_wide if di.kind == "wide" else find_anchors_bisect
        t = [torch.from_numpy(a).to(device) for a in (codes, lengths)]
        return [x.cpu() for x in search(*t, *di.arrays, k=k, max_hits_per_pos=8,
                                        max_anchors_per_read=128, lut_meta=di.lut_meta,
                                        anchor_stride=4, expand=expand)]

    cpu, gpu = run("cpu"), run(dev)
    for a, b in zip(cpu, gpu):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(cpu[3].sum()) > 300


def test_chain_weight_on_the_card_equals_cpu(dev):
    """exact_chain's loop on the card: the same int32 weights as on the CPU."""
    from blasr_tpu_torch.ops.candidates import chain_weight_device

    rng = np.random.default_rng(23)
    B, A, C, k, win = 64, 128, 4, 14, 128
    t = rng.integers(0, 40_000, (B, A)).astype(np.int32)
    q = rng.integers(0, 800, (B, A)).astype(np.int32)
    for b in range(B):
        sel = rng.choice(A, 40, replace=False)
        t[b, sel] = q[b, sel] + 5_000 + rng.integers(0, win, 40)
    valid = rng.random((B, A)) < 0.8
    dstar = np.stack([(t[b] - q[b])[rng.choice(A, C, replace=False)] for b in range(B)])
    cvalid = rng.random((B, C)) < 0.9
    args = [torch.from_numpy(a) for a in (t, q, valid, dstar, cvalid)]
    cpu = chain_weight_device(*args, k=k, win=win)
    gpu = chain_weight_device(*[a.to(dev) for a in args], k=k, win=win)
    assert torch.equal(gpu.cpu(), cpu) and (cpu > 0).any()


@pytest.mark.parametrize("mode", [dict(pval_type=2), dict(pval_type=3), dict(exact_chain=True),
                                  dict(adaptive_cd=True, max_expand=2, sensitive_retry=True)],
                         ids=["pvaltype2", "pvaltype3", "exact_chain", "passes"])
def test_modes_on_the_card_equal_cpu(dev, mode):
    """The ranking modes' wire bytes and every mode's -m 4 lines on the card
    equal the CPU's: an 80 kb genome with a repeat, reads that map plainly,
    from the repeat, with a substitution every 11 bases (the expand
    cascade's) and at about 77% similarity (the sensitive retry's)."""
    from blasr_tpu_torch.index.artifacts import build_index_from_arrays
    from blasr_tpu_torch.io.batching import Read, batch_reads
    from blasr_tpu_torch.io.seqdb import SeqDB
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.params import MappingParams
    from blasr_tpu_torch.pipeline.mapper import Mapper
    from blasr_tpu_torch.pipeline.runner import run_mapping

    rng = np.random.default_rng(41)
    g = rng.integers(0, 4, 80_000).astype(np.uint8)
    g[50_000:52_000] = g[10_000:12_000]
    index = build_index_from_arrays(g, SeqDB(["ref"], np.array([0, len(g)]), ["0" * 32]), k=11)
    reads = []
    for i, s in enumerate((15_000, 16_000, 17_000, 10_300, 10_900, 24_000, 54_000, 26_000)):
        r = g[s : s + 200 + 5 * i].copy()
        if i < 5:
            r[5::19] = (r[5::19] + 1) % 4
        elif i < 7:
            r[6::11] = (r[6::11] + 1) % 4
        else:
            for b in range(120, len(r), 16):
                r[b + 1 : b + 15 : 2] = (r[b + 1 : b + 15 : 2] + 1) % 4
        reads.append(Read(f"r{i}", r, None, i))
    params = MappingParams(batch_size=4, max_read_len=256, n_candidates=4, n_dp_candidates=2,
                           anchor_stride=4, max_anchors_per_read=128, narrow_band=32,
                           narrow_band_max=256, min_match_length=11, direct_lut=True,
                           emit_moves=False, best_n=1, **mode)
    cpu_m, gpu_m = Mapper(index, params, device="cpu"), Mapper(index, params, device="cuda")
    for b in batch_reads(reads, params.batch_size, params.max_read_len):
        assert torch.equal(gpu_m.map_batch(b.codes, b.lengths).wire.cpu(),
                           cpu_m.map_batch(b.codes, b.lengths).wire)
    cpu = run_mapping(index, reads, params, device="cpu")
    gpu = run_mapping(index, reads, params, device="cuda")
    assert [format_m4(r) for r in gpu[0]] == [format_m4(r) for r in cpu[0]]
    assert gpu[1] == cpu[1] and cpu[0]


def _parallel_case():
    from blasr_tpu_torch import bench
    from blasr_tpu_torch.index.artifacts import build_index_from_arrays
    from blasr_tpu_torch.io.batching import Read
    from blasr_tpu_torch.io.seqdb import SeqDB

    rng = np.random.default_rng(23)
    G = 120_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    seqdb = SeqDB(["a", "b"], np.array([0, 70_000, G]), ["0" * 32] * 2)
    reads = []
    for i in range(16):
        s = int(rng.integers(0, G - 1000))
        r = genome[s : s + int(rng.integers(300, 900))].copy()
        at = np.arange(0, len(r), 15)
        r = np.delete(r, at) if i % 2 else np.insert(r, at, rng.integers(0, 4, len(at)).astype(np.uint8))
        reads.append(Read(f"r{i}", r, None, i))
    params = bench.bench_params(batch_size=8, max_read_len=1024, min_match_length=11)
    return genome, seqdb, build_index_from_arrays(genome, seqdb, k=11), reads, params


def test_split_batch_on_the_card_equals_cpu(dev):
    """A batch split over [cuda:0, cuda:0] (one slope median over both
    slices): the CPU's one-device wire, and run_mapping's lines."""
    from blasr_tpu_torch.io.batching import batch_reads
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.pipeline.mapper import Mapper
    from blasr_tpu_torch.pipeline.runner import run_mapping

    _, _, index, reads, params = _parallel_case()
    cpu_m = Mapper(index, params, device="cpu")
    split_m = Mapper(index, params, device="cuda", devices=["cuda:0", "cuda:0"])
    for b in batch_reads(reads, params.batch_size, params.max_read_len):
        assert torch.equal(split_m.map_batch(b.codes, b.lengths).wire.cpu(),
                           cpu_m.map_batch(b.codes, b.lengths).wire)
    cpu = run_mapping(index, reads, params, device="cpu")
    gpu = run_mapping(index, reads, params, device="cuda", devices=["cuda:0"] * 4)
    assert [format_m4(r) for r in gpu[0]] == [format_m4(r) for r in cpu[0]] and cpu[0]


@pytest.mark.parametrize("route", [False, True])
def test_sharded_mapping_on_the_card_equals_cpu(dev, route):
    """Three shards on cuda:0 (repeated in the device list) against the
    same shards on the CPU; the ShardedServer's calls too."""
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.parallel import sharded

    genome, seqdb, _, reads, params = _parallel_case()
    kw = dict(n_shards=3, k=11, route=route)
    cpu = sharded.run_mapping_sharded(genome, seqdb, reads, params, devices=["cpu"], **kw)
    gpu = sharded.run_mapping_sharded(genome, seqdb, reads, params,
                                      devices=["cuda:0", "cuda:0"], **kw)
    assert [format_m4(r) for r in gpu[0]] == [format_m4(r) for r in cpu[0]] and cpu[0]
    assert gpu[1] == cpu[1]
    srv = sharded.ShardedServer(genome, seqdb, params, 3, k=11, devices=["cuda:0"],
                                route=route, max_resident=1)
    got = srv.map(reads)
    assert [format_m4(r) for r in got[0]] == [format_m4(r) for r in cpu[0]]
    assert sum("_torch_device_index_cache" in ix.__dict__ for ix in srv.indexes) <= 1


def test_sharded_threads_on_the_card_equal_serial(dev):
    """Four shards over the device list [cuda:0, cuda]: two names of the
    one card, so two threads map two shards each and launch K1, K2 and K3
    at once. Records and launch counts equal the serial run's."""
    from blasr_tpu_torch.ops import launch_counts, reset_launch_counts
    from blasr_tpu_torch.output.m4 import format_m4
    from blasr_tpu_torch.parallel import sharded

    genome, seqdb, _, reads, params = _parallel_case()
    kw = dict(n_shards=4, k=11)
    runs = {}
    for name, extra in (("serial", dict(devices=["cuda:0"], concurrent=False)),
                        ("threads", dict(devices=["cuda:0", "cuda"]))):
        reset_launch_counts()
        recs, unmapped = sharded.run_mapping_sharded(genome, seqdb, reads, params,
                                                     **kw, **extra)
        torch.cuda.synchronize()
        runs[name] = ([format_m4(r) for r in recs], unmapped, launch_counts())
    assert runs["threads"] == runs["serial"] and runs["serial"][0]
    assert min(runs["serial"][2].values()) > 0


def test_spans_hold_the_kernels_on_the_profilers_clock(dev):
    """A tracer's span opened before one long kernel and closed after its
    synchronise holds the kernel's device interval once converted onto the
    profiler's clock (``StageClock.to_wall_ns``)."""
    from torch.profiler import ProfilerActivity, profile

    from blasr_tpu_torch.pipeline.trace import StageClock

    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    clock = StageClock(dev, sync=False)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        clock.open("run")
        torch.cuda._sleep(100_000_000)
        torch.cuda.synchronize()
        clock.close()
    # the spin kernel of torch.cuda._sleep: the longest device event
    k = max((e for e in prof.profiler.kineto_results.events()
             if str(e.device_type()).endswith("CUDA")), key=lambda e: e.duration_ns())
    span = clock.spans[0]
    lo, hi = clock.to_wall_ns(span.start_ns), clock.to_wall_ns(span.end_ns)
    print(f"kernel {k.name()} {k.duration_ns()} ns from {k.start_ns()} ns; the span opened "
          f"{k.start_ns() - lo} ns before it and closed {hi - k.start_ns() - k.duration_ns()} "
          f"ns after it")
    assert lo <= k.start_ns() and k.start_ns() + k.duration_ns() <= hi
    assert span.memory is not None
