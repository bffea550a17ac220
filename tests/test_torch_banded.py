"""The port's banded DP, traceback walk and move packing against the JAX
package, bit for bit (tolerance 0: every output is integer).

Problems follow tests/test_pallas_interpret.py: reads embedded in random
targets, W in {32, 64, 128, 256}, the slope-0 schedule and a sloped
drift schedule (make_qoff_num)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasr_tpu.ops import banded_align as jba
from blasr_tpu.ops import traceback_device as jtb
from blasr_tpu_torch.ops import banded_align as tba
from blasr_tpu_torch.ops import traceback_device as ttb
from blasr_tpu_torch.ops.banded_cuda import banded_align as dp_wrapper

# The suite runs in parallel worker processes: one intra-op thread each
# keeps PyTorch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)


def _problem(seed, W, I=8, L=96, T=140, num=None, ragged=False):
    rng = np.random.default_rng(seed)
    Q = rng.integers(0, 4, (I, L)).astype(np.uint8)
    Tc = rng.integers(0, 4, (I, T)).astype(np.uint8)
    for i in range(I):
        Tc[i, 10 : 10 + L - 20] = Q[i, : L - 20]
    qlen = np.full(I, L, np.int32)
    tlo = np.zeros(I, np.int32)
    thi = np.full(I, T, np.int32)
    if ragged:
        # short reads (N padding), contig edges inside the window, N codes
        qlen[0] = L - 37
        Q[0, qlen[0]:] = 4
        tlo[1], thi[2] = 13, T - 29
        Q[3, 5] = 4
        Tc[4, 50:53] = 5
    num = jba.QOFF_NUM_HALF if num is None else num
    qoff = np.array(jba.make_qoff_num(L, T, W, (T - L) // 2, num))  # writable copy
    return Q, qlen, Tc, tlo, thi, qoff, num


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _arrow_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


CASES = [
    (W, num, ragged)
    for W in (32, 64, 128, 256)
    for num, ragged in ((None, False), (33437, True))
]


@pytest.mark.parametrize("W,num,ragged", CASES)
def test_banded_dp_and_walk_match_jax(W, num, ragged):
    Q, qlen, Tc, tlo, thi, qoff, n = _problem(W + (num or 0), W, num=num, ragged=ragged)
    ref = jba.banded_align(
        *(jnp.asarray(a) for a in (Q, qlen, Tc, tlo, thi, qoff)), None,
        with_traceback=True, band_width=W,
    )
    got = dp_wrapper(*_torch(Q, qlen, Tc, tlo, thi, qoff), with_traceback=True, band_width=W)
    for name in ("score", "best_a", "best_w"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)), getattr(got, name).numpy(), name)
    assert got.arrows.dtype == torch.uint16
    np.testing.assert_array_equal(np.asarray(ref.arrows), _arrow_bits(got.arrows))
    assert (np.asarray(ref.score) < 0).all()

    # the torch schedule builder gives the same qoff
    np.testing.assert_array_equal(
        tba.make_qoff_num(96, 140, W, 22, torch.tensor(n, dtype=torch.int32)).numpy(), qoff
    )

    diag = (140 - 96) // 2
    jw = jtb.walk_arrows_device(
        ref.arrows, jnp.asarray(qoff), ref.best_a, ref.best_w, ref.score,
        jnp.asarray(Q), jnp.asarray(Tc),
        qoff_params=(diag, W, 96), qoff_num=jnp.int32(n),
    )
    tq = torch.from_numpy(qoff)
    walks = [
        dict(qoff_params=(diag, W, 96), qoff_num=torch.tensor(n, dtype=torch.int32)),
        dict(),  # table branch: offsets read from qoff
    ]
    if num is None:
        walks.append(dict(qoff_params=(diag, W, 96)))  # slope 0 by default
    for kw in walks:
        tw = ttb.walk_arrows_device(
            got.arrows, tq, got.best_a, got.best_w, got.score, **kw
        )
        for f in jw._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jw, f)), getattr(tw, f).numpy(), f)

    S = qoff.shape[0]
    ow = jtb.packed_width(S)
    assert ttb.packed_width(S) == ow
    sel = np.array([3, 0, 5], np.int32)
    jp = jtb.pack_codes_rows(jw.moves_codes[sel], jw.nops[sel], ow)
    tp = ttb.pack_codes_rows(tw.moves_codes[sel], tw.nops[sel], ow)
    assert tp.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


def test_walk_without_moves_keeps_stats():
    Q, qlen, Tc, tlo, thi, qoff, _ = _problem(9, 32, ragged=True)
    got = dp_wrapper(*_torch(Q, qlen, Tc, tlo, thi, qoff), with_traceback=True, band_width=32)
    args = (got.arrows, torch.from_numpy(qoff), got.best_a, got.best_w, got.score)
    full = ttb.walk_arrows_device(*args)
    lean = ttb.walk_arrows_device(*args, with_moves=False)
    assert lean.moves_codes is None
    for f in full._fields[1:]:
        assert torch.equal(getattr(full, f), getattr(lean, f)), f


def test_walk_is_a_counted_kernel_wrapper():
    """The walk is the kernel wrapper ``traceback_walk``: its launches show
    in ``launch_counts()`` and ``reset_launch_counts()`` zeroes them; on the
    CPU it runs the plain walk, which counts activity checks, no launch."""
    from blasr_tpu_torch import ops

    assert ops.kernel_wrappers()["traceback_walk"] is ttb.walk_arrows_device
    ttb.walk_arrows_device.launches = 3
    assert ops.launch_counts()["traceback_walk"] == 3
    ops.reset_launch_counts()
    assert ops.launch_counts()["traceback_walk"] == 0
    Q, qlen, Tc, tlo, thi, qoff, _ = _problem(5, 32)
    got = dp_wrapper(*_torch(Q, qlen, Tc, tlo, thi, qoff), with_traceback=True, band_width=32)
    ttb.walk_arrows_device(got.arrows, torch.from_numpy(qoff), got.best_a, got.best_w, got.score)
    assert ops.launch_counts()["traceback_walk"] == 0
    assert ops.counters()["syncs"]["walk"] > 0


def _cu_constants(path):
    """name -> value of every ``constexpr int kName = <integer>`` in a CUDA
    source (comma-separated declarations included)."""
    text = re.sub(r"//[^\n]*", "", open(path).read())
    out = {}
    for decl in re.findall(r"constexpr int ([^;]*);", text):
        for part in decl.split(","):
            name, _, value = (x.strip() for x in part.partition("="))
            if re.fullmatch(r"-?\d+", value):
                out[name] = int(value)
    return out


def test_walk_kernel_reads_the_arrow_word_as_the_plain_code():
    """The walk kernel's constants (``csrc/traceback_walk.cu``, read from
    its text) are the arrow word's layout as the plain DP writes it and the
    plain walk reads it: the source codes, the E and F bits, the run and
    mismatch fields; and the ops, the schedules' shifts and the band forms
    as the plain walk and its wrapper number them."""
    import blasr_tpu_torch

    root = os.path.dirname(blasr_tpu_torch.__file__)
    got = _cu_constants(os.path.join(root, "csrc", "traceback_walk.cu"))
    want = {
        "kSrcDiag": tba.SRC_DIAG, "kSrcUp": tba.SRC_UP, "kSrcLeft": tba.SRC_LEFT,
        "kSrcE": tba.SRC_E, "kSrcF": tba.SRC_F, "kSrcStop": tba.SRC_STOP,
        "kSrcDiagStart": tba.SRC_DIAG_START, "kSrcMask": ttb.SRC_MASK,
        "kEShift": ttb.E_SHIFT, "kFShift": ttb.F_SHIFT, "kRunShift": ttb.RUN_SHIFT,
        "kRunMask": ttb.RUN_MASK, "kMisShift": ttb.MIS_SHIFT,
        "kOpM": ttb.OP_M, "kOpI": ttb.OP_I, "kOpD": ttb.OP_D,
        "kQoffShift": tba.QOFF_SHIFT, "kKnotLog2": tba.KNOT_LOG2,
        **{f"kBand{b.capitalize()}": i for i, b in enumerate(ttb.BANDS)},
    }
    assert {k: got.get(k) for k in want} == want
    # the plain DP packs its word with the same fields
    dp_src = open(os.path.join(root, "ops", "banded_align.py")).read()
    shifts = re.search(r"word = src \| \(ebit << (\d+)\) \| \(fbit << (\d+)\) "
                       r"\| \(R_new << (\d+)\) \| \(M_emit << (\d+)\)", dp_src)
    assert tuple(map(int, shifts.groups())) == (ttb.E_SHIFT, ttb.F_SHIFT, ttb.RUN_SHIFT,
                                                ttb.MIS_SHIFT)
    # the source field is the bits below the E bit, and holds every source
    assert ttb.SRC_MASK == (1 << ttb.E_SHIFT) - 1 >= tba.SRC_DIAG_START


def test_score_only_and_make_qoff():
    Q, qlen, Tc, tlo, thi, qoff, _ = _problem(11, 64)
    ref = jba.banded_align(
        *(jnp.asarray(a) for a in (Q, qlen, Tc, tlo, thi, qoff)), None,
        with_traceback=False, band_width=64,
    )
    got = tba.banded_align_plain(*_torch(Q, qlen, Tc, tlo, thi, qoff), band_width=64)
    assert got.arrows is None
    np.testing.assert_array_equal(np.asarray(ref.score), got.score.numpy())
    for L, T, W, diag in ((96, 140, 32, 22), (500, 756, 128, 128), (40, 296, 64, 128)):
        np.testing.assert_array_equal(jba.make_qoff(L, T, W, diag), tba.make_qoff(L, T, W, diag).numpy())


def test_unported_modes_raise():
    Q, qlen, Tc, tlo, thi, qoff, _ = _problem(1, 32)
    args = _torch(Q, qlen, Tc, tlo, thi, qoff)
    with pytest.raises(ValueError, match="qual"):
        dp_wrapper(*args, torch.from_numpy(Q).int(), band_width=32)    # no quality mode
    # guided schedules are ported: per-item rows that repeat the shared
    # schedule give the shared result bit for bit, as in the JAX package
    shared = tba.banded_align_plain(*args, with_traceback=True, band_width=32)
    per_item = tba.banded_align_plain(*args[:5], args[5][:, None].repeat(1, 8),
                                      with_traceback=True, band_width=32)
    for a, b in zip(shared[:3], per_item[:3]):
        assert torch.equal(a, b)
    assert torch.equal(shared.arrows.view(torch.int16), per_item.arrows.view(torch.int16))
    with pytest.raises(ValueError, match="exactly one"):                # qoff and knots
        dp_wrapper(*args, knots=torch.zeros((8, 4), dtype=torch.int32), band_width=32)
    with pytest.raises(ValueError, match="shared"):                     # (S, I) via the wrapper
        dp_wrapper(*args[:5], args[5][:, None].repeat(1, 8), band_width=32)
    # global-in-query scoring is ported to the plain DP (score only)
    ref = jba.banded_align(*(jnp.asarray(a) for a in (Q, qlen, Tc, tlo, thi, qoff)), None,
                           band_width=32, global_q=True)
    got = tba.banded_align_plain(*args, band_width=32, global_q=True)
    for a, b in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
