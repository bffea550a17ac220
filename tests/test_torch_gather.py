"""The port's span and row gathers against the JAX mapper's XLA formulation
(``pipeline/mapper.py``: per-element clipped span fetch, row take), with
out-of-range starts and rows; tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blasr_tpu_torch.ops.gather import (
    gather_rows,
    gather_rows_plain,
    gather_spans,
    gather_spans_plain,
)

# The suite runs in parallel worker processes: one intra-op thread each
# keeps PyTorch's CPU thread pools from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("span", [1, 7, 162])
def test_gather_spans_matches_xla_clip(span):
    rng = np.random.default_rng(span)
    N = 1024
    src = rng.integers(-2**31, 2**31 - 1, N).astype(np.int32)
    starts = rng.integers(0, N - span, 64).astype(np.int32)
    starts[:5] = [-span - 3, -1, N - span // 2 - 1, N - 1, N + 9]
    ref = np.asarray(
        jnp.asarray(src)[
            jnp.clip(
                jnp.asarray(starts)[:, None] + jnp.arange(span, dtype=jnp.int32)[None, :],
                0, N - 1,
            )
        ]
    )
    got = gather_spans(torch.from_numpy(src), torch.from_numpy(starts), span)
    assert got.dtype == torch.int32 and tuple(got.shape) == (64, span)
    np.testing.assert_array_equal(ref, got.numpy())
    np.testing.assert_array_equal(ref, gather_spans_plain(torch.from_numpy(src), torch.from_numpy(starts), span).numpy())


@pytest.mark.parametrize("R,Lr", [(16, 256), (512, 3), (1, 40)])
def test_gather_rows_matches_xla_take(R, Lr):
    rng = np.random.default_rng(R + Lr)
    src = rng.integers(-2**31, 2**31 - 1, (R, Lr)).astype(np.int32)
    rows = rng.integers(0, R, 50).astype(np.int32)
    rows[:3] = [-4, R, R + 100]
    ref = np.asarray(jnp.asarray(src)[jnp.clip(jnp.asarray(rows), 0, R - 1)])
    got = gather_rows(torch.from_numpy(src), torch.from_numpy(rows))
    np.testing.assert_array_equal(ref, got.numpy())
    np.testing.assert_array_equal(ref, gather_rows_plain(torch.from_numpy(src), torch.from_numpy(rows)).numpy())
    # in-range rows: exactly the JAX mapper's x[row]
    ok = rows[3:]
    np.testing.assert_array_equal(np.asarray(jnp.asarray(src)[jnp.asarray(ok)]), gather_rows(torch.from_numpy(src), torch.from_numpy(ok)).numpy())


def test_cpu_tensors_take_the_plain_path_without_counting():
    from blasr_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    src = torch.arange(256, dtype=torch.int32)
    gather_spans(src, torch.tensor([0, 5], dtype=torch.int32), 4)
    gather_rows(src.reshape(16, 16), torch.tensor([1], dtype=torch.int32))
    assert launch_counts() == {"banded_dp": 0, "gather_spans": 0, "gather_rows": 0,
                               "traceback_walk": 0, "mapqv": 0}


@pytest.mark.parametrize(
    "src_ptr,out_ptr,row_words,width",
    [
        (0x7F0000000000, 0x7F0000100000, 416, 4),  # both 16-byte aligned
        (0x7F0000000000, 0x7F0000100000, 256, 4),  # rows of a multiple of 4 words
        (0x7F0000000000, 0x7F0000100000, 162, 1),  # rows of 162 words: not every row aligned
        (0x7F0000000004, 0x7F0000100000, 256, 1),  # source 4 bytes off (a word-offset view)
        (0x7F0000000000, 0x7F0000100008, 128, 1),  # output 8 bytes off
        (0x7F0000000010, 0x7F0000100020, 4, 4),
        (0x7F000000000C, 0x7F0000100000, 5, 1),
    ],
)
def test_vector_width(src_ptr, out_ptr, row_words, width):
    from blasr_tpu_torch.ops.gather import vector_width

    assert vector_width(src_ptr, out_ptr, row_words) == width


def test_vector_width_of_views():
    """A row-offset view of an (R, 5) source starts 20 bytes in; a word
    offset view of an (R, 4) one 4 bytes in: both take the scalar
    instance. The plain versions gather from either view as from a copy."""
    from blasr_tpu_torch.ops.gather import vector_width

    big = torch.arange(11 * 5, dtype=torch.int32).reshape(11, 5)
    view = big[1:]
    assert view.is_contiguous() and view.data_ptr() - big.data_ptr() == 20
    base = big.data_ptr()
    assert vector_width(base, base, 4) == (4 if base % 16 == 0 else 1)
    assert vector_width(base + 20, base, 5) == 1
    assert vector_width(base + 4, base, 4) == 1
    rows = torch.tensor([-2, 0, 3, 9, 40], dtype=torch.int32)
    assert torch.equal(gather_rows(view, rows), gather_rows(view.clone(), rows))
    flat = torch.arange(1, 1 + 10 * 4 + 1, dtype=torch.int32)[1:]
    starts = torch.tensor([-5, 0, 1, 2, 3, 37, 60], dtype=torch.int32)
    assert torch.equal(gather_spans(flat, starts, 5), gather_spans(flat.clone(), starts, 5))
