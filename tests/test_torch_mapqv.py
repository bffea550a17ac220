"""MAPQ's wrapper on the CPU: ``map_qv_reference`` on CPU tensors is the
plain version and launches nothing, the kernel wrapper ``mapqv`` is counted
with the others, its input checks raise before any build, and the rows of
``tests/mapq_cases.py`` take the branches they name. The kernel itself is
held to the plain version on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from blasr_tpu_torch import ops
from blasr_tpu_torch.ops import mapqv, xla_math
from mapq_cases import branch_cases, random_case

torch.set_num_threads(1)


def _torch(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("CD", [1, 10, 24])
def test_cpu_tensors_run_the_plain_version_without_a_launch(CD):
    args = _torch(random_case(CD, 40 + CD))
    ops.reset_launch_counts()
    got = mapqv.map_qv_reference(*args, mismatch_prob=15, ins_cost=5, del_cost=5)
    want = torch.clamp(mapqv.map_qv_float(*args), 0, mapqv.MAX_PHRED).to(torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert ops.launch_counts()["mapqv"] == 0


def test_mapqv_is_a_counted_kernel_wrapper():
    assert ops.kernel_wrappers()["mapqv"] is mapqv.map_qv_reference
    mapqv.map_qv_reference.launches = 5
    assert ops.launch_counts()["mapqv"] == 5
    ops.reset_launch_counts()
    assert ops.launch_counts()["mapqv"] == 0


def test_branch_rows_take_their_branches():
    """Each row of ``BRANCH_ROWS`` gives the plain version the mapping
    qualities it names; the subnormal row's exp and 10^sub would be
    subnormal without the flush."""
    args, wanted, _ = branch_cases()
    got = mapqv.map_qv_reference(*_torch(args)).numpy()
    fixed = wanted >= 0
    np.testing.assert_array_equal(got[fixed], wanted[fixed])
    assert ((got[~fixed] > 0) & (got[~fixed] < mapqv.MAX_PHRED)).all()
    x = np.float32(-38.0) * np.float32(mapqv.LOG10)
    assert 0 < np.exp(np.float64(x)) < 2.0**-126 and 0 < 10.0**-38 < 2.0**-126
    assert xla_math.xla_exp(torch.tensor([x])).item() == 0.0
    assert xla_math.pow10(torch.tensor([-38.0])).item() == 0.0


@pytest.mark.parametrize("fault", ["valid_dtype", "lo_int64", "hi_strided", "nm_shape",
                                   "scores_1d"])
def test_kernel_wrapper_checks_inputs_before_any_build(fault):
    """``map_qv_kernel`` refuses what the kernel does not take before it
    loads the CUDA library (none is built here)."""
    args = _torch(random_case(4, 7, B=8))
    if fault == "valid_dtype":
        args[1] = args[1].to(torch.uint8)
    elif fault == "lo_int64":
        args[2] = args[2].long()
    elif fault == "hi_strided":
        args[3] = torch.cat([args[3], args[3]], dim=1)[:, ::2]
    elif fault == "nm_shape":
        args[4] = args[4][:, :3]
    else:
        args[0] = args[0].reshape(-1)
    with pytest.raises(ValueError):
        mapqv.map_qv_kernel(*args)
