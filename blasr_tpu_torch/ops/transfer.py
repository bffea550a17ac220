"""The copies between host and device on the mapping path.

``to_device`` copies a host array from pageable memory (a batch's reads,
a constant table): PyTorch's copy then waits for the device's stream
before it returns, so the next batch's inputs wait for the previous
batch's work. ``to_host`` fetches a batch's result, which waits for
everything the batch queued. Each counts its calls in ``syncs``, as the
other places where the host waits for the device do (``ops.counters()``);
with a tracer on, the bytes each way go into its counters.
"""
from __future__ import annotations

import numpy as np
import torch

from blasr_tpu_torch.ops import COUNT_LOCK, sync_site


@sync_site("to_device")
def to_device(a: np.ndarray, device, clock=None) -> torch.Tensor:
    """``a`` as a tensor on ``device``."""
    a = np.ascontiguousarray(a)
    with COUNT_LOCK:
        to_device.syncs += 1
    if clock is not None:
        clock.count("h2d_bytes", a.nbytes)
    return torch.from_numpy(a).to(device)


@sync_site("to_host")
def to_host(t: torch.Tensor, clock=None) -> np.ndarray:
    """``t`` as a host array."""
    with COUNT_LOCK:
        to_host.syncs += 1
    if clock is not None:
        clock.count("d2h_bytes", t.numel() * t.element_size())
    return t.cpu().numpy()
