"""The DP's arrows as a share of peak device memory: the largest (S, I, W)
uint16 arrow tensor a DP call made (``banded_align.max_arrow_bytes``, over
the process) over ``torch.cuda.max_memory_allocated()`` since the reset
before the window (the window and the traced parts; the window's top
bucket sets both). None without a card or where the program keeps no
such count."""


def read(rec):
    import torch

    from blasr_tpu_torch.ops.banded_cuda import banded_align

    arrows = getattr(banded_align, "max_arrow_bytes", 0)
    if not arrows or not torch.cuda.is_available():
        return None
    peak = torch.cuda.max_memory_allocated()
    return 100.0 * arrows / peak if peak > 0 else None
