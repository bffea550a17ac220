from blasr_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicate_index,
    sharded_map_batch,
)
