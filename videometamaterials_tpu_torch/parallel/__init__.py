from videometamaterials_tpu_torch.parallel.mesh import (  # noqa: F401
    active,
    all_reduce_mean_,
    barrier,
    gather_rows,
    initialize_distributed,
    local_rows,
    pad_to_multiple,
    rank,
    rank0_first,
    world_size,
)
