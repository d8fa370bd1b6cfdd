from pixelnerf_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    RAYS_AXIS,
    Mesh,
    backend_for,
    init_distributed,
    make_mesh,
    parse_mesh_spec,
    shard_batch,
    world_size,
    wrap_pad,
)
