from .sharding import (
    RAY_AXIS,
    data_parallel_renderer,
    data_parallel_splatter,
    make_mesh,
    pad_rays_to_devices,
    shard_rays,
)
