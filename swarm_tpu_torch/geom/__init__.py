from swarm_tpu_torch.geom.world import (  # noqa: F401
    BEDROOM_WALLS,
    cast_rays,
    cast_rays_grouped,
    make_rect_room,
    ray_segment_t,
)
