from swarm_tpu_torch.render.raster2d import (  # noqa: F401
    RenderTheme,
    encode_png,
    render_ascii,
    render_map,
    render_points,
    save_png,
)
