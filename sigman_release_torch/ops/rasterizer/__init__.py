from sigman_release_torch.ops.rasterizer.preprocess import (  # noqa: F401
    build_cov3d,
    project_gaussians,
)
from sigman_release_torch.ops.rasterizer.render import (  # noqa: F401
    RasterizeConfig,
    rasterize,
    rasterize_single,
)
