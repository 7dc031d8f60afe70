"""Pure tensor ops: ray generation, sampling, compositing, metrics, SH."""

from mega_nerf_tpu_torch.ops.compositing import (
    CompositeWeights,
    composite_weights,
    composite_weights_merge,
)
from mega_nerf_tpu_torch.ops.geometry import depth2pts_outside, intersect_sphere
from mega_nerf_tpu_torch.ops.metrics import psnr, ssim
from mega_nerf_tpu_torch.ops.rays import (
    generate_image_rays,
    get_ray_directions,
    get_rays,
    get_rays_flat,
)
from mega_nerf_tpu_torch.ops.sampling import (
    expand_and_perturb_z_vals,
    sample_cdf,
    sample_pdf,
)
from mega_nerf_tpu_torch.ops.sh import eval_sh

__all__ = [
    "CompositeWeights",
    "composite_weights",
    "composite_weights_merge",
    "depth2pts_outside",
    "intersect_sphere",
    "psnr",
    "ssim",
    "generate_image_rays",
    "get_ray_directions",
    "get_rays",
    "get_rays_flat",
    "expand_and_perturb_z_vals",
    "sample_cdf",
    "sample_pdf",
    "eval_sh",
]
