"""Image-quality metrics: PSNR, SSIM and LPIPS.

Port of the JAX package's `ops/metrics.py`. SSIM reproduces the reference's
tf.image.ssim-style separable Gaussian blur with zero padding. The blur
runs as a grouped `conv2d` with cuDNN's TF32 mode off, so a CUDA run keeps
float32 precision. LPIPS scores every net whose weight file exists
(`ops/lpips.py`); with none it returns {}.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from mega_nerf_tpu_torch.ops.lpips import LPIPS, load_available


def psnr(rgbs: torch.Tensor, target_rgbs: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB."""
    mse = torch.mean((rgbs - target_rgbs) ** 2)
    return -10.0 * torch.log10(mse)


def _gaussian_blur(img: torch.Tensor, filt: torch.Tensor, hw: int) -> torch.Tensor:
    """Separable blur of (B, C, H, W) per channel: along W, then along H."""
    c = img.shape[1]
    k = filt.shape[0]
    kern_w = filt.reshape(1, 1, 1, k).expand(c, 1, 1, k)
    kern_h = filt.reshape(1, 1, k, 1).expand(c, 1, k, 1)
    with torch.backends.cudnn.flags(allow_tf32=False):
        out = F.conv2d(img, kern_w, padding=(0, hw), groups=c)
        return F.conv2d(out, kern_h, padding=(hw, 0), groups=c)


def ssim(
    rgbs: torch.Tensor,
    target_rgbs: torch.Tensor,
    max_val: float,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM between two images of shape (..., H, W, C)."""
    h, w, c = rgbs.shape[-3:]
    img0 = rgbs.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    img1 = target_rgbs.reshape(-1, h, w, c).permute(0, 3, 1, 2)

    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((torch.arange(filter_size, dtype=img0.dtype, device=img0.device)
            - hw + shift) / filter_sigma) ** 2
    filt = torch.exp(-0.5 * f_i)
    filt = filt / torch.sum(filt)

    mu0 = _gaussian_blur(img0, filt, hw)
    mu1 = _gaussian_blur(img1, filt, hw)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = _gaussian_blur(img0 * img0, filt, hw) - mu00
    sigma11 = _gaussian_blur(img1 * img1, filt, hw) - mu11
    sigma01 = _gaussian_blur(img0 * img1, filt, hw) - mu01

    sigma00 = torch.clamp(sigma00, min=0.0)
    sigma11 = torch.clamp(sigma11, min=0.0)
    sigma01 = torch.sign(sigma01) * torch.minimum(
        torch.sqrt(sigma00 * sigma11), torch.abs(sigma01)
    )

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return torch.mean(ssim_map.reshape(ssim_map.shape[0], -1), dim=-1).mean()


def lpips(rgbs: torch.Tensor, target_rgbs: torch.Tensor,
          nets: Optional[Dict[str, LPIPS]] = None) -> Dict[str, float]:
    """LPIPS distance per backbone between two (H, W, 3) images in [0, 1],
    on their device. `nets` (from `ops.lpips.load_available`) are loaded
    here when not given; {} when no weight file exists."""
    if nets is None:
        nets = load_available(device=rgbs.device)
    return {net: float(fn(rgbs, target_rgbs)) for net, fn in nets.items()}
