"""Depth-sample generation: stratified perturbation + hierarchical inverse-CDF.

Port of the JAX package's `ops/sampling.py`. The JAX version brackets each
uniform with masked reductions (a TPU form); on the GPU `torch.searchsorted`
does the same lookup, followed by the same index clamps. Parity is on
outputs. Eval is deterministic (u = linspace); the sorted-uniform random
mode belongs to training.
"""

from __future__ import annotations

from typing import Optional

import torch


def expand_and_perturb_z_vals(
    z_vals: torch.Tensor,
    perturb: float,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Stratified jitter of per-ray depth samples (N, S): each sample is
    redrawn uniformly in the interval between its neighboring midpoints,
    scaled by `perturb`. Identity when perturb <= 0 or no generator."""
    if perturb <= 0 or generator is None:
        return z_vals
    mids = 0.5 * (z_vals[..., :-1] + z_vals[..., 1:])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    u = perturb * torch.rand(z_vals.shape, generator=generator,
                             device=z_vals.device, dtype=z_vals.dtype)
    return lower + (upper - lower) * u


def sample_cdf(
    bins: torch.Tensor,
    cdf: torch.Tensor,
    fine_samples: int,
) -> torch.Tensor:
    """Deterministic inverse-transform sampling of `fine_samples` depths.

    bins: (N, S+1) bin edges; cdf: (N, S) cumulative weights in (0, 1].
    u is an even linspace over [0, 1]; the returned depths ascend."""
    n_rays = cdf.shape[0]
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1).contiguous()
    u = torch.linspace(0.0, 1.0, fine_samples, dtype=cdf.dtype,
                       device=cdf.device)
    u = u.expand(n_rays, fine_samples).contiguous()

    idx = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(idx - 1, min=0)
    above = torch.clamp(idx, max=cdf.shape[-1] - 1)
    cdf_lo = torch.gather(cdf, 1, below)
    cdf_hi = torch.gather(cdf, 1, above)
    bins_lo = torch.gather(bins, 1, below)
    bins_hi = torch.gather(bins, 1, above)

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-8, torch.ones_like(denom), denom)
    return bins_lo + (u - cdf_lo) / denom * (bins_hi - bins_lo)


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    fine_samples: int,
) -> torch.Tensor:
    """Hierarchical resampling: draw fine depths proportional to the
    (detached) coarse weights. bins: (N, S+1); weights: (N, S)."""
    weights = weights + 1e-8
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    return sample_cdf(bins, cdf, fine_samples)
