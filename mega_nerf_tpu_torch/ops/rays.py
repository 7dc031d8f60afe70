"""Ray generation in the DRB (down-right-back) world convention.

Port of the JAX package's `ops/rays.py` (with `get_rays_flat`, the chunk
loader's) and `generate_image_rays` (`data/memory_dataset.py`). A "ray record" is 8 floats: [origin(3), unit
direction(3), near, far]. The altitude-plane truncation is a dense `where`
over all rays.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def get_ray_directions(
    w: int,
    h: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    center_pixels: bool,
    device=None,
    dtype=torch.float32,
) -> torch.Tensor:
    """(H, W, 3) per-pixel unit ray directions in the camera frame
    (camera looks along -z, +x right, +y up)."""
    i = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    j = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    if center_pixels:
        i = i + 0.5
        j = j + 0.5
    directions = torch.stack(
        [(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], dim=-1
    )
    return directions / torch.linalg.norm(directions, dim=-1, keepdim=True)


def _plane_bound(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    altitude: float,
    default: torch.Tensor,
) -> torch.Tensor:
    """Distance along each ray to the plane x == altitude, for rays that
    start above it (o_x < altitude) and descend (d_x > 0); `default` else."""
    o_x = rays_o[..., 0]
    d_x = rays_d[..., 0]
    eligible = (o_x < altitude) & (d_x > 0)
    safe_dx = torch.where(d_x == 0, torch.ones_like(d_x), d_x)
    t = (altitude - o_x) / safe_dx
    return torch.where(eligible, t, default)


def _records(rays_o: torch.Tensor, rays_d: torch.Tensor, near: float,
             far: float, ray_altitude_range: Optional[Sequence[float]]
             ) -> torch.Tensor:
    """(..., 8) records from origins and unit directions. With
    `ray_altitude_range` = [alt_hi, alt_lo] near is pushed forward to the
    ceiling plane and far pulled back to the ground plane."""
    near_b = torch.full(rays_o.shape[:-1], near, dtype=rays_o.dtype,
                        device=rays_o.device)
    far_b = torch.full(rays_o.shape[:-1], far, dtype=rays_o.dtype,
                       device=rays_o.device)

    if ray_altitude_range is not None:
        near_b = _plane_bound(rays_o, rays_d, ray_altitude_range[0], near_b)
        near_b = torch.clamp(near_b, min=near)
        far_b = _plane_bound(rays_o, rays_d, ray_altitude_range[1], far_b)
        far_b = torch.clamp(far_b, max=far)
        far_b = torch.maximum(near_b, far_b)

    return torch.cat([rays_o, rays_d, near_b[..., None], far_b[..., None]], -1)


def get_rays(
    directions: torch.Tensor,
    c2w: torch.Tensor,
    near: float,
    far: float,
    ray_altitude_range: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """(..., 8) world-space ray records for one camera.

    directions: (..., 3) camera-frame unit directions; c2w: (3, 4) DRB pose."""
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[:, 3].expand(rays_d.shape)
    return _records(rays_o, rays_d, near, far, ray_altitude_range)


def get_rays_flat(
    directions: torch.Tensor,
    c2ws: torch.Tensor,
    near: float,
    far: float,
    ray_altitude_range: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """(N, 8) ray records for a flat list of (direction, pose) pairs.

    directions: (N, 3) camera-frame unit directions; c2ws: (N, 3, 4) poses,
    one per ray. The chunk loader regenerates a chunk's rays from its
    stored pixel indices with one batched product."""
    rays_d = torch.einsum("nij,nj->ni", c2ws[:, :, :3], directions)
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return _records(c2ws[:, :, 3], rays_d, near, far, ray_altitude_range)


def generate_image_rays(
    metadata,
    near: float,
    far: float,
    ray_altitude_range: Optional[Sequence[float]],
    center_pixels: bool,
    device=None,
) -> torch.Tensor:
    """All rays of one image -> (H*W, 8) float32 on `device`."""
    fx, fy, cx, cy = (float(v) for v in metadata.intrinsics)
    directions = get_ray_directions(
        metadata.W, metadata.H, fx, fy, cx, cy, center_pixels, device=device
    )
    c2w = torch.as_tensor(np.asarray(metadata.c2w, np.float32), device=device)
    rays = get_rays(directions, c2w, near, far, ray_altitude_range)
    return rays.reshape(-1, 8)
