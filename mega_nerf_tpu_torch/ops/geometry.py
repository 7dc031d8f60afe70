"""NeRF++-style inverted-sphere geometry for unbounded backgrounds.

Port of the JAX package's `ops/geometry.py`. The foreground lives inside an
axis-aligned ellipsoid (a unit sphere after per-axis normalization by
`sphere_radius`); everything outside is parameterized by inverse distance in
[0, 1] on the unit sphere via a Rodrigues rotation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _normalize_rays(rays_o, rays_d, sphere_center, sphere_radius):
    if sphere_radius is not None:
        rays_o = (rays_o - sphere_center) / sphere_radius
        rays_d = rays_d / sphere_radius
    return rays_o, rays_d


def intersect_sphere(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    sphere_center: Optional[torch.Tensor] = None,
    sphere_radius: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Depth (in original ray units) at which each ray exits the unit
    sphere. rays_o/rays_d: (..., 3). The sqrt is clamped, not checked."""
    rays_o, rays_d = _normalize_rays(rays_o, rays_d, sphere_center, sphere_radius)
    d1 = -torch.sum(rays_d * rays_o, -1) / torch.sum(rays_d * rays_d, -1)
    p = rays_o + d1[..., None] * rays_d
    ray_d_cos = 1.0 / torch.linalg.norm(rays_d, dim=-1)
    p_norm_sq = torch.sum(p * p, -1)
    d2 = torch.sqrt(torch.clamp(1.0 - p_norm_sq, min=0.0)) * ray_d_cos
    return d1 + d2


def depth2pts_outside(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    depth: torch.Tensor,
    sphere_center: Optional[torch.Tensor] = None,
    sphere_radius: Optional[torch.Tensor] = None,
    include_xyz_real: bool = False,
    cluster_2d: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse-depth samples in [0, 1] -> 4D background coordinates.

    rays_o/rays_d: (N, 1, 3); depth: (N, S) inverse distance to the sphere
    origin (0 = infinity, 1 = sphere surface). Returns (pts, depth_real
    (N, S) metric depth): pts is (N, S, 4) [unit-sphere point, inverse
    depth], or with `include_xyz_real` (N, S, 7) with real-world routing
    coordinates first for a mixture background: the real sample point
    with `cluster_2d`, else the ray's exit point from the sphere."""
    rays_o_orig, rays_d_orig = rays_o, rays_d
    rays_o, rays_d = _normalize_rays(rays_o, rays_d, sphere_center, sphere_radius)

    d1 = -torch.sum(rays_d * rays_o, -1) / torch.sum(rays_d * rays_d, -1)
    p_mid = rays_o + d1[..., None] * rays_d
    p_mid_norm = torch.linalg.norm(p_mid, dim=-1)
    ray_d_cos = 1.0 / torch.linalg.norm(rays_d, dim=-1)
    d2 = torch.sqrt(torch.clamp(1.0 - p_mid_norm * p_mid_norm, min=0.0)) * ray_d_cos
    p_sphere = rays_o + (d1 + d2)[..., None] * rays_d  # (N, 1, 3)

    rot_axis = torch.linalg.cross(rays_o, p_sphere)
    rot_axis = rot_axis / (torch.linalg.norm(rot_axis, dim=-1, keepdim=True) + 1e-8)
    phi = torch.asin(torch.clamp(p_mid_norm, -1.0, 1.0))  # (N, 1)
    theta = torch.asin(torch.clamp(p_mid_norm * depth, -1.0, 1.0))  # (N, S)
    rot_angle = (phi - theta)[..., None]  # (N, S, 1)

    p_sphere_new = (
        p_sphere * torch.cos(rot_angle)
        + torch.linalg.cross(rot_axis, p_sphere) * torch.sin(rot_angle)
        + rot_axis
        * torch.sum(rot_axis * p_sphere, -1, keepdim=True)
        * (1.0 - torch.cos(rot_angle))
    )
    p_sphere_new = p_sphere_new / torch.linalg.norm(
        p_sphere_new, dim=-1, keepdim=True
    )

    depth_real = 1.0 / (depth + 1e-8) * torch.cos(theta) + d1  # (N, S)
    pts = torch.cat([p_sphere_new, depth[..., None]], dim=-1)
    if include_xyz_real:
        if cluster_2d:
            real = rays_o_orig + rays_d_orig * depth_real[..., None]
        else:
            boundary = rays_o_orig + rays_d_orig * (d1 + d2)[..., None]
            real = boundary.expand(*p_sphere_new.shape[:-1], 3)
        pts = torch.cat([real, pts], dim=-1)
    return pts, depth_real
