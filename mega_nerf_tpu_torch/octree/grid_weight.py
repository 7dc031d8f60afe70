"""Per-voxel maximum camera-weight rendering for octree culling.

Port of the JAX package's `octree/grid_weight.py` (the replacement for
svox's CUDA `_C.grid_weight_render`): for each training camera, march a ray
through every pixel across a dense sigma grid, compute each sample's
compositing weight (alpha * transmittance), and scatter-MAX those weights
into the voxels the samples fall in. The per-voxel value, maxed over all
cameras, measures how visible a voxel ever is; the bake culls voxels below
`weight_thresh`.

Plain torch on the grid's device, pixels in chunks of `pixel_chunk` rays:
cube entry/exit clipping, a fixed-step march of `2 * reso` steps, a
nearest-voxel gather of sigma, cumulative-product transmittance, and a
`scatter_reduce_(..., "amax")` into the voxels. The JAX function is jnp,
not a Pallas kernel, so it has no hand-written counterpart. A chunk of
65,536 rays at reso 512 holds ~3 GB of (P, S) temporaries on the card.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mega_nerf_tpu_torch.ops.rays import get_ray_directions


def _ray_cube_span(o: torch.Tensor, d: torch.Tensor):
    """Entry/exit distances of rays (tree coords) with the unit cube."""
    safe_d = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    t0 = (0.0 - o) / safe_d
    t1 = (1.0 - o) / safe_d
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_near = torch.clamp(t_near, min=0.0)
    return t_near, torch.maximum(t_far, t_near)


def _weights_one_camera(
    grid: torch.Tensor,  # (reso, reso, reso) sigma
    rays_o: torch.Tensor,  # (P, 3) tree coords
    rays_d: torch.Tensor,  # (P, 3) tree coords, d_world * invradius unnormalized
    reso: int,
    n_steps: int,
) -> torch.Tensor:
    """(reso^3,) max sample weight per voxel over these rays."""
    t_near, t_far = _ray_cube_span(rays_o, rays_d)
    frac = (torch.arange(n_steps, device=grid.device, dtype=torch.float32) + 0.5) / n_steps
    ts = t_near[:, None] + (t_far - t_near)[:, None] * frac
    # `t` parameterizes both the tree-space and the world-space ray (the
    # tree map is affine and rays_d is the mapped, unnormalized, unit world
    # direction), so a step dt is dt world units; no svox delta_scale.
    delta_world = (t_far - t_near) / n_steps  # (P,)

    pts = rays_o[:, None, :] + rays_d[:, None, :] * ts[..., None]  # (P, S, 3)
    idx = torch.clamp((pts * reso).to(torch.int32), 0, reso - 1).long()
    flat_idx = (idx[..., 0] * reso + idx[..., 1]) * reso + idx[..., 2]  # (P, S)
    sigma = grid.reshape(-1)[flat_idx]

    valid = (t_far > t_near)[:, None]
    alpha = torch.where(valid, 1.0 - torch.exp(-sigma * delta_world[:, None]),
                        torch.zeros_like(sigma))
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    weights = alpha * trans  # (P, S)

    out = torch.zeros(reso ** 3, dtype=weights.dtype, device=grid.device)
    return out.scatter_reduce_(0, flat_idx.reshape(-1), weights.reshape(-1), "amax")


def grid_weight_render_max(
    sigmas,  # (reso^3,) or (reso, reso, reso), numpy or a tensor
    poses: np.ndarray,  # (M, 3, 4) c2w in world coords
    camera_params: Sequence[float],  # [W, H, fx, fy, cx, cy]
    tree_offset: np.ndarray,  # (3,)
    tree_invradius: np.ndarray,  # (3,)
    reso: int,
    n_steps: int | None = None,
    pixel_chunk: int = 65536,
    device=None,
) -> np.ndarray:
    """Max-over-cameras per-voxel weight grid (reso, reso, reso), computed
    on `device` (default: the device of a tensor `sigmas`, else the CPU)."""
    w, h, fx, fy, cx, cy = [float(x) for x in camera_params]
    w, h = int(w), int(h)
    if n_steps is None:
        n_steps = 2 * reso
    if device is None:
        device = sigmas.device if isinstance(sigmas, torch.Tensor) else "cpu"

    grid = torch.as_tensor(sigmas, dtype=torch.float32, device=device).reshape(
        reso, reso, reso)
    offset = torch.as_tensor(np.asarray(tree_offset, np.float32), device=device)
    invradius = torch.as_tensor(np.asarray(tree_invradius, np.float32), device=device)
    # Directions on the host, as the JAX function makes them (numpy poses).
    directions = get_ray_directions(w, h, fx, fy, cx, cy, True).reshape(-1, 3).numpy()

    maximum = torch.zeros(reso ** 3, dtype=torch.float32, device=device)
    for pose in np.asarray(poses, np.float32):
        rays_d_world = directions @ pose[:, :3].T  # (P, 3)
        # Normalized in world space so the shared ray parameter t is world
        # arc length (see _weights_one_camera).
        rays_d_world = rays_d_world / np.linalg.norm(rays_d_world, axis=-1, keepdims=True)
        rays_o_world = np.broadcast_to(pose[:, 3], rays_d_world.shape)
        rays_o = torch.as_tensor(np.ascontiguousarray(rays_o_world), device=device) \
            * invradius + offset
        rays_d = torch.as_tensor(rays_d_world, device=device) * invradius
        for start in range(0, directions.shape[0], pixel_chunk):
            sl = slice(start, start + pixel_chunk)
            maximum = torch.maximum(
                maximum, _weights_one_camera(grid, rays_o[sl], rays_d[sl], reso, n_steps))
    return maximum.reshape(reso, reso, reso).cpu().numpy()
