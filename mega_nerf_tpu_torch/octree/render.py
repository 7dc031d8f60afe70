"""Render images directly from a baked N3Tree octree.

Port of the JAX package's `octree/render.py`: a fixed-step ray march
through the tree, a per-point leaf lookup on the host (numpy: octree
traversal is pointer-chasing), then the port's alpha compositing
(`ops/compositing.composite_weights`) and, for view-dependent formats,
`ops/sh.eval_sh` in torch. A validation/preview path for a bake: the
reference only ever shows its octrees in the external viewer.

Data layout per leaf: `[rgb(3) | sigma]` for RGBA trees (rgb already
sigmoid-activated: the bake writes model outputs through unchanged), or
`[SH coeffs (3*(deg+1)^2) | sigma]` for SH{n} trees, colours
sigmoid(eval_sh) as in PlenOctree.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mega_nerf_tpu_torch.octree.n3tree import N3Tree
from mega_nerf_tpu_torch.ops.compositing import composite_weights
from mega_nerf_tpu_torch.ops.sh import eval_sh


def query_tree(tree: N3Tree, world_pts: np.ndarray) -> np.ndarray:
    """(P, 3) world points -> (P, data_dim) leaf payloads (clamped lookup)."""
    t = tree.world_to_tree(world_pts.astype(np.float32))
    node, cell = tree._locate(t)
    return tree.data[node, cell[:, 0], cell[:, 1], cell[:, 2]]


def render_octree_rays(
    tree: N3Tree,
    rays: np.ndarray,  # (N, 8) [o, d, near, far]
    steps: int = 256,
    sh_deg: Optional[int] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Fixed-step march + composite -> {'rgb': (N, 3), 'depth': (N,),
    'opacity': (N,)} (numpy). The compositing runs on `device` (default
    the CPU).

    `sh_deg` defaults from the tree's data_format (SH{n} -> deg, RGBA -> no
    view dependence)."""
    if sh_deg is None and tree.data_format.startswith("SH"):
        basis = int(tree.data_format[2:])
        sh_deg = int(np.sqrt(basis)) - 1

    rays = np.asarray(rays, np.float32)
    o, d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6], rays[:, 7]
    n = rays.shape[0]
    frac = np.linspace(0.0, 1.0, steps, dtype=np.float32)
    z = near[:, None] + (far - near)[:, None] * frac[None, :]  # (N, S)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)

    vals = query_tree(tree, pts).reshape(n, steps, -1)
    # Samples outside the tree's box would clamp to boundary leaves
    # (query_tree clips tree coords) and smear edge density along exiting
    # rays: they count as empty space instead.
    tc = tree.world_to_tree(pts.astype(np.float32)).reshape(n, steps, 3)
    inside = ((tc >= 0.0) & (tc < 1.0)).all(axis=-1)
    sigma = np.where(inside, np.maximum(vals[..., -1], 0.0), 0.0)

    as_t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),  # noqa: E731
                                     device=device)
    if sh_deg is not None and sh_deg >= 0 and tree.data_format != "RGBA":
        basis = (sh_deg + 1) ** 2
        coeffs = as_t(vals[..., : 3 * basis].reshape(n, steps, 3, basis))
        dirs = as_t(np.broadcast_to(d[:, None, :], (n, steps, 3)))
        rgb = torch.sigmoid(eval_sh(sh_deg, coeffs, dirs))
    else:
        rgb = as_t(vals[..., :3])

    z_t = as_t(z)
    cw = composite_weights(as_t(sigma), z_t, torch.full((n,), 1e10, device=z_t.device))
    rgb_out = torch.sum(cw.weights[..., None] * rgb, dim=1)
    depth = torch.sum(cw.weights * z_t, dim=1)
    return {
        "rgb": rgb_out.cpu().numpy(),
        "depth": depth.cpu().numpy(),
        "opacity": 1.0 - cw.bg_lambda.cpu().numpy(),
    }
