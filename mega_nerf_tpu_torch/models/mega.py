"""Mega-NeRF spatial mixture: blend K submodules by routing weights.

Counterpart of the JAX package's `models/mega.py` (`cluster_weights`, the
dense `mega_apply`). Every submodule evaluates every point and the outputs
are blended with per-point weights that are zero outside each cell's
boundary margin; with a hard assignment (margin 1) the blend is a one-hot
select.

The JAX function stacks the K outputs and contracts them with one einsum
(`nk,knc->nc`). Here the submodules run one after another and each output
is added into one accumulator as `w[:, k:k+1] * out_k`, so memory does not
grow with K. The sum runs in submodule order instead of the einsum's, which
moves a blended value by a few f32 ulps (the CPU tests hold it to the JAX
function at 5e-5); a one-hot blend is exact in both.

The routed forms (`mega_apply_routed`, `mega_apply_ray_routed`,
`ray_route_plan`) are not ported: `models/factory.py` raises for them.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def cluster_weights(
    points: torch.Tensor,
    centroids: torch.Tensor,
    boundary_margin: float,
    cluster_dim_start: int = 0,
) -> torch.Tensor:
    """Routing weights of each point over K submodule centroids.

    points: (N, 3) routing positions (real-world coordinates, for
    background points too); centroids: (K, 3). `cluster_dim_start` = 1
    drops the altitude dimension (cluster_2d). Returns (N, K) weights
    summing to 1 per point: margin 1 -> the one-hot of the nearest
    centroid; margin > 1 -> inverse-distance weights over the centroids
    within margin x the nearest distance."""
    p = points[..., cluster_dim_start:3]
    c = centroids[:, cluster_dim_start:].to(points)
    dists = torch.linalg.norm(p[..., None, :] - c[None], dim=-1)  # (N, K)

    if boundary_margin == 1:
        nearest = torch.argmin(dists, dim=-1)
        return torch.nn.functional.one_hot(nearest, centroids.shape[0]).to(points.dtype)

    inv = 1.0 / (dists + 1e-8)
    min_d = torch.amin(dists, dim=-1, keepdim=True)
    inv = torch.where(dists > boundary_margin * min_d, torch.zeros_like(inv), inv)
    return inv / torch.sum(inv, dim=-1, keepdim=True)


def mega_apply(apply_fn: Callable[[int], torch.Tensor], weights: torch.Tensor,
               active: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Dense blend: sum over k of weights[:, k:k+1] * apply_fn(k).

    apply_fn(k) evaluates submodule k on all N points -> (N, C) float32;
    weights: (N, K) from `cluster_weights` over all K centroids. One
    submodule's output is live at a time.

    `active` (ascending submodule indices, from `render/cell_cull.py`)
    runs only those submodules: the port's counterpart of the JAX
    package's slice of the stacked params and centroids to a chunk's
    active cells. The culling proof (`cell_cull.py`) shows every skipped
    column of `weights` is zero wherever the chunk's points can lie, so
    skipping it drops only `0 * out_k` terms: the culled blend equals the
    full one bit for bit where the submodules' outputs are finite (x + 0
    is x, and the kept terms add in the same order)."""
    out = None
    for k in range(weights.shape[1]) if active is None else active:
        term = weights[:, k:k + 1] * apply_fn(k).float()
        out = term if out is None else out + term
    return out
