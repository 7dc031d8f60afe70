"""Mega-NeRF spatial mixture: blend K submodules by routing weights.

Counterpart of the JAX package's `models/mega.py`: `cluster_weights`, the
dense `mega_apply`, the routed forms and the ray-routing plan. In the dense
blend every submodule evaluates every point and the outputs
are blended with per-point weights that are zero outside each cell's
boundary margin; with a hard assignment (margin 1) the blend is a one-hot
select.

The JAX function stacks the K outputs and contracts them with one einsum
(`nk,knc->nc`). Here the submodules run one after another and each output
is added into one accumulator as `w[:, k:k+1] * out_k`, so memory does not
grow with K. The sum runs in submodule order instead of the einsum's, which
moves a blended value by a few f32 ulps (the CPU tests hold it to the JAX
function at 5e-5); a one-hot blend is exact in both.

The routed forms evaluate each submodule only where it can count:
- `mega_apply_routed` (per point): each point's top-M weights (M = 1 at
  margin 1), renormalised to sum to 1; submodule k runs on the points
  whose top-M holds it, and `w * out` is added back by point index. A
  point with more than M nonzero weights blends over its M nearest
  submodules, as the JAX function does (a truncation, by design);
- `mega_apply_ray_routed` (per ray): each cell runs on the whole rays
  whose support set holds it, weighted by its own column of the routing
  weights on their points.
The JAX package sorts and pads the points (or dispatches rays by one-hot
matmuls into fixed capacities) for the TPU's static shapes; here a gather,
an evaluation and an `index_add_` per submodule compute the same function,
and a submodule with nothing to evaluate does not run. The port has no
capacities to fill, so it needs no virtual experts (a cell split into
replicas over disjoint rays gives the same sums): `ray_route_plan` and
`ray_route_capacity` are numpy copies, bit-equal, kept because the
Runner's gate reads the plan's cost, so both packages decide alike.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
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


def mega_apply_routed(
    apply_rows: Callable[[int, torch.Tensor], torch.Tensor],
    weights: torch.Tensor,
    max_experts: int,
    out_dim: int,
    log: Optional[List[List[int]]] = None,
) -> torch.Tensor:
    """Per-point routed blend: each point evaluated only under its top-M
    submodules.

    apply_rows(k, rows) evaluates submodule k on the points `rows` (an
    ascending index tensor) -> (len(rows), C); weights: (N, K) from
    `cluster_weights`. Each point's `min(max_experts, K)` largest weights
    are renormalised to sum to 1 (a no-op where they hold every nonzero
    weight); submodule k runs once on the points whose kept weights hold
    it, in ascending k, and its weighted outputs are added into an (N, C)
    f32 accumulator by point index. Equals the dense blend wherever no
    point has more than M nonzero weights and the outputs are finite (the
    dropped terms are `0 * out`); at margin 1 (M = 1) every kept weight is
    exactly 1. The per-submodule counts are the pass's one host read; they
    are appended to `log` when given."""
    n, k = weights.shape
    m = min(int(max_experts), k)
    top_w, top_k = torch.topk(weights, m, dim=-1)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    bucket = torch.where(top_w > 0, top_k, k).reshape(-1)  # zero weight -> dead bucket K
    order = torch.argsort(bucket, stable=True)
    # (bincount would read the largest bucket to the host first.)
    counts = torch.zeros(k + 1, dtype=torch.long, device=bucket.device).index_add_(
        0, bucket, torch.ones_like(bucket)).tolist()[:k]
    point = torch.div(order, m, rounding_mode="floor")
    entry_w = top_w.reshape(-1)[order]
    out = weights.new_zeros((n, out_dim), dtype=torch.float32)
    start = 0
    for sub, count in enumerate(counts):
        if count == 0:
            continue
        rows = point[start:start + count]
        term = entry_w[start:start + count, None] * apply_rows(sub, rows).float()
        out.index_add_(0, rows, term)
        start += count
    if log is not None:
        log.append(counts)
    return out


def ray_route_experts(support, device=None) -> List[Tuple[int, torch.Tensor]]:
    """(cell, ray indices) of every column of a per-ray support mask that
    holds a ray, in column order.

    support: (R, K) bool (numpy, or a tensor, read to the host once)."""
    if isinstance(support, torch.Tensor):
        support = support.cpu().numpy()
    support = np.asarray(support, bool)
    held = [(cell, np.flatnonzero(support[:, cell])) for cell in range(support.shape[1])]
    held = [(cell, rays) for cell, rays in held if rays.size]
    if not held:
        return []
    # One copy to the device for all columns.
    flat = torch.from_numpy(np.concatenate([rays for _, rays in held])).to(device)
    parts = torch.split(flat, [rays.size for _, rays in held])
    return [(cell, part) for (cell, _), part in zip(held, parts)]


def mega_apply_ray_routed(
    apply_rows: Callable[[int, torch.Tensor, torch.Tensor], torch.Tensor],
    weights: torch.Tensor,
    experts: Sequence[Tuple[int, torch.Tensor]],
    samples: int,
    out_dim: int,
    log: Optional[List[List[int]]] = None,
) -> torch.Tensor:
    """Ray-granularity routed blend (the JAX `mega_apply_ray_routed`).

    weights: (R * samples, K) from `cluster_weights`, each ray's samples
    consecutive; experts: `ray_route_experts` of the rays' support masks.
    apply_rows(cell, rows, rays) evaluates that cell's submodule on the
    points `rows` (every sample of `rays`, ray by ray) -> (len(rows), C).
    Each cell's outputs are weighted by its column of `weights` on those
    points and added into an (R * samples, C) f32 accumulator, cell by
    cell. Equals the dense blend wherever each ray's support covers every
    cell with nonzero weight on it (a superset only adds zero-weight
    terms); rays supported nowhere get 0. The rays each cell ran are
    appended to `log` when given."""
    out = weights.new_zeros((weights.shape[0], out_dim), dtype=torch.float32)
    offsets = torch.arange(samples, device=weights.device)
    counts = []
    for cell, rays in experts:
        counts.append(int(rays.shape[0]))
        rows = (rays[:, None] * samples + offsets).reshape(-1)
        w = weights[rows, cell]
        out.index_add_(0, rows, w[:, None] * apply_rows(cell, rows, rays).float())
    if log is not None:
        log.append(counts)
    return out


def ray_route_capacity(support, bucket: bool = True) -> int:
    """The largest per-cell ray count of `support` ((R, K) bool, numpy),
    rounded up to a power of two with `bucket`; at least 1."""
    counts = np.asarray(support, bool).sum(axis=0)
    cap = max(int(counts.max()) if counts.size else 0, 1)
    if bucket:
        cap = 1 << (cap - 1).bit_length()
    return cap


def ray_route_plan(support, bucket: bool = True, expert_cost: float = 4.0,
                   capacity: int = 0, pad_experts_to: int = 0):
    """Load-balanced virtual-expert plan of a per-ray support mask.

    support: (R, K) bool, numpy. Returns `(support_v (R, Kv) bool,
    cell_ids (Kv,) int32, capacity int)`: each cell with load L becomes
    ceil(L / capacity) replicas holding consecutive blocks of its rays;
    cells with no ray get none. The capacity is the power of two that
    minimises `padded slots + expert_cost * Kv` (ties keep the larger), or
    `capacity` when given. With `bucket` Kv is padded to a power of two
    with empty replicas of cell 0; `pad_experts_to` pads it to that count.
    The JAX Runner's gate reads `len(cell_ids) * capacity` per ray."""
    support = np.asarray(support, bool)
    r, k = support.shape
    loads = support.sum(axis=0)
    max_load = int(loads.max()) if loads.size else 0
    if max_load == 0:
        kv_pad = max(1, int(pad_experts_to))
        return np.zeros((r, kv_pad), bool), np.zeros(kv_pad, np.int32), max(1, int(capacity))

    if capacity > 0:
        cap = int(capacity)
    else:
        cap_hi = 1 << (max_load - 1).bit_length()
        best_c, best_cost = cap_hi, None
        c = cap_hi
        while c >= 1:
            replicas = -(-loads // c)
            cost = float((replicas * c).sum()) + expert_cost * float(replicas.sum())
            if best_cost is None or cost < best_cost:
                best_c, best_cost = c, cost
            c //= 2
        cap = int(best_c)

    cols, ids = [], []
    for j in range(k):
        rows = np.flatnonzero(support[:, j])
        for start in range(0, len(rows), cap):
            col = np.zeros(r, bool)
            col[rows[start:start + cap]] = True
            cols.append(col)
            ids.append(j)
    kv = len(cols)
    kv_pad = kv
    if pad_experts_to:
        assert pad_experts_to >= kv, (pad_experts_to, kv)
        kv_pad = int(pad_experts_to)
    elif bucket:
        kv_pad = 1 << (kv - 1).bit_length()
    for _ in range(kv_pad - kv):
        cols.append(np.zeros(r, bool))
        ids.append(0)
    return np.stack(cols, axis=1), np.asarray(ids, np.int32), cap
