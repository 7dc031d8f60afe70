"""Exact per-chunk submodule culling for merged Mega-NeRF rendering.

A copy of the JAX package's `render/cell_cull.py` (numpy; the port keeps
its own). The dense mixture blend (`models/mega.mega_apply`) evaluates
every submodule on every sample point: K x the MLP work per chunk wherever
the chunk's rays travel. But `cluster_weights` has compact support: a
submodule's weight is exactly zero wherever its centroid distance exceeds
boundary_margin x the nearest centroid's distance. Every foreground sample
of a chunk of camera rays lies inside the axis-aligned bounding box of the
rays' [near, far] segment endpoints (segments are convex combinations of
their endpoints; an AABB is convex), so a submodule whose weight is
provably zero everywhere in that box can be skipped for the chunk without
changing an output value.

The per-cell proof over a box B (interval arithmetic):

    lb_j = min_{p in B} d_j(p)     -- point-to-box distance to centroid j
    ub_k = max_{p in B} d_k(p)     -- distance to the farthest corner of B
    min_k d_k(p) <= min_k ub_k     -- for every p in B

so ``lb_j > margin * min_k ub_k`` implies ``d_j(p) > margin * min_d(p)``
for all p in B, which is exactly the condition under which
`cluster_weights` zeroes cell j (strict ``>``); for margin == 1 (hard
assignment) the same bound proves j can never win the argmin.

Culling is host-side and cheap (O(rays + K) numpy per chunk). The port's
renderer (`runtime.runner.Runner.render_image`) passes the chunk's active
submodule indices to `mega_apply`, which runs only those on their own
packed weights; routing weights are still computed over all K centroids,
so a skipped submodule only ever contributed `0 * out_k`. The JAX
package's `ParamSubsetCache` and power-of-two `bucket_mask` bound its
compiles per active count and have no counterpart here.

Background submodules are never culled: NeRF++ background samples route by
their real-world coordinates out to unbounded radii, where all centroid
distances converge to each other and every cell falls within any
margin > 1.
"""

from __future__ import annotations

import numpy as np

# Relative slack on the cull threshold. The bound itself is proved in real
# arithmetic; the device evaluates `cluster_weights` in float32, so a cell
# sitting within float32 rounding of the threshold could get a ~1e-7-mass
# weight on device while host float64 math culls it. The slack keeps such
# razor-edge cells active — culling stays EXACT, never approximate.
_EDGE_SLACK = 1e-5


def clamp_rays_to_fg(
    rays: np.ndarray,
    sphere_center=None,
    sphere_radius=None,
) -> np.ndarray:
    """Copy of `rays` with far clamped to the foreground ellipsoid exit.

    Scenes with a NeRF++ background carry far ~ 1e5 (the bg model owns
    everything past the ellipsoid, `render/rendering.py::render_rays`), so
    a cull box built from raw [near, far] endpoints spans the whole scene
    and culls nothing. Foreground samples stop at min(far, ellipsoid
    exit), so the box may too.

    Host replica of `ops/geometry.intersect_sphere` in float64, inflated
    by 1e-5 relative so f32 device rounding can never place a sample past
    the host's box.
    Always returns a fresh float64 array (callers mutate it in place)."""
    if sphere_radius is None:
        return np.array(rays, np.float64)
    rays = np.asarray(rays, np.float64)
    c = np.asarray(sphere_center, np.float64)
    r = np.asarray(sphere_radius, np.float64)
    o = (rays[:, :3] - c) / r
    d = rays[:, 3:6] / r
    d1 = -(d * o).sum(-1) / (d * d).sum(-1)
    p = o + d1[:, None] * d
    d2 = np.sqrt(np.maximum(1.0 - (p * p).sum(-1), 0.0)) / np.sqrt(
        (d * d).sum(-1)
    )
    exit_t = np.maximum(d1 + d2, rays[:, 6]) * (1.0 + 1e-5)
    out = rays.copy()
    out[:, 7] = np.minimum(rays[:, 7], exit_t)
    return out


def chunk_point_box(rays: np.ndarray, cluster_dim_start: int = 0):
    """AABB containing every fg sample position of a chunk of rays.

    rays: (N, 8) float [origin(3) | direction(3) | near | far] — the 8-float
    record of `ops/rays.py`. Foreground samples lie at o + t*d with
    t in [near, t_max], t_max <= far (sphere/altitude truncation only ever
    SHRINKS the interval, `render/rendering.py`), so the box over the
    {t=near, t=far} endpoints contains them all. Returns (lo, hi) over the
    routing dims [cluster_dim_start:3] (cluster_2d drops altitude, matching
    `models/mega.cluster_weights`).
    """
    rays = np.asarray(rays, np.float64)
    o, d = rays[:, :3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    pts = np.concatenate([o + near * d, o + far * d], axis=0)
    pts = pts[:, cluster_dim_start:3]
    return pts.min(axis=0), pts.max(axis=0)


def active_cells(
    rays: np.ndarray,
    centroids: np.ndarray,
    boundary_margin: float,
    cluster_dim_start: int = 0,
) -> np.ndarray:
    """(K,) bool mask of submodules that can have nonzero routing weight for
    ANY foreground sample of these rays. Conservative (never culls a
    contributing cell) and typically tight for localized camera frusta.

    Rays with a zero-width interval (far <= near) are excluded from the
    box: they arise only from occupancy-collapsed bounds
    (render/ray_bounds.py), where render_rays zeroes the trailing
    last_delta so the ray's fg contribution — hence its routing — is
    exactly zero. Without the exclusion one sky pixel per tile drags the
    box out to the ellipsoid exit and no horizon tile ever culls.
    """
    rays = np.asarray(rays)
    live = rays[:, 7] > rays[:, 6]
    if not live.all() and live.any():
        rays = rays[live]
    # All-collapsed chunk: every fg weight is zero — any non-empty mask is
    # exact; fall through with the original rays for determinism.
    lo, hi = chunk_point_box(rays, cluster_dim_start)
    return _active_cells_box(lo, hi, centroids, boundary_margin,
                             cluster_dim_start)


def active_cells_for_points(
    points: np.ndarray,
    centroids: np.ndarray,
    boundary_margin: float,
    cluster_dim_start: int = 0,
) -> np.ndarray:
    """Same mask for a batch of QUERY POINTS (no rays): used by the octree
    bake (`scripts/create_octree.py`), whose sigma/RGBA probes walk the
    grid/leaf list in spatial order — each chunk's AABB touches 1-2 cells
    of the grid, so the dense blend's K x FLOPs collapse to the local
    cells'."""
    pts = np.asarray(points, np.float64)[:, cluster_dim_start:3]
    return _active_cells_box(pts.min(axis=0), pts.max(axis=0), centroids,
                             boundary_margin, cluster_dim_start)


def ray_support_masks(
    rays: np.ndarray,
    centroids: np.ndarray,
    boundary_margin: float,
    cluster_dim_start: int = 0,
    probes: int = 16,
    chunk: int = 65536,
) -> np.ndarray:
    """(N, K) bool: cells that can have nonzero routing weight anywhere on
    each ray's OWN [near, far] segment — a per-RAY support set, far tighter
    than the per-chunk AABB bound on oblique views, where a chunk's box
    reaches every cell while each ray's segment crosses a few.

    Conservative between probe points: for p within h of probe p1
    (h = segment/(2*(probes-1))), d_j(p) >= d_j(p1) - h and
    min_d(p) <= min_d(p1) + h, so "j active somewhere in the
    h-neighborhood" implies d_j(p1) <= margin*min_d(p1) + (margin+1)*h —
    the slackened test below. Intended for occupancy-TIGHTENED rays
    (render/ray_bounds.py), whose short segments make the slack negligible
    (width/30 vs cell pitches); it is valid (just looser) for raw rays.
    Zero-width (collapsed) rays get an all-False row: their fg
    contribution is exactly zero (render_rays zeroes their last_delta).

    Distances run in the routing subspace [cluster_dim_start:3], matching
    `models/mega.cluster_weights`. Vectorized f32 numpy in the
    |p|^2 + |c|^2 - 2 p.c sgemm form.
    """
    rays = np.asarray(rays, np.float32)
    c = np.asarray(centroids, np.float32)[:, cluster_dim_start:]
    n, k = rays.shape[0], c.shape[0]
    margin = max(float(boundary_margin), 1.0)
    out = np.zeros((n, k), bool)
    s = np.linspace(0.0, 1.0, probes, dtype=np.float32)
    c_sq = (c**2).sum(-1)
    for start in range(0, n, chunk):
        seg = rays[start : start + chunk]
        live = seg[:, 7] > seg[:, 6]
        if not live.any():
            continue
        seg = seg[live]
        t = seg[:, 6:7] * (1.0 - s) + seg[:, 7:8] * s  # (m, Q)
        pts = (
            seg[:, None, :3] + seg[:, None, 3:6] * t[..., None]
        )[..., cluster_dim_start:]  # (m, Q, dims)
        p_sq = (pts**2).sum(-1)
        d_sq = p_sq[..., None] + c_sq - 2.0 * (pts @ c.T)  # (m, Q, K)
        dist = np.sqrt(np.maximum(d_sq, 0.0))
        h = (seg[:, 7] - seg[:, 6])[:, None, None] / (2.0 * (probes - 1))
        act = dist <= margin * dist.min(-1, keepdims=True) + (
            (margin + 1.0) * h + _EDGE_SLACK
        )
        dst = out[start : start + chunk]
        dst[live] = act.any(1)
        out[start : start + chunk] = dst
    return out


def support_order(masks: np.ndarray) -> np.ndarray:
    """Permutation grouping rays by their support SET (ray_support_masks),
    so consecutive chunks share one small active union instead of the
    per-chunk unions degrading to the image-level set. Collapsed rays
    (all-False rows) sort first — they join any chunk for free. Stable, so
    ties keep scanline locality. Rays are independent rows of every render
    pass; `Runner.render_image` un-permutes the outputs."""
    masks = np.asarray(masks, bool)
    k = masks.shape[1]
    if k <= 62:
        key = masks @ (np.int64(1) << np.arange(k, dtype=np.int64))
        return np.argsort(key, kind="stable")
    return np.lexsort(tuple(masks[:, i] for i in range(k - 1, -1, -1)))


def tile_order(w: int, h: int, chunk_rays: int) -> np.ndarray:
    """Permutation putting a row-major (h*w,) ray grid into square-tile
    order, tile area <= chunk_rays.

    Scanline chunks span the full image width, so their sample boxes stay
    wide in one scene dimension no matter how many rays fit a chunk; at a
    1920-wide production frame a 16k-ray chunk is 8.5 full-width rows,
    where a 128x128 tile covers 1/15 of the width — per-chunk active-cell
    sets shrink accordingly. Rays are independent rows of every render
    pass, so reordering is exact; `Runner.render_image` un-permutes the
    outputs."""
    t = 1
    while (t * 2) ** 2 <= chunk_rays and t * 2 <= max(w, h):
        t *= 2
    ys, xs = np.mgrid[0:h, 0:w]
    tiles_x = (w + t - 1) // t
    tile_id = (ys // t) * tiles_x + (xs // t)
    # Sort by (tile, y, x): stable row-major order within each tile.
    return np.lexsort((xs.ravel(), ys.ravel(), tile_id.ravel()))


def _active_cells_box(
    lo: np.ndarray,
    hi: np.ndarray,
    centroids: np.ndarray,
    boundary_margin: float,
    cluster_dim_start: int,
) -> np.ndarray:
    c = np.asarray(centroids, np.float64)[:, cluster_dim_start:]

    # Per-dim distance from the box to each centroid (0 inside the slab).
    gap = np.maximum(np.maximum(lo[None] - c, c - hi[None]), 0.0)
    lb = np.sqrt((gap**2).sum(axis=-1))  # min_{p in B} d_j(p)
    corner = np.maximum(np.abs(c - lo[None]), np.abs(hi[None] - c))
    ub = np.sqrt((corner**2).sum(axis=-1))  # max_{p in B} d_j(p)

    margin = max(float(boundary_margin), 1.0)
    threshold = margin * ub.min()
    mask = lb <= threshold * (1.0 + _EDGE_SLACK) + 1e-12
    # The nearest-ub cell always survives (lb <= ub.min() by definition),
    # so the mask is never empty; assert the invariant anyway.
    assert mask.any()
    return mask
