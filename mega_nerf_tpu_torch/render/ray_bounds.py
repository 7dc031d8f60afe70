"""Occupancy-guided per-ray sampling bounds (opt-in serving acceleration).

A copy of the JAX package's `render/ray_bounds.py` (numpy; the port keeps
its own). Volume rendering spends a fixed per-ray sample budget uniformly
(plus one hierarchical refinement) over [near, min(far, ellipsoid exit)].
For aerial scenes most of that interval is empty air above the scene and
empty earth below it. A baked occupancy grid (`scripts/bake_occupancy.py`)
or a viewer octree (`scripts/create_octree.py`) knows where density
lives: this module rasterizes an octree's leaves into a dense occupancy
grid and tightens each ray's foreground sampling interval to the occupied
span.

Unlike `render/cell_cull.py` (exact: provably-zero terms dropped), this is
a lossy opt-in mode: regions outside the tightened interval are ones the
bake measured as (near-)empty, not proved empty. Enable it with
`--occupancy_path <occupancy or octree .npz>` on the eval and render entry
points. Bounds are computed on the host in vectorized numpy per image and
reach the renderer as one (N, 2) input (`render_rays(..., fg_bounds=...)`).
The NeRF++ background split is untouched: `has_bg` keys on the raw far, so
sky rays keep their background while their foreground interval collapses
to the (empty) occupied span.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mega_nerf_tpu_torch.render.cell_cull import clamp_rays_to_fg


def _dilate6(grid: np.ndarray, steps: int) -> np.ndarray:
    """6-neighbor binary dilation, `steps` times."""
    for _ in range(max(int(steps), 0)):
        d = grid.copy()
        d[1:] |= grid[:-1]
        d[:-1] |= grid[1:]
        d[:, 1:] |= grid[:, :-1]
        d[:, :-1] |= grid[:, 1:]
        d[:, :, 1:] |= grid[:, :, :-1]
        d[:, :, :-1] |= grid[:, :, 1:]
        grid = d
    return grid


def occupancy_grid(
    tree,
    thresh: float = 0.0,
    dilate: int = 1,
    max_res: int = 256,
) -> np.ndarray:
    """Dense (res, res, res) bool occupancy over the tree's [0,1]^3 coords.

    A voxel is occupied iff some leaf with sigma (last data channel)
    > `thresh` overlaps it, then dilated `dilate` voxels in the 6-neighbor
    sense — dilation absorbs trilinear-interpolation bleed and keeps razor-
    edge geometry inside the tightened interval. Resolution matches the
    finest leaf (leaves are N-ary aligned so boxes rasterize exactly),
    capped at `max_res` (a 256^3 bool grid is 16 MB of host memory).
    """
    leaves = tree.leaf_indices()
    sigma = np.asarray(tree.get_leaf_data(leaves), np.float32)[..., -1]
    corner, side = tree.leaf_bounds(leaves)
    keep = sigma > thresh
    corner, side = corner[keep], side[keep]
    if corner.shape[0] == 0:
        return np.zeros((1, 1, 1), bool)

    res = min(int(round(1.0 / float(side.min()))), max_res)
    grid = np.zeros((res, res, res), bool)
    for s in np.unique(side):
        sel = side == s
        sub = int(round(1.0 / float(s)))
        if sub <= res:
            # Leaf boxes are exact voxel blocks at their own resolution:
            # rasterize there, then map up to `res` by interval overlap.
            # Each res-voxel [v/res, (v+1)/res) overlaps sub-voxels
            # floor(v*sub/res) .. floor(((v+1)*sub-1)/res) — at most two
            # when sub <= res — and OR-ing the two per axis separably is
            # the exact 8-corner union (box occupancy factorizes per
            # axis). When sub divides res the two indices coincide and
            # this equals the repeat-upsample.
            g = np.zeros((sub, sub, sub), bool)
            idx = np.round(corner[sel] * sub).astype(np.int64)
            idx = np.clip(idx, 0, sub - 1)
            g[idx[:, 0], idx[:, 1], idx[:, 2]] = True
            if sub < res:
                a = np.arange(res)
                f = (a * sub) // res
                l = ((a + 1) * sub - 1) // res
                g = g[f] | g[l]
                g = g[:, f] | g[:, l]
                g = g[:, :, f] | g[:, :, l]
            grid |= g
        else:
            # Leaf finer than the capped grid: it overlaps at most two
            # voxels per axis (leaf side < voxel side) — mark the voxels
            # containing both extents (exact when the tree is N-ary
            # aligned to res, conservative otherwise).
            lo = np.clip((corner[sel] * res).astype(np.int64), 0, res - 1)
            hi = np.clip(
                ((corner[sel] + s) * res - 1e-6).astype(np.int64),
                0, res - 1,
            )
            for cx in (lo[:, 0], hi[:, 0]):
                for cy in (lo[:, 1], hi[:, 1]):
                    for cz in (lo[:, 2], hi[:, 2]):
                        grid[cx, cy, cz] = True

    return _dilate6(grid, dilate)


def tighten_rays(
    rays: np.ndarray,
    grid: np.ndarray,
    tree_invradius: np.ndarray,
    tree_offset: np.ndarray,
    probes: int = 128,
    margin: int = 1,
    sphere_center: Optional[np.ndarray] = None,
    sphere_radius: Optional[np.ndarray] = None,
    chunk: int = 65536,
    mode: str = "near",
) -> np.ndarray:
    """(N, 2) float32 tightened [near, far] of each ray's fg interval.

    Probes `probes` points uniformly over [near, min(far, ellipsoid exit)]
    (the device's fg interval, via cell_cull.clamp_rays_to_fg) against the
    occupancy grid; the output brackets the first..last occupied probe
    with `margin` extra probe steps each side (the occupied span between
    two probes `step` apart is bracketed to +-1 step by construction, so
    margin >= 1 covers sub-step geometry the probes straddle).

    `mode` (the JAX package's quality measurements on a trained drone
    model, `PERF_TPU_HISTORY.md` round 5):
    - "near" (default): only the entry point tightens; the far end stays
      at the full fg interval and rays whose probes all miss keep their
      full interval. Skipping the empty air above the scene kept PSNR;
      trained models keep sub-threshold "fog" density past the last
      occupied voxel whose cumulative alpha baseline sampling picks up,
      so far tightening and interval collapse cost PSNR at every bake
      threshold there.
    - "both": far end tightens too and all-miss rays collapse to a
      zero-width interval at the fg end (all fg weights vanish; for bg
      rays the background alone renders): the largest interval shrink
      and the tightest cull boxes, at a PSNR cost.

    `tree_invradius`/`tree_offset`: the octree's world->tree transform
    (N3Tree.world_to_tree). Pure numpy, chunked to bound the (chunk,
    probes, 3) intermediate.
    """
    assert mode in ("near", "both"), mode
    rays = np.asarray(rays)
    out = np.empty((rays.shape[0], 2), np.float32)
    s = np.linspace(0.0, 1.0, probes, dtype=np.float32)
    res = grid.shape[0]
    gflat = np.ascontiguousarray(grid.reshape(-1))
    inv = np.asarray(tree_invradius, np.float32)
    off = np.asarray(tree_offset, np.float32)
    # Half-voxel tolerance: probes that belong to the box but land a
    # float-rounding hair past it (e.g. the ellipsoid-exit endpoint,
    # inflated 1e-5 by clamp_rays_to_fg) read the edge voxel instead
    # of poisoning the whole tail as "occupied unknown".
    tol = 0.5 / res

    def probe_block(o_tc, d_tc, t_blk):
        """(k,) int probe-hit index within the block, -1 = no hit.

        Outside the baked box the grid knows nothing: count it occupied.
        Scene density routinely extends past a viewer octree's auto-scaled
        bounds, and treating outside as empty collapses rays onto real
        content. A bake_occupancy grid covers the full fg-reachable AABB,
        so there this branch never fires."""
        tc = o_tc[:, None, :] + d_tc[:, None, :] * t_blk[..., None]
        inside = ((tc >= -tol) & (tc < 1.0 + tol)).all(-1)
        vox = np.clip((tc * res).astype(np.int64), 0, res - 1)
        flat = (vox[..., 0] * res + vox[..., 1]) * res + vox[..., 2]
        hit = ~inside | gflat[flat]
        anyb = hit.any(1)
        return np.where(anyb, hit.argmax(1), -1)

    def scan(o_tc, d_tc, t_all, order):
        """First probe-hit index along `order` (a permutation of probe
        positions), scanned in cache-sized blocks with early exit: rows
        resolve as soon as their hit block is reached: for aerial scenes
        the entry sits in the first third of the interval, so most probe
        work is skipped, and the blocks stay cache-sized."""
        k = o_tc.shape[0]
        found = np.full(k, -1, np.int64)
        live = np.arange(k)
        blk = 16
        for b0 in range(0, probes, blk):
            sel = order[b0 : b0 + blk]
            h = probe_block(o_tc[live], d_tc[live], t_all[live][:, sel])
            got = h >= 0
            found[live[got]] = sel[h[got]]
            live = live[~got]
            if live.size == 0:
                break
        return found

    for start in range(0, rays.shape[0], chunk):
        r = rays[start : start + chunk]
        fg = clamp_rays_to_fg(r, sphere_center, sphere_radius)
        near = fg[:, 6].astype(np.float32)
        fend = fg[:, 7].astype(np.float32)
        t = near[:, None] * (1.0 - s) + fend[:, None] * s  # (n, P)
        o_tc = r[:, :3].astype(np.float32) * inv + off
        d_tc = r[:, 3:6].astype(np.float32) * inv

        fwd = np.arange(probes)
        first = scan(o_tc, d_tc, t, fwd)
        any_hit = first >= 0
        step = (fend - near) / (probes - 1)
        lo = near + np.maximum(first - margin, 0) * step
        if mode == "near":
            # Far end stays at the full interval; all-miss rays untouched.
            out[start : start + chunk, 0] = np.where(any_hit, lo, near)
            out[start : start + chunk, 1] = fend
        else:
            last = scan(o_tc, d_tc, t, fwd[::-1])
            hi = near + np.minimum(last + margin, probes - 1) * step
            out[start : start + chunk, 0] = np.where(any_hit, lo, fend)
            out[start : start + chunk, 1] = np.where(any_hit, hi, fend)
    return out


def load_occupancy(
    path,
    thresh: Optional[float] = None,
    dilate: int = 1,
    max_res: int = 256,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(grid, invradius, offset) from a baked occupancy or octree `.npz`.

    Two formats:
    - `scripts/bake_occupancy.py` output (preferred): a packed res^3 bool
      grid over the FULL fg ellipsoid AABB — `thresh`/`dilate` semantics
      applied at bake time / here respectively.
    - a viewer octree (`scripts/create_octree.py`): leaves rasterize via
      `occupancy_grid`. Beware its auto-scaled box: segments outside it
      conservatively count occupied (tighten_rays), which can neutralize
      the tightening; prefer the dedicated bake.

    `thresh=None` (auto) places the sigma cutoff where crossing one grid
    voxel adds 1% alpha: sigma = -ln(0.99) / voxel_world_size. Baked
    trees keep large low-sigma "fog" leaves whose alpha contribution per
    crossing is negligible; thresh 0.0 marks them occupied, so no
    interval would tighten."""
    from mega_nerf_tpu_torch.octree.n3tree import N3Tree

    z = np.load(path)
    if "occupancy" in z.files:
        if thresh is not None and thresh >= 0:
            import warnings

            warnings.warn(
                "occupancy threshold was fixed when this packed grid was "
                "baked (scripts/bake_occupancy.py); the requested thresh="
                f"{thresh} is ignored — re-bake to change it",
                stacklevel=2,
            )
        res = int(z["res"])
        grid = np.unpackbits(z["occupancy"])[: res**3].astype(bool)
        grid = grid.reshape(res, res, res)
        return (
            _dilate6(grid, dilate),
            z["invradius3"].astype(np.float32),
            z["offset"].astype(np.float32),
        )

    tree = N3Tree.load(path)
    if thresh is None or thresh < 0:
        leaves = tree.leaf_indices()
        _, side = tree.leaf_bounds(leaves)
        res = min(int(round(1.0 / float(side.min()))), max_res)
        # invradius is per-axis: use the COARSEST axis (largest voxel) so
        # the cutoff is conservative on every axis.
        voxel_world = float(
            (1.0 / np.asarray(tree.invradius)).max()
        ) / res
        thresh = -np.log(0.99) / voxel_world
    return (
        occupancy_grid(tree, thresh=float(thresh), dilate=dilate,
                       max_res=max_res),
        np.asarray(tree.invradius, np.float32),
        np.asarray(tree.offset, np.float32),
    )
