"""Bake a dense occupancy grid over the full foreground region.

    python -m mega_nerf_tpu_torch.scripts.bake_occupancy --config_file ... \
        --container_path merged.pt --dataset_path <scene> \
        --output occupancy.npz [--res 256] [--alpha_thresh 0.01]

Counterpart of the JAX package's `scripts/bake_occupancy.py`: probes the
model's sigma on a res^3 grid spanning the fg ellipsoid's AABB (every fg
sample position lies inside the ellipsoid, hence inside this box) and
thresholds at the sigma whose single-voxel crossing adds `--alpha_thresh`
alpha. The output `.npz` (keys `occupancy` (packed bits), `res`,
`invradius3`, `offset`, `sigma_thresh`, as the JAX script writes them)
feeds `--occupancy_path` (`render/ray_bounds.load_occupancy`).

A viewer octree (`scripts/create_octree.py`) auto-scales its box to the
dense content, and ray segments outside it must count as occupied; this
grid covers everything fg sampling can reach, so "unoccupied" is a
statement about the model. The probes go through
`render/rendering.py::query_points` on `--device`, plane by plane in
spatial order, in calls of max(--model_chunk_size, 131,072) points.
"""

from __future__ import annotations

from argparse import Namespace

import numpy as np

from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts
from mega_nerf_tpu_torch.render.rendering import RenderSettings
from mega_nerf_tpu_torch.runtime.runner import EVAL_POINT_BUDGET, Runner
from mega_nerf_tpu_torch.scripts import create_octree as co


def get_bake_opts(args=None) -> Namespace:
    parser = get_opts_base()
    parser.add_argument("--dataset_path", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--res", type=int, default=256)
    parser.add_argument("--alpha_thresh", type=float, default=0.01)
    return parse_opts(parser, args)


def main(hparams: Namespace) -> float:
    """Bake and save the grid -> its occupied share."""
    # The Runner derives the fg ellipsoid the renderer uses (cameras and
    # their copies pinned to the altitude bounds, ellipse_scale_factor), so
    # every fg sample position lies inside the grid.
    runner = Runner(hparams, set_experiment_path=False)
    runner.make_eval_state()
    bundle = runner.fg
    if runner.sphere_radius is not None:
        center = runner.sphere_center.cpu().numpy().astype(np.float64)
        radius = runner.sphere_radius.cpu().numpy().astype(np.float64)
        lo, hi = center - radius, center + radius
    else:
        # No ellipsoid (fg-only scene): fg samples lie within `far` of a camera.
        cams = np.stack([x.c2w[:3, 3] for x in runner.train_items + runner.val_items])
        lo = cams.min(0) - runner.far
        hi = cams.max(0) + runner.far

    res = int(hparams.res)
    voxel = float((hi - lo).max()) / res
    sigma_thresh = -np.log(1.0 - hparams.alpha_thresh) / voxel

    chunk = max(int(hparams.model_chunk_size or 0), EVAL_POINT_BUDGET // 64)
    culler = co._make_point_culler(hparams, bundle)
    sigma_at = co._make_sigma_fn(bundle, RenderSettings.from_hparams(hparams), chunk,
                                 runner.device, culler)

    grid = np.zeros((res, res, res), bool)
    # Plane by plane in spatial order (keeps the point culler's active sets
    # local and the host arrays small).
    arr = (np.arange(res, dtype=np.float32) + 0.5) / res
    planes_per_batch = max(1, (2 * chunk) // (res * res))
    for x0 in range(0, res, planes_per_batch):
        xs = arr[x0:x0 + planes_per_batch]
        g = np.stack(np.meshgrid(xs, arr, arr, indexing="ij"), axis=-1)
        pts = lo + g.reshape(-1, 3) * (hi - lo)
        sig = sigma_at(pts.astype(np.float32)).reshape(len(xs), res, res)
        grid[x0:x0 + planes_per_batch] = sig >= sigma_thresh

    invradius = 1.0 / (hi - lo)
    offset = -lo * invradius  # world -> [0,1]: x*invradius + offset
    np.savez_compressed(
        hparams.output,
        occupancy=np.packbits(grid.reshape(-1)),
        res=np.int64(res),
        invradius3=invradius.astype(np.float32),
        offset=offset.astype(np.float32),
        sigma_thresh=np.float32(sigma_thresh),
    )
    share = float(grid.mean())
    print(f"occupancy {res}^3 over {np.round(lo, 2)}..{np.round(hi, 2)}: "
          f"{100.0 * share:.1f}% occupied (sigma_thresh {sigma_thresh:.3f}) -> "
          f"{hparams.output}")
    return share


if __name__ == "__main__":
    main(get_bake_opts())
