"""Spatial partitioner: per-image boolean masks of the rays of each grid cell.

    python -m mega_nerf_tpu_torch.scripts.create_cluster_masks --config_file ... \
        --dataset_path <scene> --output <masks> --grid_dim 2 4

Counterpart of the JAX package's `scripts/create_cluster_masks.py`. For a `grid_dim[0] x grid_dim[1]` grid of centroids over the
camera y/z extent (altitude zeroed), every ray of every image is sampled at
`--ray_samples` depths between its near and far bounds; the ray belongs to
cell j iff the minimum over its samples of (distance to centroid j /
distance to the nearest centroid) is at most `--boundary_margin`. Writes:

- `{output}/params.pt`: origin_drb, pose_scale_factor, ray_altitude_range,
  near, far, centroids, grid_dim, min/max_position, cluster_2d (the keys
  the runners check the scene against);
- `{output}/{j}/{stem}.pt`: the zip(torch) bool HxW mask of cell j.

The ratio pass runs on `--device` (default cuda) in torch, a view at a
time in chunks of `--ray_chunk_size` rays, with a running minimum over
blocks of 100 samples so that the (rays, samples, cells) distance tensor
never exists. Distances are norms of explicit differences (a
matrix-product distance loses the digits that decide `ratio <= margin`).
`--segmentation_path` ANDs each mask with the view's segmentation mask;
`--resume` keeps views whose masks all read back. Under torchrun the views
are split `rank::world_size`: rank 0 makes the output directories and
writes `params.pt` while the others wait at a barrier, and every rank
passes a last barrier once its masks are written.
"""

from __future__ import annotations

import time
import traceback
from argparse import Namespace
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from mega_nerf_tpu_torch.data.torch_io import (
    load_coordinates,
    load_mask_zip,
    load_pt,
    save_mask_zip,
    save_pt,
)
from mega_nerf_tpu_torch.ops.rays import get_ray_directions, get_rays
from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts
from mega_nerf_tpu_torch.parallel import distributed
from mega_nerf_tpu_torch.parallel.distributed import main_print
from mega_nerf_tpu_torch.runtime.runner import resolve_device


def get_mask_opts(args=None) -> Namespace:
    parser = get_opts_base()
    parser.add_argument('--dataset_path', type=str, required=True)
    parser.add_argument('--segmentation_path', type=str, default=None)
    parser.add_argument('--output', type=str, required=True)
    parser.add_argument('--grid_dim', nargs='+', type=int, required=True)
    parser.add_argument('--ray_samples', type=int, default=1000)
    parser.add_argument('--ray_chunk_size', type=int, default=48 * 1024)
    parser.add_argument('--resume', default=False, action='store_true')
    return parse_opts(parser, args, known_only=True)


def make_centroids(grid_dim: Sequence[int], min_position: np.ndarray,
                   max_position: np.ndarray) -> np.ndarray:
    """(gy * gz, 3) centroids: a 2D grid over the y/z camera extent,
    altitude 0."""
    ranges = max_position[1:] - min_position[1:]
    gy, gz = grid_dim
    off_y = np.arange(gy) * ranges[0] / gy + ranges[0] / (gy * 2)
    off_z = np.arange(gz) * ranges[1] / gz + ranges[1] / (gz * 2)
    centroids = np.zeros((gy, gz, 3), np.float32)
    centroids[:, :, 1] = min_position[1] + off_y[:, None]
    centroids[:, :, 2] = min_position[2] + off_z[None, :]
    return centroids.reshape(-1, 3)


def min_dist_ratios_for_rays(
    rays: torch.Tensor,  # (N, 8)
    centroids: torch.Tensor,  # (K, 3)
    ray_samples: int,
    cluster_dim_start: int,
    sample_block: int = 100,
) -> torch.Tensor:
    """(N, K) minimum over the samples of distance-to-centroid /
    distance-to-nearest, on the rays' device."""
    z_steps = torch.linspace(0.0, 1.0, ray_samples, device=rays.device)
    near, far = rays[:, 6:7], rays[:, 7:8]
    c = centroids[:, cluster_dim_start:]

    result = torch.full((rays.shape[0], centroids.shape[0]), float("inf"),
                        device=rays.device)
    for start in range(0, ray_samples, sample_block):
        z_blk = z_steps[start:start + sample_block]
        z_vals = near * (1 - z_blk) + far * z_blk  # (N, s)
        xyz = rays[:, None, 0:3] + rays[:, None, 3:6] * z_vals[..., None]
        p = xyz[..., cluster_dim_start:]
        dists = torch.linalg.norm(p[:, :, None, :] - c[None, None], dim=-1)
        min_d = dists.min(dim=-1, keepdim=True).values  # (N, s, 1)
        result = torch.minimum(result, (dists / (min_d + 1e-8)).min(dim=1).values)
    return result


def view_rays(metadata, near: float, far: float, ray_altitude_range,
              center_pixels: bool, device) -> torch.Tensor:
    """(H * W, 8) rays of one view's metadata dict, on `device`."""
    fx, fy, cx, cy = (float(v) for v in np.asarray(metadata["intrinsics"]))
    directions = get_ray_directions(int(metadata["W"]), int(metadata["H"]),
                                    fx, fy, cx, cy, center_pixels, device=device)
    c2w = torch.as_tensor(np.asarray(metadata["c2w"], np.float32), device=device)
    return get_rays(directions, c2w, near, far, ray_altitude_range).reshape(-1, 8)


def view_ratios(rays: torch.Tensor, centroids: torch.Tensor, ray_samples: int,
                cluster_dim_start: int, ray_chunk_size: int) -> np.ndarray:
    """(N, K) ratios of one view's rays, chunk by chunk -> host numpy."""
    return np.concatenate([
        min_dist_ratios_for_rays(rays[j:j + ray_chunk_size], centroids,
                                 ray_samples, cluster_dim_start).cpu().numpy()
        for j in range(0, rays.shape[0], ray_chunk_size)])


def main(hparams: Namespace) -> None:
    if hparams.ray_altitude_range is None:
        raise ValueError("create_cluster_masks needs --ray_altitude_range")
    distributed.init_from_env(getattr(hparams, "device", "cuda"))
    device = resolve_device(getattr(hparams, "device", "cuda"))
    rank, world = distributed.rank(), distributed.world_size()
    output_path = Path(hparams.output)

    dataset_path = Path(hparams.dataset_path)
    coords = load_coordinates(dataset_path)
    origin_drb = coords["origin_drb"]
    pose_scale_factor = coords["pose_scale_factor"]
    ray_altitude_range = [
        (x - origin_drb[0]) / pose_scale_factor for x in hparams.ray_altitude_range
    ]

    metadata_paths = list((dataset_path / 'train' / 'metadata').iterdir()) + list(
        (dataset_path / 'val' / 'metadata').iterdir())
    camera_positions = np.stack(
        [np.asarray(load_pt(p)["c2w"])[:3, 3] for p in metadata_paths])
    main_print(f"Number of images in dir: {camera_positions.shape}")
    min_position = camera_positions.min(axis=0)
    max_position = camera_positions.max(axis=0)
    main_print(f"Coord range: {min_position} {max_position}")

    centroids = make_centroids(hparams.grid_dim, min_position, max_position)
    main_print(f"Centroids: {centroids}")

    near = hparams.near / pose_scale_factor
    far = hparams.far / pose_scale_factor if hparams.far is not None else 2.0

    if rank == 0:
        output_path.mkdir(parents=True, exist_ok=hparams.resume)
        save_pt({
            "origin_drb": origin_drb,
            "pose_scale_factor": pose_scale_factor,
            "ray_altitude_range": ray_altitude_range,
            "near": near,
            "far": far,
            "centroids": centroids,
            "grid_dim": list(hparams.grid_dim),
            "min_position": min_position.astype(np.float32),
            "max_position": max_position.astype(np.float32),
            "cluster_2d": hparams.cluster_2d,
        }, output_path / "params.pt")
        if not hparams.resume:
            for j in range(centroids.shape[0]):
                (output_path / str(j)).mkdir(parents=True)
    distributed.barrier("cluster_mask_dirs")

    cluster_dim_start = 1 if hparams.cluster_2d else 0
    centroids_t = torch.from_numpy(centroids).to(device)
    t0, n_rays = time.perf_counter(), 0
    for subdir in ("train", "val"):
        paths = sorted((dataset_path / subdir / "metadata").iterdir())
        for metadata_path in paths[rank::world]:
            filename = metadata_path.stem + ".pt"
            if hparams.resume and _all_masks_valid(output_path, centroids.shape[0],
                                                   filename):
                continue
            metadata = load_pt(metadata_path)
            rays = view_rays(metadata, near, far, ray_altitude_range,
                             hparams.center_pixels, device)
            n_rays += rays.shape[0]
            ratios = view_ratios(rays, centroids_t, hparams.ray_samples,
                                 cluster_dim_start, hparams.ray_chunk_size).reshape(
                int(metadata["H"]), int(metadata["W"]), centroids.shape[0])

            seg_mask = None
            if hparams.segmentation_path is not None:
                seg_mask = load_mask_zip(Path(hparams.segmentation_path) / filename)
            for j in range(centroids.shape[0]):
                mask = ratios[:, :, j] <= hparams.boundary_margin
                if seg_mask is not None:
                    mask = np.logical_and(mask, seg_mask)
                save_mask_zip(mask, output_path / str(j) / filename)
    seconds = time.perf_counter() - t0
    print(f"Masks of {n_rays} rays in {seconds:.2f} s "
          f"({n_rays / max(seconds, 1e-9):.1f} rays/s) on {device}"
          + (f" (rank {rank} of {world})" if world > 1 else ""), flush=True)
    distributed.barrier("cluster_masks_written")


def _all_masks_valid(output_path: Path, k: int, filename: str) -> bool:
    for j in range(k):
        mask_path = output_path / str(j) / filename
        if not mask_path.exists():
            return False
        try:
            load_mask_zip(mask_path)
        except Exception:
            traceback.print_exc()
            return False
    return True


if __name__ == '__main__':
    main(get_mask_opts())
