"""Flythrough renderer: rgb, depth and cell-overlay frames from pose files.

    python -m mega_nerf_tpu_torch.scripts.render_images --config_file ... \
        --container_path merged.pt --dataset_path <scene> \
        --centroids_path <masks>/params.pt --input <poses dir> --output <dir>

Counterpart of the JAX package's `scripts/render_images.py`. The input directory holds `poses.txt` (a 3x4 c2w per line),
`intrinsics.txt` (W H fx fy cx cy per line, divided by
`--val_scale_factor`) and `embeddings.txt` (an appearance index per line).
Per frame it writes `rgbs/{i:06d}.jpg`, `depths/{i:06d}.jpg` (log
inferno), with `--save_depth_npz` `depths_npz/{i:06d}.npy` (metric depth
times the pose scale factor), and last `cells/{i:06d}.jpg` (the rgb with
an overlay of the submodule nearest each pixel's depth point). The output
directories are made before the first frame; `--resume` accepts existing
ones and skips frames whose cell overlay reads back. `--occupancy_path`
tightens the fg intervals and a mixture's frames are culled per chunk
unless `--no_cell_cull` (`Runner.render_image`). Under torchrun the frames
are split `rank::world_size`; rank 0 makes the output directories and every
rank passes a barrier before its first frame (the JAX script lets the other
ranks race rank 0's mkdir instead).
"""

from __future__ import annotations

import traceback
from argparse import Namespace
from pathlib import Path
from typing import Dict

import numpy as np

from mega_nerf_tpu_torch.data.image_metadata import ImageMetadata
from mega_nerf_tpu_torch.data.torch_io import load_coordinates, load_pt
from mega_nerf_tpu_torch.ops.rays import generate_image_rays
from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts
from mega_nerf_tpu_torch.parallel import distributed
from mega_nerf_tpu_torch.runtime.runner import Runner


def get_render_opts(args=None) -> Namespace:
    parser = get_opts_base()
    parser.add_argument('--input', type=str, required=True)
    parser.add_argument('--output', type=str, required=True)
    parser.add_argument('--dataset_path', type=str, required=True)
    parser.add_argument('--centroids_path', type=str, required=True)
    parser.add_argument('--save_depth_npz', default=False, action='store_true')
    parser.add_argument('--resume', default=False, action='store_true')
    return parse_opts(parser, args, known_only=True)


def _lines(path: Path):
    return [line.split() for line in path.read_text().splitlines() if line.strip()]


def write_frame(i: int, runner: Runner, metadata: ImageMetadata,
                results: Dict[str, np.ndarray], centroids: np.ndarray, output: Path,
                pose_scale_factor: float, save_depth_npz: bool) -> None:
    """One rendered frame's files; the cell overlay last, as the frame's
    completion marker for --resume."""
    import cv2
    from PIL import Image

    w, h = metadata.W, metadata.H
    typ = "fine" if "rgb_fine" in results else "coarse"
    rgbs = (np.clip(results[f"rgb_{typ}"].reshape(h, w, 3), 0, 1) * 255).astype(np.uint8)
    Image.fromarray(rgbs).save(output / "rgbs" / f"{i:06d}.jpg")

    depth = np.nan_to_num(results[f"depth_{typ}"].astype(np.float32)).reshape(h, w)
    if save_depth_npz:
        np.save(str(output / "depths_npz" / f"{i:06d}.npy"), depth * pose_scale_factor)
    if f"bg_depth_{typ}" in results:
        fg_depth = np.nan_to_num(results[f"fg_depth_{typ}"]).reshape(-1)
        while fg_depth.shape[0] > 2 ** 24:
            fg_depth = fg_depth[::2]
        depth = np.clip(depth, None, np.quantile(fg_depth, 0.95))
    Image.fromarray(Runner.visualize_scalars(np.log(depth + 1e-8))).save(
        output / "depths" / f"{i:06d}.jpg")

    rays = generate_image_rays(metadata, runner.near, runner.far, runner.ray_altitude_range,
                               runner.hparams.center_pixels).numpy().reshape(h, w, 8)
    locations = rays[..., :3] + rays[..., 3:6] * depth[..., None]
    dists = np.linalg.norm(locations.reshape(-1, 1, 3) - centroids[None], axis=-1)
    assignments = dists.argmin(axis=1).reshape(h, w).astype(np.float32) / len(centroids)
    overlay = cv2.cvtColor(cv2.applyColorMap((assignments * 255).astype(np.uint8),
                                             cv2.COLORMAP_HSV), cv2.COLOR_BGR2RGB)
    blended = cv2.addWeighted(rgbs, 0.7, overlay, 0.3, 0)
    Image.fromarray(blended.astype(np.uint8)).save(output / "cells" / f"{i:06d}.jpg")


def main(hparams: Namespace) -> None:
    from PIL import Image

    if hparams.ckpt_path is None and hparams.container_path is None:
        raise ValueError("render_images needs --ckpt_path or --container_path")
    distributed.init_from_env(getattr(hparams, "device", "cuda"))
    rank, world = distributed.rank(), distributed.world_size()
    input_path = Path(hparams.input)
    output = Path(hparams.output)
    if rank == 0:
        for sub in ("rgbs", "depths", "cells") + (("depths_npz",) if hparams.save_depth_npz
                                                  else ()):
            (output / sub).mkdir(parents=True, exist_ok=hparams.resume)
    distributed.barrier("render_dirs_made")

    runner = Runner(hparams, set_experiment_path=False)
    runner.make_eval_state()
    centroids = np.asarray(load_pt(hparams.centroids_path)["centroids"], np.float32)
    pose_scale_factor = load_coordinates(hparams.dataset_path)["pose_scale_factor"]
    c2ws = [np.array(row, np.float32).reshape(3, 4) for row in _lines(input_path / "poses.txt")]
    intrinsics = [[float(x) / hparams.val_scale_factor for x in row]
                  for row in _lines(input_path / "intrinsics.txt")]
    embeddings = [int(row[0]) for row in _lines(input_path / "embeddings.txt")]

    for i in range(rank, len(c2ws), world):
        c2w = c2ws[i]
        cell_path = output / "cells" / f"{i:06d}.jpg"
        if hparams.resume and cell_path.exists():
            try:
                np.array(Image.open(cell_path))  # the last file of a frame reads back
                print(f"skipping {cell_path}")
                continue
            except Exception:
                traceback.print_exc()
        metadata = ImageMetadata(Path(""), c2w, int(intrinsics[i][0]), int(intrinsics[i][1]),
                                 np.asarray(intrinsics[i][2:], np.float32), embeddings[i],
                                 None, False)
        write_frame(i, runner, metadata, runner.render_image(metadata), centroids, output,
                    pose_scale_factor, hparams.save_depth_npz)
    distributed.barrier("frames_written")


if __name__ == '__main__':
    main(get_render_opts())
