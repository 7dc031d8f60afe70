"""Render preview frames directly from a baked octree (.npz).

    python -m mega_nerf_tpu_torch.scripts.render_octree --tree tree.npz \
        --dataset_path <scene> [--split val] [--steps 256] [--output dir]
    python -m mega_nerf_tpu_torch.scripts.render_octree --tree tree.npz \
        --input <poses dir> --output dir

Counterpart of the JAX package's `scripts/render_octree.py`: a check of
`create_octree`'s output without the external viewer. Renders a dataset
split's views and reports each one's PSNR against its image, or renders
the poses of a `render_images`-style input directory (`poses.txt`,
`intrinsics.txt`). Prints one JSON line with the view count and the mean
PSNR. The tree lookup runs on the host (`octree/render.py`), the
compositing on `--device` (default cuda; cuda without a card raises).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from mega_nerf_tpu_torch.octree.n3tree import N3Tree
from mega_nerf_tpu_torch.octree.render import render_octree_rays
from mega_nerf_tpu_torch.ops.metrics import psnr
from mega_nerf_tpu_torch.ops.rays import get_ray_directions, get_rays
from mega_nerf_tpu_torch.runtime.runner import resolve_device


def get_render_octree_opts(args: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=str, required=True)
    ap.add_argument("--dataset_path", type=str, default=None)
    ap.add_argument("--split", type=str, default="val")
    ap.add_argument("--input", type=str, default=None,
                    help="render_images-style dir (poses.txt, intrinsics.txt)")
    ap.add_argument("--output", type=str, default=None)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--near", type=float, default=0.5)
    ap.add_argument("--far", type=float, default=4.0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the compositing runs ('cuda' or 'cpu'); cuda "
                         "without a card raises")
    return ap.parse_args(args)


def _views(args: argparse.Namespace):
    """(stem, metadata dict, image path or None) of each view to render."""
    from mega_nerf_tpu_torch.data.torch_io import load_pt

    views = []
    if args.dataset_path is not None:
        ds = Path(args.dataset_path)
        for p in sorted((ds / args.split / "metadata").iterdir()):
            img_path = None
            for ext in (".png", ".jpg"):
                cand = ds / args.split / "rgbs" / (p.stem + ext)
                if cand.exists():
                    img_path = cand
            views.append((p.stem, load_pt(p), img_path))
        return views
    if args.input is None:
        raise ValueError("render_octree needs --dataset_path or --input")
    inp = Path(args.input)
    poses = np.loadtxt(inp / "poses.txt").reshape(-1, 3, 4)
    intr = np.loadtxt(inp / "intrinsics.txt").reshape(-1, 6)
    for i, (c2w, (w, h, fx, fy, cx, cy)) in enumerate(zip(poses, intr)):
        md = {"W": int(w), "H": int(h),
              "intrinsics": np.array([fx, fy, cx, cy], np.float32),
              "c2w": c2w.astype(np.float32)}
        views.append((f"{i:06d}", md, None))
    return views


def main(args: argparse.Namespace) -> Dict:
    """Render every view -> the summary printed as JSON."""
    from PIL import Image

    tree = N3Tree.load(args.tree)
    print(tree)
    device = resolve_device(args.device)
    out = Path(args.output) if args.output else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)

    views = _views(args)
    metrics = {}
    for stem, md, img_path in views:
        w, h = int(md["W"]), int(md["H"])
        fx, fy, cx, cy = [float(v) for v in np.asarray(md["intrinsics"])]
        dirs = get_ray_directions(w, h, fx, fy, cx, cy, True)
        c2w = torch.from_numpy(np.asarray(md["c2w"], np.float32))
        rays = get_rays(dirs, c2w, args.near, args.far).reshape(-1, 8).numpy()
        rgb = render_octree_rays(tree, rays, steps=args.steps, device=device)["rgb"]
        rgb = rgb.reshape(h, w, 3)
        if out is not None:
            Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(
                out / f"{stem}.jpg")
        if img_path is not None:
            gt = np.asarray(Image.open(img_path), np.float32) / 255.0
            metrics[stem] = round(float(psnr(torch.from_numpy(rgb),
                                             torch.from_numpy(gt))), 3)
            print(f"{stem}: octree-render PSNR {metrics[stem]}")

    summary = {"tree": args.tree, "views": len(views)}
    if metrics:
        summary["mean_psnr"] = round(float(np.mean(list(metrics.values()))), 3)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main(get_render_octree_opts())
