"""A long training run through the whole pipeline, at the paper's model.

    python -m mega_nerf_tpu_torch.scripts.convergence_run [--steps 20000] \
        [--workdir .exp/convergence] [--scene ring|drone] [--device cuda]

Counterpart of the JAX package's `scripts/convergence_run.py`. It trains
the reference's production recipe (`PAPER_ARGS`: an 8x256 MLP, 256 coarse
+ 512 fine samples, a NeRF++ background, 48-d appearance embeddings, 1024
rays a step) on an analytic scene (`data/synthetic.py`), through every
stage a user runs: the dataset in the reference layout, cluster masks on a
2x1 grid (`scripts/create_cluster_masks.py`), the parquet chunk store, then
masked training of cell 0 with right-half val PSNR every
`--val_interval` steps. The dataset and the masks are reused when the
workdir holds them.

Writes `{workdir}/summary.json`: the val PSNR curve (the mean over the val
views at each validation step), the median of the run's
`train/rays_per_sec` samples and the wall time; the raw curves stay in the
experiment's `tb/metrics.jsonl`.
"""

from __future__ import annotations

import argparse
import json
import time
from argparse import Namespace
from pathlib import Path
from typing import Optional, Sequence

# The paper's model (the reference's `mega_nerf/opts.py` defaults) and,
# in PAPER_ARGS, its batch; `main(model_args=...)` replaces PAPER_ARGS,
# e.g. at a tiny width.
PAPER_MODEL = [
    "--coarse_samples", "256", "--fine_samples", "512",
    "--pos_xyz_dim", "12", "--pos_dir_dim", "4",
    "--layers", "8", "--skip_layers", "4",
    "--layer_dim", "256", "--bg_layer_dim", "256",
    "--appearance_dim", "48",
]
PAPER_ARGS = PAPER_MODEL + ["--batch_size", "1024"]
MASK_GRID = [2, 1]  # this run trains cell 0 of it


def get_convergence_opts(argv: Optional[Sequence[str]] = None) -> Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--workdir", type=str, default=".exp/convergence")
    ap.add_argument("--val_interval", type=int, default=2500)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--n_train", type=int, default=28)
    ap.add_argument("--scene", type=str, default="ring", choices=["ring", "drone"])
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the scene is rendered, the masks made and the "
                         "model trained (cuda without a card raises)")
    return ap.parse_args(argv)


def build_scene(ds: Path, scene: str, n_train: int, n_val: int, hw: int, device) -> None:
    """The analytic scene's dataset, unless `ds` holds a built one."""
    from mega_nerf_tpu_torch.data.synthetic import make_drone_dataset, make_synthetic_dataset

    if (ds / "coordinates.pt").exists():
        return
    print("building synthetic dataset...", flush=True)
    maker = make_drone_dataset if scene == "drone" else make_synthetic_dataset
    maker(ds, n_train=n_train, n_val=n_val, hw=(hw, hw), device=device)


def build_masks(ds: Path, masks: Path, grid: Sequence[int], device) -> None:
    """Cluster masks of the scene on `grid`, unless `masks` holds them."""
    from mega_nerf_tpu_torch.scripts import create_cluster_masks as ccm

    if (masks / "params.pt").exists():
        return
    print("creating cluster masks...", flush=True)
    ccm.main(Namespace(
        dataset_path=str(ds), segmentation_path=None, output=str(masks),
        grid_dim=list(grid), ray_samples=256, ray_chunk_size=48 * 1024,
        resume=False, ray_altitude_range=[-2.0, 2.0], near=0.5, far=3.5,
        center_pixels=True, cluster_2d=False, boundary_margin=1.15, device=device,
    ))


def latest_experiment(exp_name) -> Path:
    """The newest version directory of an experiment."""
    return sorted((p for p in Path(exp_name).iterdir() if p.name.isdigit()),
                  key=lambda p: int(p.name))[-1]


def summarize(exp: Path):
    """(val PSNR curve [(step, mean over the val views)], median
    `train/rays_per_sec` or None) from an experiment's `metrics.jsonl`.
    Validation writes one `val/psnr/{i}` scalar per view."""
    by_step, rays_per_sec = {}, []
    with open(exp / "tb" / "metrics.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            for k, v in rec.items():
                if k.startswith("val/psnr"):
                    by_step.setdefault(rec["step"], []).append(v)
                elif k == "train/rays_per_sec":
                    rays_per_sec.append(v)
    curve = sorted((s, sum(v) / len(v)) for s, v in by_step.items())
    median = sorted(rays_per_sec)[len(rays_per_sec) // 2] if rays_per_sec else None
    return curve, median


def main(argv: Optional[Sequence[str]] = None,
         model_args: Optional[Sequence[str]] = None) -> dict:
    """Run the pipeline -> the summary (also written to summary.json)."""
    args = get_convergence_opts(argv)
    model_args = list(PAPER_ARGS if model_args is None else model_args)
    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)

    ds, masks = work / "ds", work / "masks"
    build_scene(ds, args.scene, args.n_train, 2, args.hw, args.device)
    build_masks(ds, masks, MASK_GRID, args.device)

    from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts
    from mega_nerf_tpu_torch.runtime.runner import Runner

    parser = get_opts_base()
    parser.add_argument("--exp_name", type=str, default=str(work / "sub0"))
    parser.add_argument("--dataset_path", type=str, default=str(ds))
    hp = parse_opts(parser, [
        "--dataset_type", "filesystem",
        "--chunk_paths", str(work / "chunks0"),
        "--num_chunks", "8",
        "--cluster_mask_path", str(masks / "0"),
        "--near", "0.5",
        "--ray_altitude_range", "-2.0", "2.0",
        *model_args,
        "--lr", "5e-4", "--lr_decay_factor", "0.1",
        "--train_iterations", str(args.steps),
        "--ckpt_interval", str(args.steps),
        "--val_interval", str(args.val_interval),
        "--val_scale_factor", "1",
        "--compute_dtype", "bfloat16",
        "--device", args.device,
    ])

    t0 = time.perf_counter()
    Runner(hp).train()
    wall = time.perf_counter() - t0

    exp = latest_experiment(hp.exp_name)
    curve, sustained = summarize(exp)
    summary = {
        "steps": args.steps,
        "wall_seconds": round(wall, 1),
        "val_psnr_curve": [(s, round(p, 3)) for s, p in curve],
        "median_sustained_rays_per_sec": round(sustained, 1) if sustained else None,
        "experiment": str(exp),
    }
    with open(work / "summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
