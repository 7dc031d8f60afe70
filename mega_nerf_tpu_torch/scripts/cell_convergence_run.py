"""The Mega-NeRF workflow end to end: masks, every cell trained, the merge,
the merged model's eval, and optionally the bake.

    python -m mega_nerf_tpu_torch.scripts.cell_convergence_run [--grid 2 1] \
        [--steps 8000] [--bake] [--workdir .exp/cell_convergence] [--device cuda]

Counterpart of the JAX package's `scripts/cell_convergence_run.py`, and of
the reference's masks -> one job per centroid -> merge pipeline, as one
program:

  an analytic scene (`data/synthetic.py`) -> `create_cluster_masks` on
  `--grid` -> `runtime/cell_runner.py::CellRunner` (every cell's model,
  Adam and stream, one grid step at a time; per-cell `{iter}.pt` in the
  merge's layout) -> `merge_submodules` -> `Runner.eval` of the merged
  container (right-half val PSNR) -> with `--bake`, `create_octree`
  (weight mode, depth `BAKE_DEPTH`) and a two-frame `render_images`
  flythrough.

The model is the paper's (fg and bg 8x256, 48-d appearance, 256 + 512
samples, bf16 compute), `--medium` a 4x128 one, `--smoke` a tiny one for a
wiring check on the CPU. The dataset and masks are reused when the workdir
holds them; a stamp (`scene_config.json`) refuses a workdir built for
other scene flags. `--resume` restarts every cell from the newest
iteration that every cell has a `{iter}.pt` of. Writes
`{workdir}/summary.json`: the cell-parallel rays/s, the merged PSNR and,
with `--bake`, the bake's and the flythrough's seconds.
"""

from __future__ import annotations

import argparse
import json
import shutil
import time
from argparse import Namespace
from pathlib import Path
from typing import Optional, Sequence

from mega_nerf_tpu_torch.scripts.convergence_run import (
    PAPER_MODEL,
    build_masks,
    build_scene,
    latest_experiment,
)

SCENE = ["--near", "0.5", "--ray_altitude_range", "-2.0", "2.0"]
SMOKE_MODEL = [
    "--coarse_samples", "32", "--fine_samples", "64",
    "--pos_xyz_dim", "6", "--pos_dir_dim", "2",
    "--layers", "2", "--skip_layers", "1",
    "--layer_dim", "32", "--bg_layer_dim", "32",
    "--appearance_dim", "8",
]
MEDIUM_MODEL = [
    "--coarse_samples", "64", "--fine_samples", "128",
    "--pos_xyz_dim", "10", "--pos_dir_dim", "4",
    "--layers", "4", "--skip_layers", "2",
    "--layer_dim", "128", "--bg_layer_dim", "128",
    "--appearance_dim", "16",
]
BAKE_DEPTH = 6  # create_octree --init_grid_depth: a 64^3 auto-scale probe, a 128^3 grid


def get_cell_convergence_opts(argv: Optional[Sequence[str]] = None) -> Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--workdir", type=str, default=".exp/cell_convergence")
    ap.add_argument("--cell_axis", type=int, default=1,
                    help="cell groups over torchrun's ranks (1 in one process)")
    ap.add_argument("--ckpt_interval", type=int, default=0,
                    help="checkpoint every N steps (0: only at the end); a "
                         "long run should set it, so --resume can pick it up")
    ap.add_argument("--val_interval", type=int, default=0,
                    help="per-cell validation every N steps (0: never)")
    ap.add_argument("--grid", type=int, nargs=2, default=[2, 1],
                    help="cluster grid (num_cells = grid[0]*grid[1])")
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--n_train", type=int, default=28,
                    help="training images in the synthetic scene. Fine grids "
                         "need more: with a 4x2 grid, 28 ring cameras leave "
                         "each small cell so few distinct viewpoints that its "
                         "submodule overfits them and grows view-consistent "
                         "floaters that show only at held-out angles (the "
                         "reference's real scenes have 1000+ images per "
                         "8-cell split)")
    ap.add_argument("--n_val", type=int, default=2)
    ap.add_argument("--scene", type=str, default="ring", choices=["ring", "drone"],
                    help="synthetic scene: 'ring' = cameras orbiting two balls; "
                         "'drone' = a ground plane and box buildings under a "
                         "jittered oblique camera lattice, the geometry of the "
                         "reference's drone scenes (Mill 19 etc.) and the "
                         "setting for a ground-footprint cell split")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model and scene: a wiring check on the CPU")
    ap.add_argument("--distortion_loss_weight", type=float, default=0.0,
                    help="anti-floater regulariser for the per-cell training "
                         "(0 = the reference's loss)")
    ap.add_argument("--medium", action="store_true",
                    help="4x128 model, 64 + 128 samples: between --smoke and "
                         "the paper config")
    ap.add_argument("--bake", action="store_true",
                    help="also bake the merged model: create_octree and a "
                         "2-frame render_images flythrough")
    ap.add_argument("--resume", action="store_true",
                    help="resume every cell from the newest checkpoint all "
                         "cells have in the workdir (see --ckpt_interval)")
    ap.add_argument("--batch_size", type=int, default=1024,
                    help="rays a cell a step. The cells train one after "
                         "another, so the card holds one cell's activations "
                         "at a time")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where every stage runs (cuda without a card raises)")
    return ap.parse_args(argv)


def check_stamp(work: Path, stamp: dict) -> None:
    """Refuse a workdir built for other scene or grid flags: the dataset
    and masks are reused as they are, so new flags would be ignored."""
    stamp_path = work / "scene_config.json"
    if not stamp_path.exists():
        stamp_path.write_text(json.dumps(stamp))
        return
    old = json.loads(stamp_path.read_text())
    # A key missing from an older stamp held that version's default: only
    # a present and different value is a change.
    if any(old.get(k, v) != v for k, v in stamp.items()):
        raise SystemExit(
            f"workdir {work} was built with {old}, now asked for {stamp}: pass a "
            "fresh --workdir (its artifacts are reused as they are, so the new "
            "flags would be ignored)")


def common_checkpoint(work: Path, num_cells: int):
    """(version, iteration) of the newest `{iter}.pt` that every cell has,
    or None."""
    per_cell = []
    for cell in range(num_cells):
        cell_dir = work / f"sub{cell}"
        per_cell.append({
            (int(v.name), int(p.stem))
            for v in cell_dir.iterdir() if v.name.isdigit()
            for p in (v / "models").glob("*.pt") if p.stem.isdigit()
        } if cell_dir.exists() else set())
    common = set.intersection(*per_cell) if per_cell else set()
    return max(common, key=lambda vi: (vi[1], vi[0])) if common else None


def bake(work: Path, ds: Path, masks: Path, merged: Path, model_args, device) -> dict:
    """`create_octree` of the merged model, then two frames of
    `render_images` from the first train view -> the bake's summary keys."""
    import numpy as np

    from mega_nerf_tpu_torch.data.torch_io import load_pt
    from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts
    from mega_nerf_tpu_torch.scripts import create_octree as co
    from mega_nerf_tpu_torch.scripts import render_images as ri

    out = {}
    meta = load_pt(ds / "train" / "metadata" / "000000.pt")
    fx, fy, cx, cy = [float(v) for v in np.asarray(meta["intrinsics"])]
    w, h = int(meta["W"]), int(meta["H"])

    t0 = time.perf_counter()
    ohp = parse_opts(get_opts_base(), SCENE + model_args + [
        "--container_path", str(merged), "--device", device])
    ohp.dataset_path = str(ds)
    ohp.output = str(work / "octree.npz")
    ohp.alpha_thresh = 0.01
    ohp.scale_alpha_thresh = 0.01
    ohp.tree_branch_n = 2
    ohp.init_grid_depth = BAKE_DEPTH
    ohp.samples_per_cell = 64
    # Weight mode: the visibility pass (`octree/grid_weight.py`) culls
    # voxels no camera sees.
    ohp.masking_mode = "weight"
    ohp.weight_thresh = 0.001
    ohp.embedding_index = 0
    # Floats: truncating the principal point moves projected rays by up to
    # a pixel and mis-culls border voxels in the visibility pass.
    ohp.camera_params = [float(w), float(h), fx, fy, cx, cy]
    co.main(ohp)
    out["octree_seconds"] = round(time.perf_counter() - t0, 1)

    t0 = time.perf_counter()
    fly = work / "flythrough"
    fly.mkdir(exist_ok=True)
    c2w = np.asarray(meta["c2w"]).reshape(-1)
    fly.joinpath("poses.txt").write_text(
        "\n".join(" ".join(str(v) for v in c2w) for _ in range(2)) + "\n")
    fly.joinpath("intrinsics.txt").write_text(f"{w} {h} {fx} {fy} {cx} {cy}\n" * 2)
    fly.joinpath("embeddings.txt").write_text("0\n1\n")
    rhp = parse_opts(get_opts_base(), SCENE + model_args + [
        "--container_path", str(merged), "--val_scale_factor", "1",
        "--compute_dtype", "bfloat16", "--device", device])
    rhp.input = str(fly)
    rhp.output = str(work / "frames")
    rhp.dataset_path = str(ds)
    rhp.centroids_path = str(masks / "params.pt")
    rhp.save_depth_npz = False
    rhp.resume = False
    shutil.rmtree(rhp.output, ignore_errors=True)  # a rerun renders the frames again
    ri.main(rhp)
    out["flythrough_seconds"] = round(time.perf_counter() - t0, 1)
    out["flythrough_frames"] = len(list((work / "frames" / "rgbs").glob("*.jpg")))
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the workflow -> the summary (also written to summary.json)."""
    args = get_cell_convergence_opts(argv)
    model_args = list(PAPER_MODEL)
    if args.smoke:
        args.hw = 24
        # A 24x24 scene split into many cells leaves border cells a few
        # hundred masked rays: the paper batch would starve them.
        args.batch_size = min(args.batch_size, 64)
        model_args = list(SMOKE_MODEL)
    elif args.medium:
        model_args = list(MEDIUM_MODEL)

    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    check_stamp(work, {"grid": list(args.grid), "hw": args.hw, "smoke": bool(args.smoke),
                       "n_train": args.n_train, "n_val": args.n_val,
                       "scene": args.scene, "medium": bool(args.medium)})

    ds, masks = work / "ds", work / "masks"
    build_scene(ds, args.scene, args.n_train, args.n_val, args.hw, args.device)
    build_masks(ds, masks, args.grid, args.device)

    from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts
    from mega_nerf_tpu_torch.runtime.cell_runner import CellRunner
    from mega_nerf_tpu_torch.runtime.runner import Runner
    from mega_nerf_tpu_torch.scripts import merge_submodules as ms

    device = ["--device", args.device]
    parser = get_opts_base()
    parser.add_argument("--exp_name", type=str, default=str(work / "sub"))
    parser.add_argument("--dataset_path", type=str, default=str(ds))
    hp = parse_opts(parser, [
        "--cluster_mask_path", str(masks),
        "--cell_axis", str(args.cell_axis),
        "--chunk_paths", str(work / "chunks"),
        "--num_chunks", "8",
        *SCENE, *model_args,
        "--distortion_loss_weight", str(args.distortion_loss_weight),
        "--batch_size", str(args.batch_size),
        "--lr", "5e-4", "--lr_decay_factor", "0.1",
        "--train_iterations", str(args.steps),
        "--ckpt_interval", str(args.ckpt_interval or args.steps),
        "--val_interval", str(args.val_interval or 10 * args.steps),
        "--val_scale_factor", "1",
        "--compute_dtype", "bfloat16",
        *device,
    ])

    resume_from = 0
    if args.resume:
        found = common_checkpoint(work, args.grid[0] * args.grid[1])
        if found:
            version, it = found
            # Any one cell's file resumes them all (CellRunner._restore_cells).
            hp.ckpt_path = str(work / "sub0" / str(version) / "models" / f"{it}.pt")
            resume_from = it
            print(f"resuming all cells from iteration {it} (version {version})", flush=True)
        else:
            print("no common per-cell checkpoint found; training from scratch", flush=True)

    t0 = time.perf_counter()
    runner = CellRunner(hp)
    num_cells = runner.num_cells
    runner.train()
    train_wall = time.perf_counter() - t0

    merged = work / "merged.pt"
    mhp = parse_opts(get_opts_base(), SCENE + model_args + [
        "--train_iterations", str(args.steps)])
    mhp.ckpt_prefix = str(work / "sub")
    mhp.centroid_path = str(masks / "params.pt")
    mhp.output = str(merged)
    mhp.torchscript = False
    ms.main(mhp)

    eparser = get_opts_base()
    eparser.add_argument("--exp_name", type=str, default=str(work / "eval"))
    eparser.add_argument("--dataset_path", type=str, default=str(ds))
    ehp = parse_opts(eparser, [
        "--container_path", str(merged), *SCENE, *model_args,
        "--val_scale_factor", "1", "--compute_dtype", "bfloat16", *device,
    ])
    Runner(ehp).eval()
    metrics = (latest_experiment(ehp.exp_name) / "metrics.txt").read_text()
    psnr = float([line for line in metrics.splitlines()
                  if "val/psnr" in line][0].split(":")[-1])

    baked = bake(work, ds, masks, merged, model_args, args.device) if args.bake else {}

    trained_steps = args.steps - resume_from
    summary = {
        "steps": args.steps,
        "num_cells": num_cells,
        "cell_axis": args.cell_axis,
        "train_wall_seconds": round(train_wall, 1),
        "cell_parallel_rays_per_sec": round(
            trained_steps * hp.batch_size * num_cells / train_wall, 1
        ) if trained_steps > 0 else 0.0,
        "merged_val_psnr": round(psnr, 3),
        **baked,
    }
    if resume_from:
        summary["resumed_from_iteration"] = resume_from
    with open(work / "summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
