"""Bake a trained model into a sparse voxel octree for the dynamic viewer.

    python -m mega_nerf_tpu_torch.scripts.create_octree --config_file ... \
        --container_path merged.pt --dataset_path <scene> --output tree.npz

Counterpart of the JAX package's `scripts/create_octree.py` (PlenOctree-
style extraction): auto-scale the bounds by probing sigma on a coarse grid,
evaluate sigma at 2^(d+1)^3 resolution, mask voxels by sigma threshold or
by the max camera-visibility weight (`octree/grid_weight.py`), refine the
tree at surviving voxels, average `samples_per_cell` model queries per leaf
(fixed +x view dir, fixed appearance index), fill internal nodes, and save
the svox-layout `.npz` (`octree/n3tree.py`).

The model is `--container_path`'s merged mixture (a container of either
package), a port `{iter}.pt`, or a JAX package `.ckpt` (`--ckpt_path`;
its weights through `runtime/checkpoints.py::load_checkpoint`); with
`--train_mega_nerf params.pt` the checkpoint holds a jointly trained
mixture (a port `{iter}.pt` of its K submodules, or the JAX package's
stacked `.ckpt`), built from the centroid metadata first. Every
probe goes through `render/rendering.py::query_points` on `--device`, the
route a rendered view takes: the eval kernel (`eval_fwd.cu`, or
`eval_wide.cu` past width 512) for the covered architectures, the eager
module otherwise. A probe call takes `_point_chunk` points and launches
the eval kernel once per submodule it runs (K, or the active count with
`--bake_cell_cull on`). Step 2's leaf samples come from
`np.random.default_rng(--random_seed)` as in the JAX script, so on the
same tree both packages query the same points.
"""

from __future__ import annotations

import time
from argparse import Namespace
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from mega_nerf_tpu_torch.data.torch_io import load_coordinates, load_pt
from mega_nerf_tpu_torch.models.factory import ModelBundle, make_nerf
from mega_nerf_tpu_torch.models.weights import strip_module_prefix
from mega_nerf_tpu_torch.octree import N3Tree, grid_weight_render_max
from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts
from mega_nerf_tpu_torch.render.cell_cull import active_cells_for_points
from mega_nerf_tpu_torch.render.rendering import RenderSettings, query_points
from mega_nerf_tpu_torch.runtime.checkpoints import load_checkpoint
from mega_nerf_tpu_torch.runtime.runner import EVAL_POINT_BUDGET, resolve_device


def _get_extraction_opts(args=None) -> Namespace:
    parser = get_opts_base()
    parser.add_argument('--dataset_path', type=str, required=True)
    parser.add_argument('--output', type=str, required=True)
    parser.add_argument('--alpha_thresh', type=float, default=0.01)
    parser.add_argument('--scale_alpha_thresh', type=float, default=0.01)
    parser.add_argument('--tree_branch_n', type=int, default=2)
    parser.add_argument('--init_grid_depth', type=int, default=8)
    parser.add_argument('--samples_per_cell', type=int, default=256)
    parser.add_argument('--masking_mode', type=str, default='weight',
                        choices=['sigma', 'weight'])
    parser.add_argument('--weight_thresh', type=float, default=0.001)
    parser.add_argument('--embedding_index', type=int, default=0)
    parser.add_argument('--camera_params', type=int, nargs='+',
                        default=[800, 800, 400, 400, 400, 400])
    return parse_opts(parser, args, known_only=True)


def _point_chunk(hparams: Namespace, bundle: ModelBundle) -> int:
    """Points per probe call: the JAX script's formula, half the eval point
    budget divided by the submodule count (at least --model_chunk_size).
    The port's mixture holds one submodule's activations at a time, so the
    division is not needed for memory; it is kept so both packages probe
    in the same calls."""
    n_sub = len(bundle.module) if bundle.is_mega else 1
    return max(hparams.model_chunk_size, EVAL_POINT_BUDGET // (2 * n_sub))


def _make_point_culler(hparams: Namespace, bundle: ModelBundle
                       ) -> Optional[Callable[[np.ndarray], Optional[List[int]]]]:
    """Exact per-call submodule culling for the probes
    (render/cell_cull.py): `active(points) -> submodule indices` (None:
    all), or None when culling does not apply. Gated by --bake_cell_cull
    (`auto` = off, as in the JAX script), not the serving --no_cell_cull."""
    if str(getattr(hparams, "bake_cell_cull", "auto")) != "on":
        return None
    k = len(bundle.module) if bundle.is_mega else 1
    if not (getattr(hparams, "cell_cull", True) and bundle.is_mega and k > 1):
        return None
    centroids = bundle.centroids.cpu().numpy().astype(np.float32)

    def active(points: np.ndarray) -> Optional[List[int]]:
        mask = active_cells_for_points(points, centroids, bundle.boundary_margin,
                                       bundle.cluster_dim_start)
        return None if mask.all() else np.flatnonzero(mask).tolist()

    return active


def _probe(bundle: ModelBundle, settings: RenderSettings, points: np.ndarray,
           device, culler, dirs=None, indices=None, sigma_only=False) -> np.ndarray:
    """One probe call: `query_points` on `points` -> numpy outputs."""
    active = None if culler is None else culler(points)
    as_t = lambda x: None if x is None else torch.from_numpy(x).to(device)  # noqa: E731
    with torch.no_grad():
        out = query_points(bundle, "fine", settings, as_t(points), as_t(dirs),
                           as_t(indices), active=active, sigma_only=sigma_only)
    return out.cpu().numpy()


def _make_sigma_fn(bundle: ModelBundle, settings: RenderSettings, chunk: int, device,
                   culler=None) -> Callable[[np.ndarray], np.ndarray]:
    """`sigma_at(points (P, 3)) -> (P,)` in probe calls of `chunk` points."""

    def sigma_at(points: np.ndarray) -> np.ndarray:
        points = np.ascontiguousarray(points, np.float32)
        return np.concatenate([
            _probe(bundle, settings, points[i:i + chunk], device, culler,
                   sigma_only=True)[:, 0]
            for i in range(0, points.shape[0], chunk)])

    return sigma_at


def _grid_points(reso: int, offset: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Cell-center world points of a reso^3 grid over the tree volume (the
    reference's meshgrid('ij') order)."""
    arr = (np.arange(reso, dtype=np.float32) + 0.5) / reso
    axes = [(arr - offset[i]) / scale[i] for i in range(3)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"))
    return g.reshape(3, -1).T


def auto_scale(hparams: Namespace, sigma_at, center, radius):
    """Shrink the box to the sigma-occupied region -> (center, radius)."""
    print("Step 0: Auto scale", flush=True)
    reso = 2 ** hparams.init_grid_depth
    radius = np.asarray(radius, np.float32)
    center = np.asarray(center, np.float32)
    scale = 0.5 / radius
    offset = 0.5 * (1.0 - center / radius)

    grid = _grid_points(reso, offset, scale)
    approx_delta = 2.0 / reso
    sigma_thresh = -np.log(1.0 - hparams.scale_alpha_thresh) / approx_delta

    sigmas = sigma_at(grid)
    occupied = grid[sigmas >= sigma_thresh]
    if occupied.shape[0] == 0:
        print("WARNING: no occupied cells during auto-scale; keeping bounds")
        return center.tolist(), radius.tolist()
    lc = occupied.min(axis=0) - 0.5 / reso
    uc = occupied.max(axis=0) + 0.5 / reso
    return ((lc + uc) * 0.5).tolist(), ((uc - lc) * 0.5).tolist()


def step1_refine(hparams: Namespace, sigma_at, tree: N3Tree, poses: np.ndarray,
                 device, times=None) -> None:
    """Grid eval, visibility mask, refinement. `times` (a dict) gets the
    seconds of the grid weights under "grid_weight"."""
    print("Step 1: Grid eval", flush=True)
    reso = 2 ** (hparams.init_grid_depth + 1)
    grid = _grid_points(reso, tree.offset, tree.invradius)

    approx_delta = 2.0 / reso
    sigma_thresh = -np.log(1.0 - hparams.alpha_thresh) / approx_delta
    sigmas = sigma_at(grid)

    if hparams.masking_mode == "sigma":
        mask = sigmas >= sigma_thresh
    elif hparams.masking_mode == "weight":
        print("Calculating grid weights", flush=True)
        t0 = time.perf_counter()
        weights = grid_weight_render_max(
            sigmas, poses, hparams.camera_params, tree.offset, tree.invradius,
            reso, device=device)
        if times is not None:
            times["grid_weight"] = time.perf_counter() - t0
        mask = weights.reshape(-1) >= hparams.weight_thresh
    else:
        raise ValueError(f"Unsupported masking mode: {hparams.masking_mode}")

    grid = grid[mask]
    print(f"Building octree over {grid.shape[0]} occupied voxels", flush=True)
    for _ in range(hparams.init_grid_depth):
        if tree.refine_at_points(grid) == 0:
            break
    print(repr(tree), flush=True)


def step2_average(hparams: Namespace, bundle: ModelBundle, settings: RenderSettings,
                  tree: N3Tree, device, culler=None) -> None:
    """Average `samples_per_cell` model queries per leaf."""
    print(f"Step 2: AA with {hparams.samples_per_cell} samples per cell", flush=True)
    rng = np.random.default_rng(hparams.random_seed)
    leaves = tree.leaf_indices()
    spc = hparams.samples_per_cell
    chunk = max(1, _point_chunk(hparams, bundle) // spc)
    cfg = bundle.config
    for i in range(0, leaves.shape[0], chunk):
        batch_leaves = leaves[i:i + chunk]
        flat = tree.sample_leaves(batch_leaves, spc, rng).reshape(-1, 3)
        dirs = None
        if cfg.pos_dir_dim > 0:
            dirs = np.zeros_like(flat)
            dirs[:, 0] = 1.0  # fixed +x view dir, as the reference bakes
        indices = None
        if cfg.appearance_dim > 0:
            indices = np.full(flat.shape[0], hparams.embedding_index, np.int64)
        out = _probe(bundle, settings, np.ascontiguousarray(flat, np.float32), device,
                     culler, dirs, indices)
        # svox / PlenOctree layout: [rgb-or-SH..., sigma], density last: the
        # model's output order, written through unchanged.
        tree.set_leaf_data(batch_leaves,
                           out.reshape(batch_leaves.shape[0], spc, -1).mean(axis=1))


def load_bake_model(hparams: Namespace, appearance_count: int, device) -> ModelBundle:
    """The fg model to bake: the container's mixture, the jointly trained
    mixture of `--train_mega_nerf`, or one NeRF, with the weights of a port
    `{iter}.pt` or a JAX `.ckpt`."""
    if getattr(hparams, "train_mega_nerf", None) is not None:
        hparams._mega_centroid_metadata = load_pt(hparams.train_mega_nerf)
    bundle = make_nerf(hparams, appearance_count)
    if getattr(hparams, "container_path", None) is None:
        loaded = load_checkpoint(hparams.ckpt_path, hparams, appearance_count)
        bundle.module.load_state_dict(strip_module_prefix(loaded["model_state_dict"]))
    bundle.to(device).module.eval()
    return bundle


def main(hparams: Namespace, times: Optional[dict] = None) -> N3Tree:
    """Bake and save the tree -> the tree. `times` (a dict) gets the seconds
    of each step ("scale", "step1", "grid_weight", "step2", "total")."""
    if hparams.ckpt_path is None and getattr(hparams, "container_path", None) is None:
        raise ValueError("create_octree needs --ckpt_path or --container_path")
    if hparams.ray_altitude_range is None:
        raise ValueError("create_octree needs --ray_altitude_range")
    times = {} if times is None else times
    t_start = time.perf_counter()
    device = resolve_device(getattr(hparams, "device", "cuda"))

    dataset_path = Path(hparams.dataset_path)
    candidates = sorted((dataset_path / "train" / "metadata").iterdir())
    train_paths = [candidates[i] for i in range(0, len(candidates), hparams.train_every)]
    metadata_paths = train_paths + list((dataset_path / "val" / "metadata").iterdir())
    poses = np.stack([np.asarray(load_pt(p)["c2w"], np.float32) for p in metadata_paths])

    bundle = load_bake_model(hparams, poses.shape[0], device)
    settings = RenderSettings.from_hparams(hparams)

    coords = load_coordinates(dataset_path)
    origin_drb = coords["origin_drb"]
    pose_scale_factor = coords["pose_scale_factor"]
    max_values = poses[:, :3, 3].max(axis=0)
    min_values = poses[:, :3, 3].min(axis=0)
    ray_altitude_range = [(x - origin_drb[0]) / pose_scale_factor
                          for x in hparams.ray_altitude_range]
    min_values[0] = ray_altitude_range[0]
    max_values[0] = ray_altitude_range[1]
    print(f"Min and Max values: {min_values} {max_values}")
    center = ((max_values + min_values) * 0.5).tolist()
    radius = ((max_values - min_values) * 0.5).tolist()
    print(f"Center and radius before autoscale: {center}, {radius}")

    culler = _make_point_culler(hparams, bundle)
    sigma_at = _make_sigma_fn(bundle, settings, _point_chunk(hparams, bundle), device,
                              culler)
    t0 = time.perf_counter()
    center, radius = auto_scale(hparams, sigma_at, center, radius)
    times["scale"] = time.perf_counter() - t0
    print(f"Center and radius after autoscale: {center}, {radius}")

    sh_deg = hparams.sh_deg if hparams.sh_deg is not None else 0
    data_dim = 1 + 3 * (sh_deg + 1) ** 2
    data_format = f"SH{(sh_deg + 1) ** 2}" if sh_deg > 0 else "RGBA"
    print(f"Data dim is {data_dim}")

    tree = N3Tree(N=hparams.tree_branch_n, data_dim=data_dim,
                  depth_limit=hparams.init_grid_depth, init_reserve=500000,
                  radius=radius, center=center, data_format=data_format)
    t0 = time.perf_counter()
    step1_refine(hparams, sigma_at, tree, poses, device, times)
    times["step1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    step2_average(hparams, bundle, settings, tree, device, culler)
    times["step2"] = time.perf_counter() - t0

    tree.shrink_to_fit()
    print("Filling in internal nodes")
    tree.fill_internal()
    print(repr(tree))
    print(f"Saving tree to: {hparams.output}")
    tree.save(hparams.output, compress=False)
    times["total"] = time.perf_counter() - t_start
    return tree


if __name__ == '__main__':
    main(_get_extraction_opts())
