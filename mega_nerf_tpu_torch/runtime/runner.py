"""The orchestrator: the JAX package's `Runner` for one process.

- scene space (`coordinates.pt`, near/far, altitude range) and the
  foreground ellipsoid fitted over the cameras and their copies pinned to
  the altitude bounds;
- the metadata scan (val images join the train set; appearance indices
  follow the sorted file names);
- `train` runs the epoch loop over the in-memory dataset (a fresh
  shuffle per epoch from `np.random.default_rng((seed, epoch))`), one
  `TrainStep` per batch, a non-finite check and throughput every 100 steps,
  `{iter}.pt` checkpoints at `--ckpt_interval` and at the end,
  `--val_interval` validation, and the final validation plus `metrics.txt`
  without a cluster mask; `--ckpt_path` resumes weights, Adam states and
  the iteration count;
- `make_eval_state` loads a reference-format `{iter}.pt` (--ckpt_path);
- `render_image` renders a whole view in chunks bounded by an 8M-point
  budget per MLP pass;
- `_run_validation` scores PSNR/SSIM on the right half of each val view
  (the half excluded from training) and writes gt | pred | depth panels.

Everything runs on `--device` (default cuda). Asking for cuda without a
card raises; nothing falls back to the CPU. Not ported yet: the filesystem
dataset, mid-epoch resume of the batch stream, LPIPS, TensorBoard logging,
profiler hooks, occupancy bounds, culling, routing, mixtures and
multi-process training and validation.
"""

from __future__ import annotations

import sys
import time
from argparse import Namespace
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mega_nerf_tpu_torch.data.image_metadata import ImageMetadata
from mega_nerf_tpu_torch.data.torch_io import load_coordinates, load_pt
from mega_nerf_tpu_torch.data.memory_dataset import MemoryDataset
from mega_nerf_tpu_torch.models.factory import ModelBundle, make_bg_nerf, make_nerf
from mega_nerf_tpu_torch.models.nerf import init_weights
from mega_nerf_tpu_torch.models.weights import strip_module_prefix
from mega_nerf_tpu_torch.ops.metrics import psnr as psnr_metric
from mega_nerf_tpu_torch.ops.metrics import ssim as ssim_metric
from mega_nerf_tpu_torch.ops.rays import generate_image_rays
from mega_nerf_tpu_torch.parallel.train_step import TrainStep
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays
from mega_nerf_tpu_torch.runtime import checkpoints

METRICS_CHECK_INTERVAL = 100  # steps between non-finite checks

# Point budget of one MLP pass during eval: 8M points at fine_samples=512
# gives 16,384-ray chunks, the JAX package's eval chunk.
EVAL_POINT_BUDGET = 8 * 1024 * 1024

# Inferno colormap control points (position, r, g, b) for depth panels.
_INFERNO = np.array([
    [0.000, 0.001, 0.000, 0.014],
    [0.125, 0.087, 0.045, 0.225],
    [0.250, 0.258, 0.039, 0.406],
    [0.375, 0.416, 0.090, 0.433],
    [0.500, 0.578, 0.148, 0.404],
    [0.625, 0.736, 0.216, 0.330],
    [0.750, 0.865, 0.317, 0.226],
    [0.875, 0.955, 0.469, 0.100],
    [1.000, 0.988, 0.998, 0.645],
], np.float32)


def _eval_chunk_cap(hparams: Namespace) -> int:
    """Max rays per render call that keeps each MLP pass in budget."""
    s_max = max(hparams.coarse_samples, hparams.fine_samples, 1)
    return max(1, EVAL_POINT_BUDGET // s_max)


def resolve_device(name: str) -> torch.device:
    """`--device` -> torch.device; cuda without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda was asked for but no CUDA device is available "
            "(pass --device cpu to run on the CPU)"
        )
    return device


class Runner:
    def __init__(self, hparams: Namespace, set_experiment_path: bool = True):
        self.hparams = hparams
        self.device = resolve_device(getattr(hparams, "device", "cuda"))

        self.experiment_path = (
            self._get_experiment_path() if set_experiment_path else None
        )

        coords = load_coordinates(hparams.dataset_path)
        self.origin_drb = coords["origin_drb"]
        self.pose_scale_factor = coords["pose_scale_factor"]
        print(f"Origin: {self.origin_drb}, scale factor: {self.pose_scale_factor}")

        self.near = hparams.near / self.pose_scale_factor
        if hparams.far is not None:
            self.far = hparams.far / self.pose_scale_factor
        elif hparams.bg_nerf:
            self.far = 1e5
        else:
            self.far = 2.0
        print(f"Ray bounds: {self.near}, {self.far}")

        if hparams.ray_altitude_range is not None:
            self.ray_altitude_range = [
                (x - self.origin_drb[0]) / self.pose_scale_factor
                for x in hparams.ray_altitude_range
            ]
            assert self.ray_altitude_range[0] < self.ray_altitude_range[1]
        else:
            self.ray_altitude_range = None

        self.train_items, self.val_items = self._get_image_metadata()
        print(f"Using {len(self.train_items)} train images and "
              f"{len(self.val_items)} val images")

        camera_positions = np.stack(
            [x.c2w[:3, 3] for x in self.train_items + self.val_items]
        )
        min_position = camera_positions.min(axis=0)
        max_position = camera_positions.max(axis=0)

        self.fg = make_nerf(hparams, len(self.train_items))
        self.bg: Optional[ModelBundle] = None
        self.sphere_center = None
        self.sphere_radius = None
        if hparams.bg_nerf:
            self.bg = make_bg_nerf(hparams, len(self.train_items))
            if hparams.ellipse_bounds:
                # Ellipsoid fitted over cameras + their copies pinned to the
                # altitude bounds.
                if self.ray_altitude_range is None:
                    raise ValueError("ellipse bounds need --ray_altitude_range")
                ground = camera_positions.copy()
                ground[:, 0] = self.ray_altitude_range[1]
                air = camera_positions.copy()
                air[:, 0] = self.ray_altitude_range[0]
                used = np.concatenate([camera_positions, air, ground])

                max_position = max_position.copy()
                max_position[0] = self.ray_altitude_range[1]

                center = (max_position + min_position) * 0.5
                radius = (max_position - min_position) * 0.5
                scale = np.linalg.norm((used - center) / radius, axis=-1).max()
                radius = radius * scale * hparams.ellipse_scale_factor
                self.sphere_center = torch.as_tensor(
                    center, dtype=torch.float32, device=self.device)
                self.sphere_radius = torch.as_tensor(
                    radius, dtype=torch.float32, device=self.device)
            print(f"Sphere center: {self.sphere_center}, radius: {self.sphere_radius}")

        for b in (self.fg, self.bg):
            if b is not None:
                b.module.to(self.device).eval()

    # ----------------------------------------------------------------- train

    def train(self) -> Dict[str, float]:
        """Train; returns the final validation metrics ({} with a cluster
        mask)."""
        hp = self.hparams
        self._setup_experiment_dir()
        init_weights(self.fg.module, torch.Generator().manual_seed(hp.random_seed))
        if self.bg is not None:
            init_weights(self.bg.module,
                         torch.Generator().manual_seed(hp.random_seed + 1))
        step = TrainStep(
            self.fg, self.bg, RenderSettings.from_hparams(hp), hp.lr,
            hp.lr_decay_factor, hp.train_iterations, self.sphere_center,
            self.sphere_radius, use_appearance=hp.appearance_dim > 0)
        train_iterations = 0
        if hp.ckpt_path is not None:
            loaded = self._load_weights(hp.ckpt_path)
            step.load_optimizer_states(loaded.get("optimizers", {}))
            train_iterations = int(loaded.get("iteration", 0))
            print(f"Resumed from {hp.ckpt_path} at iteration {train_iterations}")
        self.train_step = step

        dataset = self._make_dataset()
        generator = torch.Generator(device=self.device).manual_seed(hp.random_seed)
        epoch = 0
        t0, step0 = time.perf_counter(), train_iterations
        while train_iterations < hp.train_iterations:
            epoch_rng = np.random.default_rng((hp.random_seed, epoch))
            for host_batch in dataset.batches(hp.batch_size, epoch_rng):
                batch = {
                    "rgbs": torch.from_numpy(host_batch["rgbs"]),
                    "rays": torch.from_numpy(host_batch["rays"]),
                    "img_indices": torch.from_numpy(
                        host_batch["img_indices"]).long(),
                }
                batch = {k: v.to(self.device, non_blocking=True)
                         for k, v in batch.items()}
                metrics = step(batch, generator)
                train_iterations += 1

                if (train_iterations % METRICS_CHECK_INTERVAL == 0
                        or train_iterations >= hp.train_iterations):
                    host = {k: float(v) for k, v in metrics.items()}
                    self.check_finite(host)
                    now = time.perf_counter()
                    rate = (train_iterations - step0) * hp.batch_size / (now - t0)
                    t0, step0 = now, train_iterations
                    print(f"step {train_iterations}: "
                          + " ".join(f"{k}={v:.5g}" for k, v in host.items())
                          + f" rays/s={rate:.1f}", flush=True)

                if train_iterations % hp.ckpt_interval == 0:
                    self._save_checkpoint(train_iterations)
                if train_iterations % hp.val_interval == 0:
                    self._run_validation(train_iterations)
                    t0, step0 = time.perf_counter(), train_iterations
                if train_iterations >= hp.train_iterations:
                    break
            else:
                epoch += 1
                continue
            break

        self._save_checkpoint(train_iterations)
        val_metrics: Dict[str, float] = {}
        if hp.cluster_mask_path is None:
            val_metrics = self._run_validation(train_iterations)
            self._write_final_metrics(val_metrics)
        return val_metrics

    @staticmethod
    def check_finite(metrics: Dict[str, float]) -> None:
        """psnr may be +/-inf (a perfectly fit batch), never NaN; every
        other metric must be finite."""
        for k, v in metrics.items():
            if not (np.isfinite(v) or (k == "psnr" and np.isinf(v))):
                raise RuntimeError(f"Train metrics not finite in {k}: {v}")

    def _make_dataset(self) -> MemoryDataset:
        hp = self.hparams
        if hp.dataset_type != "memory":
            raise NotImplementedError(
                f"--dataset_type {hp.dataset_type} is not ported yet "
                "(ROADMAP.md A.6); use --dataset_type memory")
        return MemoryDataset(
            self.train_items, self.near, self.far, self.ray_altitude_range,
            hp.center_pixels, np.random.default_rng(hp.random_seed),
        )

    def _save_checkpoint(self, iteration: int) -> None:
        if self.experiment_path is None:
            return
        checkpoints.save_checkpoint(
            self.experiment_path / "models" / f"{iteration}.pt",
            self.fg.module, None if self.bg is None else self.bg.module,
            self.train_step.optimizer_states(), iteration)

    # ------------------------------------------------------------------ eval

    def eval(self) -> Dict[str, float]:
        self._setup_experiment_dir()
        self.make_eval_state()
        val_metrics = self._run_validation(0)
        self._write_final_metrics(val_metrics)
        return val_metrics

    def make_eval_state(self) -> None:
        """Load the weights of --ckpt_path (a reference `{iter}.pt`) into
        the fg/bg modules. A shape mismatch raises."""
        hp = self.hparams
        if hp.ckpt_path is None:
            raise ValueError("eval needs --ckpt_path")
        loaded = self._load_weights(hp.ckpt_path)
        print(f"Loaded {hp.ckpt_path} (iteration {loaded.get('iteration', 0)})")

    def _load_weights(self, path) -> Dict:
        """Load a `{iter}.pt`'s weights into the modules -> the whole dict."""
        loaded = checkpoints.load_checkpoint(path)
        self.fg.module.load_state_dict(
            strip_module_prefix(loaded["model_state_dict"]))
        if self.bg is not None:
            if "bg_model_state_dict" not in loaded:
                raise ValueError(f"{path} has no bg_model_state_dict")
            self.bg.module.load_state_dict(
                strip_module_prefix(loaded["bg_model_state_dict"]))
        return loaded

    # ------------------------------------------------------------ validation

    def _run_validation(self, train_index: int) -> Dict[str, float]:
        """Render + score every val image -> per-image AVERAGES."""
        sums: Dict[str, float] = {}
        img_dir = None
        if self.experiment_path is not None:
            img_dir = self.experiment_path / "val_images" / str(train_index)
            img_dir.mkdir(parents=True, exist_ok=True)

        for i, metadata in enumerate(self.val_items):
            viz_rgbs = metadata.load_image().astype(np.float32) / 255.0
            results = self.render_image(metadata)
            typ = "fine" if "rgb_fine" in results else "coarse"
            pred = results[f"rgb_{typ}"].reshape(viz_rgbs.shape)

            half = viz_rgbs.shape[1] // 2
            eval_gt = torch.from_numpy(np.ascontiguousarray(viz_rgbs[:, half:]))
            eval_pred = torch.from_numpy(np.ascontiguousarray(pred[:, half:]))
            per_image = {
                "val/psnr": float(psnr_metric(eval_pred, eval_gt)),
                "val/ssim": float(ssim_metric(eval_pred, eval_gt, 1.0)),
            }
            for key, value in per_image.items():
                sums[key] = sums.get(key, 0.0) + value

            depth = results[f"depth_{typ}"].reshape(viz_rgbs.shape[:2])
            if f"fg_depth_{typ}" in results:
                ma = np.quantile(results[f"fg_depth_{typ}"].reshape(-1), 0.95)
                depth = np.clip(depth, None, ma)
            if img_dir is not None:
                from PIL import Image

                panel = self._create_result_image(viz_rgbs, pred, depth)
                Image.fromarray(panel).save(img_dir / f"{i}.jpg")
        return {k: v / len(self.val_items) for k, v in sums.items()}

    def _write_final_metrics(self, val_metrics: Dict[str, float]) -> None:
        if self.experiment_path is not None:
            with (self.experiment_path / "metrics.txt").open("w") as f:
                for key, avg in val_metrics.items():
                    message = f"Average {key}: {avg}"
                    print(message)
                    f.write(message + "\n")

    # ---------------------------------------------------------------- render

    def render_settings(self) -> RenderSettings:
        return RenderSettings.from_hparams(
            self.hparams, get_depth=True, get_bg_fg_rgb=True
        )

    def render_image(self, metadata: ImageMetadata) -> Dict[str, np.ndarray]:
        """Render a full image in chunks (the last one shorter) -> numpy
        arrays of H*W rows."""
        hp = self.hparams
        rays = generate_image_rays(
            metadata, self.near, self.far, self.ray_altitude_range,
            hp.center_pixels, device=self.device,
        )
        n = rays.shape[0]
        chunk = min(hp.image_pixel_batch_size, n, _eval_chunk_cap(hp))
        settings = self.render_settings()
        results: Dict[str, List[torch.Tensor]] = {}
        for start in range(0, n, chunk):
            chunk_rays = rays[start:start + chunk]
            image_indices = None
            if hp.appearance_dim > 0:
                image_indices = torch.full(
                    (chunk_rays.shape[0],), metadata.image_index,
                    dtype=torch.long, device=self.device,
                )
            with torch.no_grad():
                out, _ = render_rays(
                    self.fg, self.bg, chunk_rays, image_indices,
                    settings, self.sphere_center, self.sphere_radius,
                )
            for k, v in out.items():
                results.setdefault(k, []).append(v.cpu())
        return {k: torch.cat(v).numpy() for k, v in results.items()}

    # ------------------------------------------------------------------- viz

    @staticmethod
    def _create_result_image(rgbs: np.ndarray, result_rgbs: np.ndarray,
                             result_depths: np.ndarray) -> np.ndarray:
        """gt | prediction | log-depth panel."""
        depth_vis = Runner.visualize_scalars(np.log(result_depths + 1e-8))
        images = (rgbs * 255, result_rgbs * 255, depth_vis)
        return np.concatenate(images, axis=1).astype(np.uint8)

    @staticmethod
    def visualize_scalars(scalar_tensor: np.ndarray) -> np.ndarray:
        """Quantile-normalized inverse inferno colormap -> uint8 RGB."""
        to_use = scalar_tensor.reshape(-1)
        mi = np.quantile(to_use, 0.05)
        ma = np.quantile(to_use, 0.95)
        x = np.clip((scalar_tensor - mi) / max(ma - mi, 1e-8), 0, 1)
        v = 1 - x
        rgb = np.stack(
            [np.interp(v, _INFERNO[:, 0], _INFERNO[:, c]) for c in (1, 2, 3)],
            axis=-1,
        )
        return (rgb * 255).astype(np.uint8)

    # ----------------------------------------------------------------- setup

    def _setup_experiment_dir(self) -> None:
        if self.experiment_path is None:
            return
        self.experiment_path.mkdir(parents=True)
        (self.experiment_path / "models").mkdir()
        with (self.experiment_path / "hparams.txt").open("w") as f:
            for key, val in vars(self.hparams).items():
                f.write(f"{key}: {val}\n")
        with (self.experiment_path / "command.txt").open("w") as f:
            f.write(" ".join(sys.argv) + "\n")
        with (self.experiment_path / "image_indices.txt").open("w") as f:
            for item in self.train_items:
                f.write(f"{item.image_index},{item.image_path.name}\n")

    def _get_image_metadata(self) -> Tuple[List[ImageMetadata], List[ImageMetadata]]:
        """Scan metadata dirs; val images join the train set."""
        hp = self.hparams
        dataset_path = Path(hp.dataset_path)

        train_candidates = sorted((dataset_path / "train" / "metadata").iterdir())
        train_paths = [
            train_candidates[i]
            for i in range(0, len(train_candidates), hp.train_every)
        ]
        val_paths = sorted((dataset_path / "val" / "metadata").iterdir())
        train_paths += val_paths
        train_paths.sort(key=lambda x: x.name)
        val_set = set(val_paths)

        image_indices = {p.name: i for i, p in enumerate(train_paths)}
        train_items = [
            self._get_metadata_item(
                p, image_indices[p.name], hp.train_scale_factor, p in val_set
            )
            for p in train_paths
        ]
        val_items = [
            self._get_metadata_item(
                p, image_indices[p.name], hp.val_scale_factor, True
            )
            for p in val_paths
        ]
        return train_items, val_items

    def _get_metadata_item(self, metadata_path: Path, image_index: int,
                           scale_factor: int, is_val: bool) -> ImageMetadata:
        image_path = None
        for ext in (".jpg", ".JPG", ".png", ".PNG"):
            candidate = (
                metadata_path.parent.parent / "rgbs" / f"{metadata_path.stem}{ext}"
            )
            if candidate.exists():
                image_path = candidate
                break
        if image_path is None:
            raise FileNotFoundError(f"no image for {metadata_path}")

        metadata = load_pt(metadata_path)
        intrinsics = np.asarray(metadata["intrinsics"]) / scale_factor
        assert metadata["W"] % scale_factor == 0
        assert metadata["H"] % scale_factor == 0

        dataset_mask = metadata_path.parent.parent.parent / "masks" / metadata_path.name
        if self.hparams.cluster_mask_path is not None:
            mask_path = Path(self.hparams.cluster_mask_path) / metadata_path.name
        elif dataset_mask.exists():
            mask_path = dataset_mask
        else:
            mask_path = None

        return ImageMetadata(
            image_path,
            np.asarray(metadata["c2w"]),
            int(metadata["W"]) // scale_factor,
            int(metadata["H"]) // scale_factor,
            intrinsics,
            image_index,
            None if (is_val and self.hparams.all_val) else mask_path,
            is_val,
        )

    def _get_experiment_path(self) -> Path:
        exp_dir = Path(self.hparams.exp_name)
        exp_dir.mkdir(parents=True, exist_ok=True)
        existing = [int(x.name) for x in exp_dir.iterdir() if x.name.isdigit()]
        version = 0 if not existing else max(existing) + 1
        return exp_dir / str(version)
