"""The orchestrator: the JAX package's `Runner`.

- scene space (`coordinates.pt`, near/far, altitude range) and the
  foreground ellipsoid fitted over the cameras and their copies pinned to
  the altitude bounds;
- the metadata scan (val images join the train set; appearance indices
  follow the sorted file names);
- `train` runs the epoch loop over the in-memory dataset or the parquet
  chunk store (`--dataset_type memory|filesystem`; one chunk per epoch),
  a fresh shuffle per epoch from `np.random.default_rng((seed, epoch))`,
  one `TrainStep` per batch; `TrainLoopHooks` give the non-finite check
  and throughput every 100 steps and the `--profile_steps` torch.profiler
  window; `{iter}.pt` checkpoints at `--ckpt_interval` and at the end,
  `--val_interval` validation, and the final validation plus `metrics.txt`
  without a cluster mask; scalars and result panels go to `<exp>/tb`
  (`metrics.jsonl`, and TensorBoard when it imports);
- `--ckpt_path` resumes weights, Adam states and the iteration count, and
  with `--resume_ckpt_state` (the default) also the batch stream (epoch and
  the batch of it last consumed, which the resumed epoch skips) and the
  sample generator, so a resumed run continues exactly as the uninterrupted
  one; `--no_resume_ckpt_state` restarts the stream. The path may be a
  reference-format `{iter}.pt` or the JAX package's `{iter}.ckpt`
  (`runtime/checkpoints.py::read_jax_train_state`: weights, optax Adam
  state, iteration and stream position; it holds no torch generator
  state, so the sample generator starts from the seed, as in a fresh run);
- `make_eval_state` loads the weights of --ckpt_path (either format; no
  Adam state is needed); checkpoints carry each module's state dict as it
  is, so a cascade's hold the reference's `coarse.*` / `fine.*` keys and a
  mixture's its submodules' under `0.`, `1.`, .... With --container_path
  the fg and bg models are the merged container's mixtures, which hold
  their weights already (a container without bg submodules gets no bg
  model);
- `--train_mega_nerf params.pt` (a `create_cluster_masks` centroid file)
  makes fg and bg mixtures of K NeRFs with hard assignment, trained
  jointly under one Adam per side (each submodule through the training
  kernels on the points assigned to it) and served by `--mega_routing`;
- `render_image` renders a whole view in chunks bounded by an 8M-point
  budget per MLP pass (under the cascade the fine pass has coarse + fine
  points a ray), with occupancy-tightened fg intervals
  (--occupancy_path, `render/ray_bounds.py`) and, for a fg mixture,
  exact per-chunk cell culling (on unless --no_cell_cull,
  `render/cell_cull.py`) or, with `--mega_routing ray`, per-ray routing
  behind the JAX Runner's cost gate (`--ray_routing_gate`), as
  `_view_plan` decides;
- `_run_validation` scores PSNR/SSIM, and LPIPS for every net with a
  weight file, on the right half of each val view (the half excluded from
  training) and writes gt | pred | depth panels.

With `--cluster_mask_path` the masks' `params.pt` must describe the scene
(near, origin, pose scale, altitude range), or the Runner raises. The grid
of every cell is `runtime/cell_runner.py`.

Several processes (torchrun's environment, `parallel/distributed.py`)
train one model data-parallel: every rank starts from the same weights
(the same seed, or the same --ckpt_path; nothing is broadcast), trains on its `batch_size / P` rows of each
global batch with its own sample generator (seeded from the seed and the
rank), and averages gradients over all ranks; rank 0 alone makes the
experiment directory and writes checkpoints (with every rank's generator
state, gathered), scalars, panels and `metrics.txt`; validation strides
the val views over the ranks and averages the gathered sums over the
gathered counts per metric.

Everything runs on `--device` (default cuda; a rank's card is
`cuda:{LOCAL_RANK % device_count}`). Asking for cuda without a card raises;
nothing falls back to the CPU. Training from --container_path raises (the
JAX Runner trains a fresh mixture there and ignores the container's
weights: ROADMAP.md C).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from argparse import Namespace
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mega_nerf_tpu_torch.data.filesystem_dataset import FilesystemDataset
from mega_nerf_tpu_torch.data.image_metadata import ImageMetadata
from mega_nerf_tpu_torch.data.memory_dataset import MemoryDataset
from mega_nerf_tpu_torch.data.torch_io import load_coordinates, load_pt
from mega_nerf_tpu_torch.models.factory import (
    ModelBundle,
    container_bundles,
    make_bg_nerf,
    make_nerf,
)
from mega_nerf_tpu_torch.models.mega import ray_route_plan
from mega_nerf_tpu_torch.models.nerf import init_weights
from mega_nerf_tpu_torch.models.weights import strip_module_prefix
from mega_nerf_tpu_torch.ops.lpips import LPIPS, load_available
from mega_nerf_tpu_torch.ops.metrics import lpips as lpips_metric
from mega_nerf_tpu_torch.ops.metrics import psnr as psnr_metric
from mega_nerf_tpu_torch.ops.metrics import ssim as ssim_metric
from mega_nerf_tpu_torch.ops.rays import generate_image_rays
from mega_nerf_tpu_torch.parallel import distributed
from mega_nerf_tpu_torch.parallel.distributed import is_master, main_print
from mega_nerf_tpu_torch.parallel.train_step import TrainStep
from mega_nerf_tpu_torch.render.cell_cull import (
    active_cells,
    clamp_rays_to_fg,
    ray_support_masks,
    support_order,
    tile_order,
)
from mega_nerf_tpu_torch.render.ray_bounds import load_occupancy, tighten_rays
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays
from mega_nerf_tpu_torch.runtime import checkpoints
from mega_nerf_tpu_torch.runtime.logging import MetricsWriter

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
    """Max rays per render call that keeps each MLP pass in budget. The
    cascade's fine pass evaluates the coarse and the fine depths together,
    so its pass has coarse + fine points per ray.

    A mixture does not shrink the cap, where the JAX package divides it by
    the submodule counts (`submodules`, `bg_submodules`): its dense blend
    holds the K outputs of a pass at once, while the port's `mega_apply`
    runs the submodules one after another into one accumulator, so a
    pass holds one submodule's activations whatever K is."""
    s_max = max(hparams.coarse_samples, hparams.fine_samples, 1)
    if getattr(hparams, "use_cascade", False) and hparams.fine_samples > 0:
        s_max = hparams.coarse_samples + hparams.fine_samples
    return max(1, EVAL_POINT_BUDGET // s_max)


# The culled path with occupancy bounds engages only when the mean support
# set, bucketed to powers of two, is at most this share of K: the JAX
# Runner's threshold in `render_image`, kept so both packages take the same
# path on the same view.
SUPPORT_GATE = 0.7


@dataclasses.dataclass
class ViewPlan:
    """`Runner._view_plan`'s decisions for one view. Arrays past `order`
    are in the permuted ray order."""

    cull: bool = False  # run each chunk's active fg submodules only
    ray: bool = False  # route each chunk's rays by their support rows
    ray_eff: Optional[int] = None  # the image-level plan's submodules per ray
    tighten: Optional[Callable[[np.ndarray], np.ndarray]] = None  # occupancy bounds
    order: Optional[np.ndarray] = None  # ray permutation (tiles or support sets)
    fg_bounds: Optional[np.ndarray] = None  # (n, 2), when computed up front
    cull_rays: Optional[np.ndarray] = None  # fg-clamped, bound-shrunk rays
    image_mask: Optional[np.ndarray] = None  # (K,) image-level active set
    ray_masks: Optional[np.ndarray] = None  # (n, K) per-ray support sets (cull or ray)
    routing: Tuple = ()  # (centroids (K, 3), margin, cluster_dim_start)

    def active(self, start: int, stop: int) -> Optional[List[int]]:
        """The fg submodules chunk [start, stop) runs (None: all): the
        union of its rays' support sets within the image set, or the
        active set of the chunk's box."""
        if not self.cull:
            return None
        if self.ray_masks is not None:
            mask = self.ray_masks[start:stop].any(0) & self.image_mask
            if not mask.any():
                # Every ray collapsed: zero fg everywhere, any one set is exact.
                mask = mask.copy()
                mask[0] = True
        else:
            mask = active_cells(self.cull_rays[start:stop], *self.routing)
        return None if mask.all() else np.flatnonzero(mask).tolist()


def resolve_device(name: str) -> torch.device:
    """`--device` -> this rank's torch.device; cuda without a card
    raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda was asked for but no CUDA device is available "
            "(pass --device cpu to run on the CPU)"
        )
    return distributed.rank_device(name)


def batch_to_device(host_batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """A dataset's host batch -> the train step's tensors on `device`."""
    batch = {
        "rgbs": torch.from_numpy(host_batch["rgbs"]),
        "rays": torch.from_numpy(host_batch["rays"]),
        "img_indices": torch.from_numpy(host_batch["img_indices"]).long(),
    }
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


class TrainLoopHooks:
    """The training loop's instrumentation: a torch.profiler window over
    `--profile_steps` steps from 10 steps past the start, the periodic
    non-finite metric guard, and throughput accounting."""

    def __init__(self, hparams: Namespace, profile_dir: Optional[Path],
                 rays_per_step: int, start_iteration: int,
                 device: torch.device):
        self.profile_dir = profile_dir
        self.rays_per_step = rays_per_step
        self.total = hparams.train_iterations
        self.profile_steps = hparams.profile_steps
        self.profile_start = start_iteration + 10
        self.device = device
        self._profiler = None
        self.t0: Optional[float] = None
        self.step0 = start_iteration

    def maybe_profile(self, iteration: int) -> None:
        if self.profile_steps <= 0 or self.profile_dir is None:
            return
        if iteration == self.profile_start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
        elif iteration >= self.profile_start + self.profile_steps:
            self.stop_profile()

    def stop_profile(self) -> None:
        """End an open trace window (the device finishes its queued work
        first) and write `<profile_dir>/trace.json.gz`."""
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        self.profile_dir.mkdir(parents=True, exist_ok=True)
        path = self.profile_dir / "trace.json.gz"
        self._profiler.export_chrome_trace(str(path))
        self._profiler = None
        print(f"Wrote profiler trace to {path}", flush=True)

    def metrics_due(self, iteration: int) -> bool:
        return iteration % METRICS_CHECK_INTERVAL == 0 or iteration >= self.total

    @staticmethod
    def check_finite(metrics_host: Dict[str, float]) -> None:
        """psnr may be +/-inf (a perfectly fit batch), never NaN; every
        other metric must be finite."""
        for k, v in metrics_host.items():
            arr = np.asarray(v)
            ok = np.isfinite(arr) | ((k == "psnr") & np.isinf(arr))
            if not ok.all():
                raise RuntimeError(f"Train metrics not finite in {k}: {v}")

    def restart_window(self, iteration: int) -> None:
        """Leave a pause (validation) out of the next throughput sample."""
        self.t0 = time.perf_counter()
        self.step0 = iteration

    def throughput(self, iteration: int) -> Optional[float]:
        """rays/s since the previous metrics step (None on the first)."""
        now = time.perf_counter()
        rays = None
        if self.t0 is not None:
            rays = (iteration - self.step0) * self.rays_per_step / (now - self.t0)
        self.t0 = now
        self.step0 = iteration
        return rays


class Runner:
    def __init__(self, hparams: Namespace, set_experiment_path: bool = True):
        self.hparams = hparams
        self.device = resolve_device(getattr(hparams, "device", "cuda"))
        self._occupancy = None
        self.view_stats: Dict = {}

        self.experiment_path = (
            self._get_experiment_path() if set_experiment_path and is_master() else None
        )
        self.writer: Optional[MetricsWriter] = None
        self._lpips_nets: Optional[Dict[str, LPIPS]] = None

        coords = load_coordinates(hparams.dataset_path)
        self.origin_drb = coords["origin_drb"]
        self.pose_scale_factor = coords["pose_scale_factor"]
        main_print(f"Origin: {self.origin_drb}, scale factor: {self.pose_scale_factor}")

        self.near = hparams.near / self.pose_scale_factor
        if hparams.far is not None:
            self.far = hparams.far / self.pose_scale_factor
        elif hparams.bg_nerf:
            self.far = 1e5
        else:
            self.far = 2.0
        main_print(f"Ray bounds: {self.near}, {self.far}")

        if hparams.ray_altitude_range is not None:
            self.ray_altitude_range = [
                (x - self.origin_drb[0]) / self.pose_scale_factor
                for x in hparams.ray_altitude_range
            ]
            assert self.ray_altitude_range[0] < self.ray_altitude_range[1]
        else:
            self.ray_altitude_range = None
        if hparams.cluster_mask_path is not None:
            self._check_cluster_params(
                Path(hparams.cluster_mask_path).parent / "params.pt")

        self.train_items, self.val_items = self._get_image_metadata()
        main_print(f"Using {len(self.train_items)} train images and "
                   f"{len(self.val_items)} val images")

        camera_positions = np.stack(
            [x.c2w[:3, 3] for x in self.train_items + self.val_items]
        )
        min_position = camera_positions.min(axis=0)
        max_position = camera_positions.max(axis=0)

        if getattr(hparams, "train_mega_nerf", None) is not None:
            hparams._mega_centroid_metadata = load_pt(hparams.train_mega_nerf)
        self.fg = make_nerf(hparams, len(self.train_items))
        self.bg: Optional[ModelBundle] = None
        self.sphere_center = None
        self.sphere_radius = None
        container_has_bg = (getattr(hparams, "container_path", None) is None
                            or container_bundles(hparams)[1] is not None)
        if hparams.bg_nerf and container_has_bg:
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
            main_print(f"Sphere center: {self.sphere_center}, radius: {self.sphere_radius}")

        for b in (self.fg, self.bg):
            if b is not None:
                b.to(self.device).module.eval()

    def _check_cluster_params(self, path: Path) -> None:
        """The masks' `params.pt` must describe this scene: the same near
        bound and pose scale factor, origin and altitude range close;
        otherwise the masks select the wrong rays."""
        params = load_pt(path)
        same = {
            "near": params["near"] == self.near,
            "origin_drb": np.allclose(params["origin_drb"], self.origin_drb),
            "pose_scale_factor": params["pose_scale_factor"] == self.pose_scale_factor,
            "ray_altitude_range": self.ray_altitude_range is None or np.allclose(
                np.asarray(params["ray_altitude_range"], np.float32),
                np.asarray(self.ray_altitude_range, np.float32)),
        }
        for key, ok in same.items():
            if not ok:
                raise ValueError(
                    f"cluster masks at {path.parent} were made for another scene: "
                    f"{key} {params[key]} in {path.name}, {getattr(self, key)} here")

    # ----------------------------------------------------------------- train

    def train(self) -> Dict[str, float]:
        """Train; returns the final validation metrics ({} with a cluster
        mask)."""
        hp = self.hparams
        if getattr(hp, "container_path", None) is not None:
            raise NotImplementedError(
                "training from --container_path: the JAX Runner trains a freshly "
                "initialised mixture there and ignores the container's weights, "
                "which is an open check, not ported (ROADMAP.md C)")
        self._setup_experiment_dir()
        # Every rank draws the same weights from the same seed and loads the
        # same --ckpt_path below: the ranks start equal without a broadcast.
        init_weights(self.fg.module, torch.Generator().manual_seed(hp.random_seed))
        if self.bg is not None:
            init_weights(self.bg.module,
                         torch.Generator().manual_seed(hp.random_seed + 1))
        if hp.batch_size % distributed.world_size():
            raise ValueError(f"--batch_size {hp.batch_size} is not a multiple of the "
                             f"{distributed.world_size()} ranks")
        step = TrainStep(
            self.fg, self.bg, RenderSettings.from_hparams(hp), hp.lr,
            hp.lr_decay_factor, hp.train_iterations, self.sphere_center,
            self.sphere_radius, use_appearance=hp.appearance_dim > 0,
            group=distributed.world_group())
        generator = torch.Generator(device=self.device).manual_seed(
            distributed.rank_seed(hp.random_seed, distributed.rank()))
        train_iterations = 0
        start_epoch = 0
        discard_index = -1
        if hp.ckpt_path is not None:
            loaded = self._load_weights(hp.ckpt_path)
            step.load_optimizer_states(loaded.get("optimizers", {}))
            train_iterations = int(loaded.get("iteration", 0))
            if hp.resume_ckpt_state:
                ds_state = loaded.get("dataset_state") or {}
                start_epoch = int(ds_state.get("epoch", 0))
                discard_index = int(ds_state.get("batch_index", -1))
                self._restore_generator(generator, loaded)
            main_print(f"Resumed from {hp.ckpt_path} at iteration {train_iterations}")
        self.train_step = step

        dataset = self._make_dataset()
        if isinstance(dataset, FilesystemDataset):
            # One chunk per epoch: the epoch is the chunk position.
            dataset.set_position(start_epoch)
        hooks = TrainLoopHooks(
            hp, None if self.experiment_path is None
            else self.experiment_path / "profile",
            hp.batch_size, train_iterations, self.device)
        epoch = start_epoch
        dataset_index = -1
        try:
            while train_iterations < hp.train_iterations:
                epoch_rng = np.random.default_rng((hp.random_seed, epoch))
                for dataset_index, host_batch in enumerate(
                        dataset.batches(hp.batch_size, epoch_rng)):
                    if dataset_index <= discard_index:
                        continue
                    discard_index = -1

                    metrics = step(batch_to_device(host_batch, self.device),
                                   generator)
                    train_iterations += 1
                    hooks.maybe_profile(train_iterations)

                    if hooks.metrics_due(train_iterations):
                        host = {k: float(v) for k, v in metrics.items()}
                        hooks.check_finite(host)
                        rate = hooks.throughput(train_iterations)
                        if self.writer is not None:
                            if rate is not None:
                                self.writer.add_scalar("train/rays_per_sec", rate,
                                                       train_iterations)
                            for k, v in host.items():
                                self.writer.add_scalar(f"train/{k}", v,
                                                       train_iterations)
                        main_print(f"step {train_iterations}: "
                                   + " ".join(f"{k}={v:.5g}" for k, v in host.items())
                                   + ("" if rate is None else f" rays/s={rate:.1f}"))

                    if train_iterations % hp.ckpt_interval == 0:
                        self._save_checkpoint(
                            train_iterations,
                            {"epoch": epoch, "batch_index": dataset_index},
                            generator)
                    if train_iterations % hp.val_interval == 0:
                        self._run_validation(train_iterations)
                        hooks.restart_window(train_iterations)
                    if train_iterations >= hp.train_iterations:
                        break
                else:
                    # Epoch fully consumed: clear the skip marker here too.
                    # A checkpoint on an epoch's last batch resumes into an
                    # epoch whose batches are all skipped, so the in-loop
                    # reset never runs, and the next epoch would be skipped
                    # as well.
                    discard_index = -1
                    epoch += 1
                    continue
                # Mid-epoch exit: `epoch` stays, so the final checkpoint
                # records the last batch consumed of the epoch that ran.
                break
            hooks.stop_profile()
        finally:
            if isinstance(dataset, FilesystemDataset):
                dataset.close()

        self._save_checkpoint(
            train_iterations, {"epoch": epoch, "batch_index": dataset_index},
            generator)
        val_metrics: Dict[str, float] = {}
        if hp.cluster_mask_path is None:
            val_metrics = self._run_validation(train_iterations)
            self._write_final_metrics(val_metrics)
        self._close_writer()
        return val_metrics

    def _make_dataset(self):
        hp = self.hparams
        # A fresh seed-derived rng: a resumed run rebuilds the dataset with
        # the same draws (val-pixel rebalancing, disk shuffles) as the
        # original one.
        ds_rng = np.random.default_rng(hp.random_seed)
        if hp.dataset_type == "memory":
            return MemoryDataset(
                self.train_items, self.near, self.far, self.ray_altitude_range,
                hp.center_pixels, ds_rng,
            )
        if hp.dataset_type == "filesystem":
            if not hp.chunk_paths:
                raise ValueError("--dataset_type filesystem needs --chunk_paths")
            return FilesystemDataset(
                self.train_items, self.near, self.far, self.ray_altitude_range,
                hp.center_pixels, [Path(x) for x in sorted(hp.chunk_paths)],
                hp.num_chunks, hp.train_scale_factor, hp.disk_flush_size,
                rng=ds_rng,
            )
        raise ValueError(f"Unrecognized dataset type: {hp.dataset_type}")

    def _save_checkpoint(self, iteration: int, dataset_state: Dict[str, int],
                         generator: torch.Generator) -> None:
        """Rank 0 writes `{iteration}.pt`; with several ranks it holds every
        rank's generator state (`generator_states`, in rank order; rank 0's
        is also `generator_state`). Every rank must call this."""
        states = distributed.all_gather_object(generator.get_state())
        if self.experiment_path is None:
            return
        checkpoints.save_checkpoint(
            self.experiment_path / "models" / f"{iteration}.pt",
            self.fg.module, None if self.bg is None else self.bg.module,
            self.train_step.optimizer_states(), iteration, dataset_state,
            states[0], extra={"generator_states": states} if len(states) > 1 else None)

    @staticmethod
    def _restore_generator(generator: torch.Generator, loaded: Dict) -> None:
        """This rank's sample generator from a `{iter}.pt`: its own state
        where the checkpoint holds one (a run of as many ranks or more),
        else the run keeps its fresh seed past rank 0."""
        states = loaded.get("generator_states")
        if states is None and "generator_state" in loaded:
            states = [loaded["generator_state"]]
        rank = distributed.rank()
        if states and rank < len(states):
            generator.set_state(states[rank])
        elif states:
            print(f"rank {rank}: the checkpoint holds the generators of "
                  f"{len(states)} ranks; this rank keeps its fresh seed", flush=True)

    # ------------------------------------------------------------------ eval

    def eval(self) -> Dict[str, float]:
        self._setup_experiment_dir()
        self.make_eval_state()
        val_metrics = self._run_validation(0)
        self._write_final_metrics(val_metrics)
        self._close_writer()
        return val_metrics

    def make_eval_state(self) -> None:
        """Load the weights of --ckpt_path (a reference `{iter}.pt` or a JAX
        `.ckpt`) into the fg/bg modules; a shape mismatch raises. The
        mixtures of --container_path hold the container's weights
        already."""
        hp = self.hparams
        if getattr(hp, "container_path", None) is not None:
            main_print(f"Serving the {len(self.fg.module)}-submodule mixture of "
                       f"{hp.container_path}")
            return
        if hp.ckpt_path is None:
            raise ValueError("eval needs --ckpt_path or --container_path")
        loaded = self._load_weights(hp.ckpt_path)
        main_print(f"Loaded {hp.ckpt_path} (iteration {loaded.get('iteration', 0)})")

    def _load_weights(self, path) -> Dict:
        """Load a `{iter}.pt`'s or a JAX `.ckpt`'s weights into the modules
        -> the whole dict, in the `{iter}.pt` layout."""
        loaded = checkpoints.load_checkpoint(path, self.hparams, len(self.train_items))
        if checkpoints.is_jax_checkpoint(path):
            main_print(f"Imported the JAX package's checkpoint {path} (weights, Adam "
                       f"states for {'+'.join(loaded['optimizers']) or 'none'}, "
                       f"iteration {loaded['iteration']}, stream position "
                       f"{loaded['dataset_state'] or 'none'}); "
                       f"{checkpoints.JAX_STATE_NOT_CARRIED}")
        self.fg.module.load_state_dict(
            strip_module_prefix(loaded["model_state_dict"]))
        if self.bg is not None:
            if "bg_model_state_dict" not in loaded:
                raise ValueError(f"{path} has no bg_model_state_dict")
            self.bg.module.load_state_dict(
                strip_module_prefix(loaded["bg_model_state_dict"]))
        return loaded

    # ------------------------------------------------------------ validation

    def _run_validation(self, train_index: int,
                        key_prefix: str = "val") -> Dict[str, float]:
        """Render + score the val images, strided over the ranks ->
        per-image AVERAGES under `key_prefix` (CellRunner passes
        val/cell{i}). With several ranks the sums and the counts of each
        metric are gathered, so a metric averages over the images it was
        computed on. Every rank must call this."""
        if self._lpips_nets is None:
            self._lpips_nets = load_available(device=self.device)
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        img_dir = None
        if self.experiment_path is not None:
            img_dir = self.experiment_path / "val_images" / str(train_index)
            img_dir.mkdir(parents=True, exist_ok=True)

        for i in range(distributed.rank(), len(self.val_items), distributed.world_size()):
            metadata = self.val_items[i]
            viz_rgbs = metadata.load_image().astype(np.float32) / 255.0
            results = self.render_image(metadata)
            typ = "fine" if "rgb_fine" in results else "coarse"
            pred = results[f"rgb_{typ}"].reshape(viz_rgbs.shape)

            half = viz_rgbs.shape[1] // 2
            eval_gt = torch.from_numpy(np.ascontiguousarray(viz_rgbs[:, half:]))
            eval_pred = torch.from_numpy(np.ascontiguousarray(pred[:, half:]))
            per_image = {
                f"{key_prefix}/psnr": float(psnr_metric(eval_pred, eval_gt)),
                f"{key_prefix}/ssim": float(ssim_metric(eval_pred, eval_gt, 1.0)),
            }
            for net, value in lpips_metric(eval_pred.to(self.device),
                                           eval_gt.to(self.device),
                                           self._lpips_nets).items():
                per_image[f"{key_prefix}/lpips/{net}"] = value
            for key, value in per_image.items():
                if self.writer is not None:
                    self.writer.add_scalar(f"{key}/{i}", value, train_index)
                sums[key] = sums.get(key, 0.0) + value
                counts[key] = counts.get(key, 0) + 1

            depth = results[f"depth_{typ}"].reshape(viz_rgbs.shape[:2])
            if f"fg_depth_{typ}" in results:
                ma = np.quantile(results[f"fg_depth_{typ}"].reshape(-1), 0.95)
                depth = np.clip(depth, None, ma)
            if img_dir is not None:
                from PIL import Image

                panel = self._create_result_image(viz_rgbs, pred, depth)
                Image.fromarray(panel).save(img_dir / f"{i}.jpg")
                if self.writer is not None:
                    self.writer.add_image(f"{key_prefix}/{i}", panel, train_index)
        if self.writer is not None:
            self.writer.flush()
        total: Dict[str, float] = {}
        total_counts: Dict[str, int] = {}
        for rank_sums, rank_counts in distributed.all_gather_object((sums, counts)):
            for k, v in rank_sums.items():
                total[k] = total.get(k, 0.0) + v
                total_counts[k] = total_counts.get(k, 0) + rank_counts[k]
        return {k: v / total_counts[k] for k, v in total.items()}

    def _close_writer(self) -> None:
        if self.writer is not None:
            self.writer.close()
            self.writer = None

    def _write_final_metrics(self, val_metrics: Dict[str, float]) -> None:
        if self.experiment_path is not None:
            with (self.experiment_path / "metrics.txt").open("w") as f:
                for key, avg in val_metrics.items():
                    message = f"Average {key}: {avg}"
                    main_print(message)
                    f.write(message + "\n")

    # ---------------------------------------------------------------- render

    def render_settings(self) -> RenderSettings:
        return RenderSettings.from_hparams(
            self.hparams, get_depth=True, get_bg_fg_rgb=True
        )

    def _get_occupancy(self):
        """Lazy (grid, invradius, offset) from --occupancy_path
        (render/ray_bounds.load_occupancy), or None when the flag is
        unset."""
        hp = self.hparams
        path = getattr(hp, "occupancy_path", None)
        if not path:
            return None
        if self._occupancy is None:
            self._occupancy = load_occupancy(
                path, thresh=float(getattr(hp, "occupancy_thresh", -1.0)),
                dilate=int(getattr(hp, "occupancy_dilate", 1)))
            grid = self._occupancy[0]
            main_print(f"Occupancy grid {grid.shape} from {path}: "
                       f"{100.0 * grid.mean():.1f}% occupied")
        return self._occupancy

    def _view_plan(self, metadata: ImageMetadata, rays: torch.Tensor,
                   chunk: int) -> ViewPlan:
        """How `render_image` walks one view: the JAX Runner's decisions
        (`mega_nerf_tpu/runtime/runner.py::render_image`) with the same
        gates, so both packages take the same path on the same view.

        - Occupancy bounds (--occupancy_path): for the whole view up front
          when culling or ray routing (they shrink the cull boxes and the
          supports), else per chunk.
        - Ray routing (a fg mixture of K > 1 under --mega_routing ray):
          per-ray support sets over the rays clamped to the fg ellipsoid
          and shrunk by the bounds; the image-level `ray_route_plan`
          costs eff = ceil(Kv * capacity / n) submodule evaluations a ray,
          and the path engages only if eff is at most --ray_routing_gate x
          K (the JAX gate, kept for the same decision). Then the rays are
          grouped by support set (`support_order`) and each chunk's rays
          route by their own support rows. It excludes culling.
        - Culling (a dense fg mixture of K > 1 unless --no_cell_cull; not
          per-point routed ones): the image-level active set from the
          clamped, shrunk rays; with a full set and no bounds the per-chunk
          boxes never shrink, so the culled path is off. With bounds,
          per-ray support masks ANDed with the image set; the path engages
          only if the mean power-of-two-bucketed support is at most 0.7 K
          (the JAX gate, kept for the same decision), and then the rays are
          grouped by support set (`support_order`); else a full frame goes
          in square tiles (`tile_order`)."""
        hp = self.hparams
        k = len(self.fg.module) if self.fg.is_mega else 1
        use_ray = self.fg.use_ray_routed and k > 1
        plan = ViewPlan(cull=bool(getattr(hp, "cell_cull", True) and self.fg.is_mega
                                  and not self.fg.use_routed and not use_ray and k > 1))
        occ = self._get_occupancy()
        if not (plan.cull or use_ray) and occ is None:
            return plan
        rays_np = rays.cpu().numpy()
        center = radius = None
        if self.sphere_radius is not None:
            center = self.sphere_center.cpu().numpy().astype(np.float64)
            radius = self.sphere_radius.cpu().numpy().astype(np.float64)
        if occ is not None:
            grid, occ_inv, occ_off = occ
            plan.tighten = lambda rr: tighten_rays(  # noqa: E731
                rr, grid, occ_inv, occ_off,
                probes=int(getattr(hp, "occupancy_probes", 128)),
                sphere_center=center, sphere_radius=radius,
                mode=str(getattr(hp, "occupancy_mode", "near")))
        if not (plan.cull or use_ray):
            return plan

        plan.routing = (self.fg.centroids.cpu().numpy().astype(np.float32),
                        self.fg.boundary_margin, self.fg.cluster_dim_start)
        if plan.tighten is not None:
            plan.fg_bounds = plan.tighten(rays_np)
        # Cull boxes and supports end at the fg ellipsoid exit, not the
        # (bg-owned) ray far: only the mask math sees the clamp.
        cull_rays = clamp_rays_to_fg(rays_np, center, radius)
        if plan.fg_bounds is not None:
            cull_rays[:, 6] = np.maximum(cull_rays[:, 6], plan.fg_bounds[:, 0])
            cull_rays[:, 7] = np.minimum(cull_rays[:, 7], plan.fg_bounds[:, 1])
            cull_rays[:, 7] = np.maximum(cull_rays[:, 7], cull_rays[:, 6])
        if use_ray:
            masks = ray_support_masks(cull_rays, *plan.routing)
            _, cells, cap = ray_route_plan(masks)
            plan.ray_eff = max(1, -(-len(cells) * int(cap) // max(rays_np.shape[0], 1)))
            if plan.ray_eff / k > float(getattr(hp, "ray_routing_gate", 0.45)):
                return plan
            plan.ray, plan.ray_masks = True, masks
            plan.order = support_order(masks)
        else:
            plan.image_mask = active_cells(cull_rays, *plan.routing)
            if plan.fg_bounds is None and plan.image_mask.all():
                plan.cull = False
                return plan
            if plan.fg_bounds is not None:
                masks = ray_support_masks(cull_rays, *plan.routing)
                masks &= plan.image_mask[None, :]
                buckets = 2 ** np.ceil(np.log2(np.maximum(masks.sum(1), 1)))
                if float(buckets.mean()) / k > SUPPORT_GATE:
                    plan.cull = False
                    return plan
                plan.ray_masks = masks
                plan.order = support_order(masks)
            elif rays_np.shape[0] == metadata.W * metadata.H:
                plan.order = tile_order(metadata.W, metadata.H, chunk)
        if plan.order is not None:
            cull_rays = cull_rays[plan.order]
            if plan.fg_bounds is not None:
                plan.fg_bounds = plan.fg_bounds[plan.order]
            if plan.ray_masks is not None:
                plan.ray_masks = plan.ray_masks[plan.order]
        plan.cull_rays = cull_rays
        return plan

    def render_image(self, metadata: ImageMetadata) -> Dict[str, np.ndarray]:
        """Render a full image in chunks (the last one shorter) -> numpy
        arrays of H*W rows, with occupancy bounds, cell culling and ray
        routing as `_view_plan` decides; `self.view_stats` records the
        decisions and, per chunk, the fg submodules each pass runs (all K
        for a per-point routed mixture, whose counts depend on the
        points)."""
        hp = self.hparams
        rays = generate_image_rays(
            metadata, self.near, self.far, self.ray_altitude_range,
            hp.center_pixels, device=self.device,
        )
        n = rays.shape[0]
        chunk = min(hp.image_pixel_batch_size, n, _eval_chunk_cap(hp))
        plan = self._view_plan(metadata, rays, chunk)
        if plan.order is not None:
            rays = rays[torch.from_numpy(plan.order).to(self.device)]
        settings = self.render_settings()
        results: Dict[str, List[torch.Tensor]] = {}
        k_fg = len(self.fg.module) if self.fg.is_mega else 1
        active_counts = []
        for start in range(0, n, chunk):
            chunk_rays = rays[start:start + chunk]
            stop = start + chunk_rays.shape[0]
            bounds = None
            if plan.fg_bounds is not None:
                bounds = plan.fg_bounds[start:stop]
            elif plan.tighten is not None:
                bounds = plan.tighten(chunk_rays.cpu().numpy())
            if bounds is not None:
                bounds = torch.from_numpy(np.ascontiguousarray(bounds, np.float32)).to(
                    self.device)
            active = plan.active(start, stop)
            support = plan.ray_masks[start:stop] if plan.ray else None
            active_counts.append(
                int(support.any(0).sum()) if plan.ray
                else k_fg if active is None else len(active))
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
                    fg_bounds=bounds, fg_active=active, fg_ray_support=support,
                )
            for k, v in out.items():
                results.setdefault(k, []).append(v.cpu())
        out = {k: torch.cat(v).numpy() for k, v in results.items()}
        if plan.order is not None:
            inv = np.empty_like(plan.order)
            inv[plan.order] = np.arange(n, dtype=plan.order.dtype)
            out = {k: v[inv] for k, v in out.items()}
        self.view_stats = {
            "bounded": plan.tighten is not None, "cull": plan.cull,
            "support_sorted": plan.cull and plan.ray_masks is not None,
            "tiled": plan.cull and plan.ray_masks is None and plan.order is not None,
            "routed": self.fg.use_routed, "ray_routed": plan.ray, "ray_eff": plan.ray_eff,
            "chunks": len(active_counts), "active_per_chunk": active_counts}
        return out

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
                if key.startswith("_"):  # caches, such as the container's bundles
                    continue
                f.write(f"{key}: {val}\n")
        with (self.experiment_path / "command.txt").open("w") as f:
            f.write(" ".join(sys.argv) + "\n")
        with (self.experiment_path / "image_indices.txt").open("w") as f:
            for item in self.train_items:
                f.write(f"{item.image_index},{item.image_path.name}\n")
        self.writer = MetricsWriter(self.experiment_path / "tb")

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
