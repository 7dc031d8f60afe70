"""Cell-parallel Mega-NeRF training in one process: every submodule of a
grid, one grid step at a time.

Counterpart of the JAX package's `runtime/cell_runner.py` on one device,
and of the reference's fan-out of one `train.py` job per centroid:

- the cluster masks (`scripts/create_cluster_masks.py`) define K per-cell
  ray streams (`data/cell_dataset.py`), the streams K independent jobs
  with `--cluster_mask_path masks/{i}` would read;
- each cell trains its own fg (and bg) modules with its own Adam states,
  schedules and sample generator (`parallel/cell_parallel.py`); nothing
  crosses cells;
- per-cell `{iter}.pt` checkpoints land in
  `{exp_name}{i}/{version}/models/`, the layout
  `scripts/merge_submodules.py` walks, each with its cell's stream
  position and generator state plus `cell_index`, `num_cells` and
  `exp_prefix`; `--ckpt_path` to any one cell's checkpoint resumes all K;
- `--val_interval` validates every cell's model alone on the val views
  under `val/cell{i}/...` (no final validation, as in the JAX loop);
  scalars go to cell 0's `tb/metrics.jsonl`: `train/{k}` (the mean over
  cells) and `train/{k}/cell{i}`.

One process on one device: `--cell_axis` or `--data_axis` above 1 (a
device mesh) raises; multi-process training is ROADMAP.md A.4.
"""

from __future__ import annotations

import sys
from argparse import Namespace
from pathlib import Path
from typing import Dict, List, Optional

from mega_nerf_tpu_torch.data.cell_dataset import CellDataset
from mega_nerf_tpu_torch.data.image_metadata import ImageMetadata
from mega_nerf_tpu_torch.data.torch_io import load_pt
from mega_nerf_tpu_torch.models.factory import make_bg_nerf, make_nerf
from mega_nerf_tpu_torch.models.weights import strip_module_prefix
from mega_nerf_tpu_torch.parallel.cell_parallel import (
    CellParallelTrainStep,
    CellState,
    make_cell_train_state,
)
from mega_nerf_tpu_torch.render.rendering import RenderSettings
from mega_nerf_tpu_torch.runtime import checkpoints
from mega_nerf_tpu_torch.runtime.logging import MetricsWriter
from mega_nerf_tpu_torch.runtime.runner import Runner, TrainLoopHooks, batch_to_device


class CellRunner(Runner):
    """`hparams.cluster_mask_path` is the masks ROOT (`params.pt` and the
    per-cell directories 0..K-1); `hparams.exp_name` is the per-cell
    experiment PREFIX: cell i writes `{exp_name}{i}/`, which is what
    merge_submodules' --ckpt_prefix expects."""

    def __init__(self, hparams: Namespace):
        for flag in ("cell_axis", "data_axis"):
            if (getattr(hparams, flag, None) or 1) > 1:
                raise NotImplementedError(
                    f"--{flag} {getattr(hparams, flag)} describes a device mesh; the "
                    "port trains every cell in one process on one device "
                    "(multi-process training is ROADMAP.md A.4)")
        mask_root = Path(hparams.cluster_mask_path)
        params = load_pt(mask_root / "params.pt")
        grid_dim = [int(x) for x in params["grid_dim"]]
        self.num_cells = grid_dim[0] * grid_dim[1]
        self.mask_root = mask_root

        # The base set-up sees the first cell's mask directory: its images'
        # mask paths exist, and the scene check reads the root's params.pt
        # (the parent of a cell directory). Per-cell masks go onto copies of
        # the metadata below.
        hparams.cluster_mask_path = str(mask_root / "0")
        try:
            super().__init__(hparams, set_experiment_path=False)
        finally:
            hparams.cluster_mask_path = str(mask_root)

        self.cell_items: List[List[ImageMetadata]] = [
            [ImageMetadata(
                item.image_path, item.c2w, item.W, item.H, item.intrinsics,
                item.image_index,
                None if (item.is_val and hparams.all_val)
                else mask_root / str(cell) / f"{item.image_path.stem}.pt",
                item.is_val)
             for item in self.train_items]
            for cell in range(self.num_cells)]

        # One version number aligned across cells: {exp_name}{i}/{version}.
        self.exp_prefix = str(Path(hparams.exp_name).absolute())
        versions = []
        for cell in range(self.num_cells):
            exp_dir = Path(f"{self.exp_prefix}{cell}")
            exp_dir.mkdir(parents=True, exist_ok=True)
            existing = [int(x.name) for x in exp_dir.iterdir() if x.name.isdigit()]
            versions.append(0 if not existing else max(existing) + 1)
        self.version = max(versions)
        self.cell_paths = [Path(f"{self.exp_prefix}{cell}") / str(self.version)
                           for cell in range(self.num_cells)]
        self.cells: List[CellState] = []

    # ----------------------------------------------------------------- train

    def train(self) -> Dict[str, float]:
        """Train every cell; returns {} (no final validation)."""
        hp = self.hparams
        self._setup_cell_experiment_dirs()
        self.cells = make_cell_train_state(
            lambda: make_nerf(hp, len(self.train_items)),
            None if self.bg is None else lambda: make_bg_nerf(hp, len(self.train_items)),
            RenderSettings.from_hparams(hp), hp.lr, hp.lr_decay_factor,
            hp.train_iterations, self.num_cells, hp.random_seed, self.device,
            self.sphere_center, self.sphere_radius,
            use_appearance=hp.appearance_dim > 0)
        step = CellParallelTrainStep(self.cells)

        train_iterations = 0
        stream_states: Optional[List[Dict[str, int]]] = None
        if hp.ckpt_path is not None:
            train_iterations, stream_states = self._restore_cells(Path(hp.ckpt_path))
            print(f"Resumed {self.num_cells} cells from {hp.ckpt_path} at "
                  f"iteration {train_iterations}")

        dataset = CellDataset(
            self.cell_items, self.near, self.far, self.ray_altitude_range,
            hp.center_pixels, hp.random_seed, dataset_type=hp.dataset_type,
            chunk_paths=[Path(x) for x in sorted(hp.chunk_paths)] if hp.chunk_paths else None,
            num_chunks=hp.num_chunks, scale_factor=hp.train_scale_factor,
            disk_flush_size=hp.disk_flush_size,
            # Border cells of a grid see far fewer masked rays than central
            # ones: their chunks must still hold a few batches.
            min_chunk_rays=4 * hp.batch_size)
        try:
            if stream_states is not None and hp.resume_ckpt_state:
                dataset.set_state(stream_states, hp.batch_size)
            hooks = TrainLoopHooks(hp, self.cell_paths[0] / "profile",
                                   hp.batch_size * self.num_cells, train_iterations,
                                   self.device)
            while train_iterations < hp.train_iterations:
                metrics = step(batch_to_device(dataset.next_batch(hp.batch_size),
                                               self.device))
                train_iterations += 1
                hooks.maybe_profile(train_iterations)

                if hooks.metrics_due(train_iterations):
                    host = {k: v.float().cpu().numpy() for k, v in metrics.items()}
                    hooks.check_finite(host)
                    rate = hooks.throughput(train_iterations)
                    if rate is not None:
                        self.writer.add_scalar("train/rays_per_sec", rate,
                                               train_iterations)
                    for k, v in host.items():
                        self.writer.add_scalar(f"train/{k}", float(v.mean()),
                                               train_iterations)
                        for cell in range(self.num_cells):
                            self.writer.add_scalar(f"train/{k}/cell{cell}",
                                                   float(v[cell]), train_iterations)
                    print(f"step {train_iterations}: "
                          + " ".join(f"{k}={v.mean():.5g}" for k, v in host.items())
                          + ("" if rate is None else f" rays/s={rate:.1f}"), flush=True)

                if train_iterations % hp.ckpt_interval == 0:
                    self._save_cell_checkpoints(train_iterations, dataset.state())
                    hooks.restart_window(train_iterations)
                if (train_iterations % hp.val_interval == 0
                        and train_iterations < hp.train_iterations):
                    self._run_cell_validation(train_iterations)
                    hooks.restart_window(train_iterations)
            hooks.stop_profile()
        finally:
            dataset.close()

        self._save_cell_checkpoints(train_iterations, dataset.state())
        self._close_writer()
        return {}

    # ------------------------------------------------------------ validation

    def _run_cell_validation(self, train_index: int) -> None:
        """Every cell's model renders the val views alone, as each of the
        reference's independent jobs does; metrics under val/cell{i}/..."""
        fg, bg = self.fg, self.bg
        try:
            for cell, state in enumerate(self.cells):
                self.fg, self.bg = state.fg, state.bg
                self._run_validation(train_index, key_prefix=f"val/cell{cell}")
        finally:
            self.fg, self.bg = fg, bg

    # ----------------------------------------------------------- checkpoints

    def _save_cell_checkpoints(self, train_index: int,
                               stream_states: List[Dict[str, int]]) -> None:
        for cell, state in enumerate(self.cells):
            checkpoints.save_checkpoint(
                self.cell_paths[cell] / "models" / f"{train_index}.pt",
                state.fg.module, None if state.bg is None else state.bg.module,
                state.step.optimizer_states(), train_index, stream_states[cell],
                state.generator.get_state(),
                extra={"cell_index": cell, "num_cells": self.num_cells,
                       "exp_prefix": self.exp_prefix})

    def _restore_cells(self, ckpt_path: Path):
        """Load all K cells given any one cell's `{iter}.pt` (its siblings
        come from the `exp_prefix` it records) -> (iteration, per-cell
        stream states)."""
        first = checkpoints.load_checkpoint(ckpt_path)
        if first.get("num_cells") != self.num_cells:
            raise ValueError(f"{ckpt_path} is a checkpoint of {first.get('num_cells')} "
                             f"cells; this run has {self.num_cells}")
        version = ckpt_path.parent.parent.name
        stream_states = []
        for cell, state in enumerate(self.cells):
            path = Path(f"{first['exp_prefix']}{cell}") / version / "models" / ckpt_path.name
            loaded = checkpoints.load_checkpoint(path)
            if loaded["cell_index"] != cell:
                raise ValueError(f"{path} holds cell {loaded['cell_index']}, not {cell}")
            state.fg.module.load_state_dict(strip_module_prefix(loaded["model_state_dict"]))
            if state.bg is not None:
                state.bg.module.load_state_dict(
                    strip_module_prefix(loaded["bg_model_state_dict"]))
            state.step.load_optimizer_states(loaded.get("optimizers", {}))
            if self.hparams.resume_ckpt_state:
                state.generator.set_state(loaded["generator_state"])
            stream_states.append(loaded["dataset_state"])
        return int(first["iteration"]), stream_states

    # ----------------------------------------------------------------- setup

    def _setup_cell_experiment_dirs(self) -> None:
        for cell, cell_path in enumerate(self.cell_paths):
            (cell_path / "models").mkdir(parents=True, exist_ok=True)
            with (cell_path / "hparams.txt").open("w") as f:
                for key, val in vars(self.hparams).items():
                    if not key.startswith("_"):
                        f.write(f"{key}: {val}\n")
            with (cell_path / "command.txt").open("w") as f:
                f.write(" ".join(sys.argv) + "\n")
            with (cell_path / "image_indices.txt").open("w") as f:
                for item in self.cell_items[cell]:
                    f.write(f"{item.image_index},{item.image_path.name}\n")
        self.writer = MetricsWriter(self.cell_paths[0] / "tb")
