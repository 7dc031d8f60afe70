"""Cell-parallel Mega-NeRF training: every submodule of a grid, one grid
step at a time.

Counterpart of the JAX package's `runtime/cell_runner.py`, and of the
reference's fan-out of one `train.py` job per centroid:

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
  `exp_prefix`; `--ckpt_path` to any one cell's checkpoint resumes all K,
  from the port's `{iter}.pt` or the JAX package's `{iter}.ckpt` files;
- `--val_interval` validates every cell's model alone on the val views
  under `val/cell{i}/...` (no final validation, as in the JAX loop);
  scalars go to cell 0's `tb/metrics.jsonl`: `train/{k}` (the mean over
  cells) and `train/{k}/cell{i}`.

Over several processes (torchrun's environment), `--cell_axis C
--data_axis D` lays the ranks out as C cell groups of D ranks (C x D must
be the world size; D defaults to it over C). The cell count is padded to a
multiple of C with padding cells (the JAX package's synthetic stream, never
logged, checkpointed or merged), and group g owns cells
[g K'/C, (g+1) K'/C) of the K' padded ones: each of its ranks holds those
cells' states and streams and trains on its D-th of each batch, averaging
over the group; nothing crosses groups. Rank 0 picks the version and makes
the directories; the checkpoints gather every rank's stream and generator
states and the first rank of each group writes its real cells'; per-cell
validation broadcasts each cell's weights from its group and strides the
views over every rank. A filesystem cell store is its rank's own, so it
needs a group in one process (`--data_axis 1`). `cells` then holds this
rank's cells only; the checkpoints are the handoff.
"""

from __future__ import annotations

import sys
from argparse import Namespace
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mega_nerf_tpu_torch.data.cell_dataset import CellDataset
from mega_nerf_tpu_torch.data.image_metadata import ImageMetadata
from mega_nerf_tpu_torch.data.torch_io import load_pt
from mega_nerf_tpu_torch.models.factory import ModelBundle, make_bg_nerf, make_nerf
from mega_nerf_tpu_torch.models.weights import strip_module_prefix
from mega_nerf_tpu_torch.parallel import distributed
from mega_nerf_tpu_torch.parallel.cell_parallel import (
    CellParallelTrainStep,
    CellState,
    make_cell_train_state,
)
from mega_nerf_tpu_torch.parallel.distributed import is_master, main_print
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
        mask_root = Path(hparams.cluster_mask_path)
        params = load_pt(mask_root / "params.pt")
        grid_dim = [int(x) for x in params["grid_dim"]]
        self.num_cells = grid_dim[0] * grid_dim[1]
        self.mask_root = mask_root
        self._set_layout(hparams)

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

        # One version number aligned across cells: {exp_name}{i}/{version},
        # picked by rank 0 (ranks scanning at different moments would pick
        # different ones).
        self.exp_prefix = str(Path(hparams.exp_name).absolute())
        version = None
        if is_master():
            versions = []
            for cell in range(self.num_cells):
                exp_dir = Path(f"{self.exp_prefix}{cell}")
                exp_dir.mkdir(parents=True, exist_ok=True)
                existing = [int(x.name) for x in exp_dir.iterdir() if x.name.isdigit()]
                versions.append(0 if not existing else max(existing) + 1)
            version = max(versions)
        self.version = distributed.broadcast_object(version)
        self.cell_paths = [Path(f"{self.exp_prefix}{cell}") / str(self.version)
                           for cell in range(self.num_cells)]
        self.cells: List[CellState] = []
        self.group = distributed.cell_groups(self.cell_axis, self.data_axis)
        self._scratch: Optional[Tuple[ModelBundle, Optional[ModelBundle]]] = None

    def _set_layout(self, hp: Namespace) -> None:
        """C cell groups of D ranks over the world; the cells padded to a
        multiple of C; this rank's group, place in it and cells."""
        world = distributed.world_size()
        self.cell_axis = int(getattr(hp, "cell_axis", None) or 1)
        data_axis = getattr(hp, "data_axis", None)
        self.data_axis = int(data_axis) if data_axis else max(1, world // self.cell_axis)
        if self.cell_axis * self.data_axis != world:
            raise ValueError(
                f"--cell_axis {self.cell_axis} x --data_axis {self.data_axis} = "
                f"{self.cell_axis * self.data_axis} ranks, but the world has {world} "
                f"(WORLD_SIZE): C x D must equal it")
        if hp.dataset_type == "filesystem" and self.data_axis > 1:
            raise ValueError(
                f"--data_axis {self.data_axis} with --dataset_type filesystem: a "
                "filesystem cell store is its rank's own, so a cell group must sit "
                "in one process (--data_axis 1, or --dataset_type memory)")
        self.padded_cells = -(-self.num_cells // self.cell_axis) * self.cell_axis
        per_group = self.padded_cells // self.cell_axis
        self.group_index, self.data_index = divmod(distributed.rank(), self.data_axis)
        self.owned_cells = list(range(self.group_index * per_group,
                                      (self.group_index + 1) * per_group))
        self._per_group = per_group
        if world > 1:
            print(f"rank {distributed.rank()}: cell group {self.group_index}, data "
                  f"index {self.data_index}, cells {self.owned_cells} of "
                  f"{self.num_cells} (+{self.padded_cells - self.num_cells} padding)",
                  flush=True)

    def _owner(self, cell: int) -> int:
        """The first rank of the group that owns `cell`."""
        return (cell // self._per_group) * self.data_axis

    # ----------------------------------------------------------------- train

    def train(self) -> Dict[str, float]:
        """Train every cell; returns {} (no final validation)."""
        hp = self.hparams
        multi = distributed.world_size() > 1
        self._setup_cell_experiment_dirs()
        self.cells = make_cell_train_state(
            lambda: make_nerf(hp, len(self.train_items)),
            None if self.bg is None else lambda: make_bg_nerf(hp, len(self.train_items)),
            RenderSettings.from_hparams(hp), hp.lr, hp.lr_decay_factor,
            hp.train_iterations, self.num_cells, hp.random_seed, self.device,
            self.sphere_center, self.sphere_radius,
            use_appearance=hp.appearance_dim > 0,
            cells=self.owned_cells if multi else None, group=self.group)
        step = CellParallelTrainStep(self.cells)

        train_iterations = 0
        stream_states: Optional[List[Optional[Dict[str, int]]]] = None
        if hp.ckpt_path is not None:
            train_iterations, stream_states = self._restore_cells(Path(hp.ckpt_path))
            main_print(f"Resumed {self.num_cells} cells from {hp.ckpt_path} at "
                       f"iteration {train_iterations}")

        dataset = CellDataset(
            self.cell_items, self.near, self.far, self.ray_altitude_range,
            hp.center_pixels, hp.random_seed, dataset_type=hp.dataset_type,
            chunk_paths=[Path(x) for x in sorted(hp.chunk_paths)] if hp.chunk_paths else None,
            num_chunks=hp.num_chunks, scale_factor=hp.train_scale_factor,
            disk_flush_size=hp.disk_flush_size,
            # Border cells of a grid see far fewer masked rays than central
            # ones: their chunks must still hold a few batches.
            min_chunk_rays=4 * hp.batch_size,
            cells=self.owned_cells if multi else None, data_index=self.data_index,
            data_size=self.data_axis)
        try:
            if stream_states is not None and hp.resume_ckpt_state:
                dataset.set_state(stream_states, hp.batch_size)
            hooks = TrainLoopHooks(hp, self.cell_paths[0] / "profile" if is_master() else None,
                                   hp.batch_size * self.num_cells, train_iterations,
                                   self.device)
            while train_iterations < hp.train_iterations:
                metrics = step(batch_to_device(dataset.next_batch(hp.batch_size),
                                               self.device))
                train_iterations += 1
                hooks.maybe_profile(train_iterations)

                if hooks.metrics_due(train_iterations):
                    host = self._real_cell_metrics(metrics)
                    hooks.check_finite(host)
                    rate = hooks.throughput(train_iterations)
                    if self.writer is not None:
                        if rate is not None:
                            self.writer.add_scalar("train/rays_per_sec", rate,
                                                   train_iterations)
                        for k, v in host.items():
                            self.writer.add_scalar(f"train/{k}", float(v.mean()),
                                                   train_iterations)
                            for cell in range(self.num_cells):
                                self.writer.add_scalar(f"train/{k}/cell{cell}",
                                                       float(v[cell]), train_iterations)
                    main_print(f"step {train_iterations}: "
                               + " ".join(f"{k}={v.mean():.5g}" for k, v in host.items())
                               + ("" if rate is None else f" rays/s={rate:.1f}"))

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

    def _real_cell_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """This rank's (cells,) metrics -> the real cells' (K,) metrics, the
        groups' gathered from their first ranks (every rank calls this)."""
        host = {k: v.float().cpu().numpy() for k, v in metrics.items()}
        if distributed.world_size() > 1:
            ranks = distributed.all_gather_object(host)
            host = {k: np.concatenate([ranks[g * self.data_axis][k]
                                       for g in range(self.cell_axis)])
                    for k in host}
        return {k: v[:self.num_cells] for k, v in host.items()}

    # ------------------------------------------------------------ validation

    def _run_cell_validation(self, train_index: int) -> None:
        """Every cell's model renders the val views alone, as each of the
        reference's independent jobs does; metrics under val/cell{i}/...
        Over several ranks each cell's weights are broadcast from its group
        and the views strided over every rank."""
        fg, bg = self.fg, self.bg
        try:
            for cell in range(self.num_cells):
                self.fg, self.bg = self._cell_bundles(cell)
                self._run_validation(train_index, key_prefix=f"val/cell{cell}")
        finally:
            self.fg, self.bg = fg, bg

    def _cell_bundles(self, cell: int) -> Tuple[ModelBundle, Optional[ModelBundle]]:
        """Cell `cell`'s fg and bg modules on this rank: its own state's in
        one process, else scratch modules holding the owner's weights."""
        if distributed.world_size() == 1:
            state = self.cells[cell]
            return state.fg, state.bg
        hp = self.hparams
        if self._scratch is None:
            made = [make_nerf(hp, len(self.train_items)),
                    None if self.bg is None else make_bg_nerf(hp, len(self.train_items))]
            for b in made:
                if b is not None:
                    b.to(self.device)
            self._scratch = (made[0], made[1])
        src = self._owner(cell)
        if distributed.rank() == src:
            state = next(s for s in self.cells if s.index == cell)
            for mine, own in zip(self._scratch, (state.fg, state.bg)):
                if mine is not None:
                    mine.module.load_state_dict(own.module.state_dict())
        for b in self._scratch:
            if b is not None:
                distributed.broadcast_tensors_(list(b.module.state_dict().values()), src)
                b.packed = None
        return self._scratch

    # ----------------------------------------------------------- checkpoints

    def _save_cell_checkpoints(self, train_index: int,
                               stream_states: List[Optional[Dict[str, int]]]) -> None:
        """Each real cell's `{train_index}.pt`. The stream and generator
        states of every rank are gathered first; the first rank of a cell's
        group writes it, with the group's D generator states
        (`generator_states` past one). Every rank must call this."""
        local = {s.index: (stream_states[s.index] if s.index < self.num_cells else None,
                           s.generator.get_state()) for s in self.cells}
        ranks = distributed.all_gather_object(local)
        first = self.group_index * self.data_axis
        for state in self.cells:
            cell = state.index
            if cell >= self.num_cells or self.data_index != 0:
                continue
            gens = [ranks[first + d][cell][1] for d in range(self.data_axis)]
            extra = {"cell_index": cell, "num_cells": self.num_cells,
                     "exp_prefix": self.exp_prefix}
            if len(gens) > 1:
                extra["generator_states"] = gens
            checkpoints.save_checkpoint(
                self.cell_paths[cell] / "models" / f"{train_index}.pt",
                state.fg.module, None if state.bg is None else state.bg.module,
                state.step.optimizer_states(), train_index, ranks[first][cell][0],
                gens[0], extra=extra)
        distributed.barrier("cell_checkpoints_written")

    def _restore_cells(self, ckpt_path: Path):
        """Load this rank's real cells given any one cell's `{iter}.pt`, or
        the JAX package's `{iter}.ckpt` (its siblings come from the
        `exp_prefix` it records) -> (iteration, per-cell stream states, None
        for a cell this rank does not hold). Padding cells start afresh, and
        so does the generator of a cell whose file holds none (a `.ckpt`)."""
        hp, count = self.hparams, len(self.train_items)
        first = checkpoints.load_checkpoint(ckpt_path, hp, count)
        if checkpoints.is_jax_checkpoint(ckpt_path):
            main_print(f"Importing the JAX package's cell checkpoints {ckpt_path.name} "
                       f"(weights, Adam states, iteration {first['iteration']}, "
                       f"stream positions); {checkpoints.JAX_STATE_NOT_CARRIED}")
        if first.get("num_cells") != self.num_cells:
            raise ValueError(f"{ckpt_path} is a checkpoint of {first.get('num_cells')} "
                             f"cells; this run has {self.num_cells}")
        version = ckpt_path.parent.parent.name
        stream_states: List[Optional[Dict[str, int]]] = [None] * self.num_cells
        for state in self.cells:
            cell = state.index
            if cell >= self.num_cells:
                continue
            path = Path(f"{first['exp_prefix']}{cell}") / version / "models" / ckpt_path.name
            loaded = checkpoints.load_checkpoint(path, hp, count)
            if loaded["cell_index"] != cell:
                raise ValueError(f"{path} holds cell {loaded['cell_index']}, not {cell}")
            state.fg.module.load_state_dict(strip_module_prefix(loaded["model_state_dict"]))
            if state.bg is not None:
                state.bg.module.load_state_dict(
                    strip_module_prefix(loaded["bg_model_state_dict"]))
            state.step.load_optimizer_states(loaded.get("optimizers", {}))
            if hp.resume_ckpt_state:
                gens = loaded.get("generator_states") or (
                    [loaded["generator_state"]] if "generator_state" in loaded else [])
                if self.data_index < len(gens):
                    state.generator.set_state(gens[self.data_index])
            stream_states[cell] = loaded["dataset_state"]
        return int(first["iteration"]), stream_states

    # ----------------------------------------------------------------- setup

    def _setup_cell_experiment_dirs(self) -> None:
        """Rank 0 makes every cell's directory and files and the one
        writer (None on every other rank); then a barrier."""
        if not is_master():
            self.writer = None
            distributed.barrier("cell_dirs_made")
            return
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
        distributed.barrier("cell_dirs_made")
