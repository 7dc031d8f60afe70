"""Cell-parallel Mega-NeRF training: every submodule, one grid step at a
time.

Counterpart of the JAX package's `parallel/cell_parallel.py`
(`make_cell_train_state`, `make_cell_parallel_train_step`), which stacks
the K submodules' parameters over a leading cell axis and maps one train
step over it. Here the K cells are K independent states:

- each `CellState` holds its own fg (and bg) modules, its own `TrainStep`
  with its Adam states and schedules, and its own sample generator on the
  device;
- one grid step runs every cell's train step on that cell's rows of the
  stacked `(K, B, ...)` batch, in cell order, and returns `(K,)` metrics
  per key. Nothing crosses cells: each cell keeps its own background skip
  (a cell whose rows hold no background ray leaves its bg parameters,
  Adam state and schedule as they were).

Over several ranks, a rank holds the states of the cells its group owns
(`cells`), and each cell's step averages its gradients and metrics over the
group's D ranks (`group`; the JAX `pmean` over 'data'); nothing crosses
cell groups. The D ranks of a group start a cell from the same weights and
draw their samples from their own generators.

`mixture_states_from_flax` carries the JAX package's stacked cell or
mixture parameters across: one reference-named state dict per cell or
submodule.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from mega_nerf_tpu_torch.models.factory import ModelBundle
from mega_nerf_tpu_torch.models.nerf import NeRFConfig, init_weights
from mega_nerf_tpu_torch.models.weights import state_from_flax_params
from mega_nerf_tpu_torch.parallel.distributed import Group, rank_seed
from mega_nerf_tpu_torch.parallel.train_step import TrainStep
from mega_nerf_tpu_torch.render.rendering import RenderSettings


@dataclasses.dataclass
class CellState:
    index: int  # the cell's number in the grid (past the real cells: padding)
    fg: ModelBundle
    bg: Optional[ModelBundle]
    step: TrainStep
    generator: torch.Generator


def cell_seed(seed: int, cell: int, stream: int) -> int:
    """A 63-bit torch seed for one cell's stream (0 fg init, 1 bg init,
    2 samples), distinct across seeds, cells and streams."""
    return int(np.random.SeedSequence((seed, cell, stream)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def make_cell_train_state(
    make_fg: Callable[[], ModelBundle],
    make_bg: Optional[Callable[[], ModelBundle]],
    settings: RenderSettings,
    lr: float,
    lr_decay_factor: float,
    train_iterations: int,
    num_cells: int,
    seed: int,
    device: torch.device,
    sphere_center: Optional[torch.Tensor] = None,
    sphere_radius: Optional[torch.Tensor] = None,
    use_appearance: bool = True,
    cells: Optional[Sequence[int]] = None,
    group: Optional[Group] = None,
) -> List[CellState]:
    """K cells (or those of `cells`), each with freshly built and
    independently seeded modules on `device`, its own TrainStep (averaging
    over `group`) and its own sample generator (seeded per group rank)."""
    out = []
    for cell in (range(num_cells) if cells is None else cells):
        bundles = []
        for stream, make in enumerate((make_fg, make_bg)):
            if make is None:
                bundles.append(None)
                continue
            bundle = make()
            init_weights(bundle.module,
                         torch.Generator().manual_seed(cell_seed(seed, cell, stream)))
            bundle.module.to(device)
            bundles.append(bundle)
        fg, bg = bundles
        step = TrainStep(fg, bg, settings, lr, lr_decay_factor, train_iterations,
                         sphere_center, sphere_radius, use_appearance=use_appearance,
                         group=group, pmean_psnr=True)
        generator = torch.Generator(device=device).manual_seed(
            rank_seed(cell_seed(seed, cell, 2), 0 if group is None else group.index))
        out.append(CellState(cell, fg, bg, step, generator))
    return out


class CellParallelTrainStep:
    """One grid step: `(K, B, ...)` batch -> `(K,)` metrics per key (K the
    cells this rank holds)."""

    def __init__(self, cells: List[CellState]):
        self.cells = cells

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        per_cell = [
            cell.step({k: v[c] for k, v in batch.items()}, cell.generator)
            for c, cell in enumerate(self.cells)
        ]
        return {k: torch.stack([m[k] for m in per_cell]) for k in per_cell[0]}


def _take(tree, cell: int):
    """Row `cell` of every leaf of a nested mapping of stacked arrays."""
    if isinstance(tree, Mapping):
        return {k: _take(v, cell) for k, v in tree.items()}
    return np.asarray(tree)[cell]


def mixture_states_from_flax(cfg: NeRFConfig, stacked_params: Mapping, k: int,
                             cascade: bool = False) -> List[Dict[str, torch.Tensor]]:
    """The JAX package's stacked parameters (a params tree as numpy, leading
    axis K: the cells of `make_cell_train_state`, or the submodules of a
    `--train_mega_nerf` mixture) -> K state dicts of the port."""
    return [state_from_flax_params(cfg, _take(stacked_params, c), cascade)
            for c in range(k)]

