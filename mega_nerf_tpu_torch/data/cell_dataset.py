"""Per-cell masked ray streams for training every submodule of a grid.

Counterpart of the JAX package's `data/cell_dataset.py`. The reference
trains each spatial submodule as an independent job on its own
cluster-masked ray stream (one `train.py --cluster_mask_path masks/{i}` per
centroid); this module builds those K streams side by side and stacks them
into `(cells, batch, ...)` batches:

- each cell has its own dataset (a MemoryDataset, or a FilesystemDataset
  with its own chunk store under `{chunk_path}/cell{c}`), built with the
  rng `default_rng((seed, cell))`;
- streams cycle independently, each epoch shuffled by
  `default_rng((seed, epoch, cell))`: cells never synchronize on epoch
  boundaries (their streams have different lengths);
- stream positions (epoch, batch_index per cell) are checkpointable and
  fast-forward deterministically for an exact mid-stream resume;
- a rank of a multi-process grid (`cells`, `data_index`, `data_size`)
  builds the streams of the cells its group owns only, and emits rows
  `[d * B / D, (d + 1) * B / D)` of each one's global batch; the group's
  padding cells (indices past the real cells) get the JAX package's
  synthetic stream in the same shape, also on a rank that owns nothing
  else. A stream's filesystem store is then the rank's own
  (`process_scope="private"`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from mega_nerf_tpu_torch.data.filesystem_dataset import FilesystemDataset
from mega_nerf_tpu_torch.data.image_metadata import ImageMetadata
from mega_nerf_tpu_torch.data.memory_dataset import MemoryDataset


class _CellStream:
    """An endless, resumable minibatch stream over one cell's dataset.

    The epoch shuffles are seeded by (seed, epoch, cell), so the stream is a
    function of its position: fast-forward replays the index bookkeeping,
    not the training."""

    def __init__(self, dataset, seed: int, cell: int):
        self._dataset = dataset
        self._seed = seed
        self._cell = cell
        self.epoch = 0
        self.batch_index = -1
        self._iter = None

    def _epoch_rng(self) -> np.random.Generator:
        return np.random.default_rng((self._seed, self.epoch, self._cell))

    def next_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        while True:
            if self._iter is None:
                self._iter = self._dataset.batches(batch_size, self._epoch_rng())
            try:
                batch = next(self._iter)
                self.batch_index += 1
                return batch
            except StopIteration:
                self._iter = None
                self.epoch += 1
                self.batch_index = -1

    def state(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "batch_index": self.batch_index}

    def set_state(self, state: Dict[str, int], batch_size: int) -> None:
        """Fast-forward to just past (epoch, batch_index)."""
        self.epoch = int(state["epoch"])
        self.batch_index = -1
        self._iter = None
        if isinstance(self._dataset, FilesystemDataset):
            # One epoch is one chunk of the deterministic cycle: jump the
            # chunk cursor instead of replaying the loads.
            self._dataset.set_position(self.epoch)
        for _ in range(int(state["batch_index"]) + 1):
            self.next_batch(batch_size)


class CellDataset:
    """K per-cell ray streams -> stacked (cells, batch, ...) batches."""

    def __init__(
        self,
        cell_items: List[List[ImageMetadata]],
        near: float,
        far: float,
        ray_altitude_range: Optional[Sequence[float]],
        center_pixels: bool,
        seed: int,
        dataset_type: str = "memory",
        chunk_paths: Optional[List[Path]] = None,
        num_chunks: int = 200,
        scale_factor: int = 1,
        disk_flush_size: int = 10_000_000,
        min_chunk_rays: int = 0,
        cells: Optional[Sequence[int]] = None,
        data_index: int = 0,
        data_size: int = 1,
    ):
        """min_chunk_rays: clamp each cell's chunk count so that its chunks
        hold at least this many rays. Masked cell streams are uneven (border
        cells of a grid see a few hundred rays where central cells see
        hundreds of thousands); a global --num_chunks sized for the big
        cells would cut the small ones into chunks smaller than a batch,
        which FilesystemDataset.batches refuses. CellRunner passes 4 x the
        batch.

        cells: the cells this rank trains (default all), in the padded
        numbering: those past `len(cell_items)` are padding. data_index /
        data_size: this rank's place in its cell group."""
        self.num_cells = len(cell_items)
        self.cells = list(range(self.num_cells)) if cells is None else list(cells)
        self._data_index, self._data_size = data_index, data_size
        scope = "global" if cells is None else "private"
        self._streams: Dict[int, _CellStream] = {}
        for cell in self.cells:
            if cell >= self.num_cells:
                continue
            items = cell_items[cell]
            # Seeded as an independent job's dataset would be; the cell
            # index keeps the val-pixel draws distinct per cell.
            ds_rng = np.random.default_rng((seed, cell))
            if dataset_type == "memory":
                ds = MemoryDataset(items, near, far, ray_altitude_range,
                                   center_pixels, ds_rng, process_scope="private")
            elif dataset_type == "filesystem":
                if not chunk_paths:
                    raise ValueError("--dataset_type filesystem needs --chunk_paths")
                cell_chunks = num_chunks
                if min_chunk_rays > 0:
                    cell_chunks = max(1, min(num_chunks,
                                             self._count_rays(items) // min_chunk_rays))
                ds = FilesystemDataset(
                    items, near, far, ray_altitude_range, center_pixels,
                    [Path(p) / f"cell{cell}" for p in chunk_paths],
                    cell_chunks, scale_factor, disk_flush_size, rng=ds_rng,
                    process_scope=scope)
            else:
                raise ValueError(f"Unrecognized dataset type: {dataset_type}")
            self._streams[cell] = _CellStream(ds, seed, cell)

    @staticmethod
    def _count_rays(items: List[ImageMetadata]) -> int:
        """A cell's masked pixel count (an upper bound of its training rays:
        val views keep only their left half), from one pass over the
        masks."""
        total = 0
        for it in items:
            m = it.load_mask()
            total += int(m.sum()) if m is not None else it.W * it.H
        return total

    def next_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        """One (cells, batch_size / data_size, ...) batch of this rank's
        cells (padding included); cells advance independently."""
        if batch_size % self._data_size:
            raise ValueError(f"batch_size {batch_size} is not a multiple of the "
                             f"{self._data_size} ranks of a cell group")
        local = batch_size // self._data_size
        rows = slice(self._data_index * local, (self._data_index + 1) * local)
        per_cell = [
            {k: v[rows] for k, v in self._streams[c].next_batch(batch_size).items()}
            if c in self._streams else padding_rows(local)
            for c in self.cells]
        return {k: np.stack([b[k] for b in per_cell]) for k in per_cell[0]}

    def state(self) -> List[Optional[Dict[str, int]]]:
        """Each real cell's stream position (None for a cell this rank does
        not stream)."""
        return [self._streams[c].state() if c in self._streams else None
                for c in range(self.num_cells)]

    def set_state(self, states: List[Optional[Dict[str, int]]],
                  batch_size: int) -> None:
        if len(states) != self.num_cells:
            raise ValueError(f"{len(states)} stream states for {self.num_cells} cells")
        for cell, stream in self._streams.items():
            if states[cell] is None:
                raise ValueError(f"no stream state for cell {cell}")
            stream.set_state(states[cell], batch_size)

    def close(self) -> None:
        """Stop the chunk stores' prefetch threads."""
        for s in self._streams.values():
            if isinstance(s._dataset, FilesystemDataset):
                s._dataset.close()


def padding_rows(n: int) -> Dict[str, np.ndarray]:
    """n rows of a padding cell's synthetic stream (the JAX CellRunner's
    `_pad_batch`): origin 0, unit +z direction, interval [0.5, 1.0] inside
    the fg ellipsoid, mid-gray targets, image 0; finite on every rank
    without a real stream behind it."""
    rays = np.zeros((n, 8), np.float32)
    rays[:, 5] = 1.0
    rays[:, 6] = 0.5
    rays[:, 7] = 1.0
    return {"rgbs": np.full((n, 3), 0.5, np.float32), "rays": rays,
            "img_indices": np.zeros((n,), np.int32)}
