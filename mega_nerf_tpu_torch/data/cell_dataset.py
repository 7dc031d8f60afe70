"""Per-cell masked ray streams for training every submodule in one process.

Counterpart of the JAX package's `data/cell_dataset.py` for one process
(every cell's stream built here). The reference trains each spatial
submodule as an independent job on its own cluster-masked ray stream (one
`train.py --cluster_mask_path masks/{i}` per centroid); this module builds
those K streams side by side and stacks them into `(cells, batch, ...)`
batches:

- each cell has its own dataset (a MemoryDataset, or a FilesystemDataset
  with its own chunk store under `{chunk_path}/cell{c}`), built with the
  rng `default_rng((seed, cell))`;
- streams cycle independently, each epoch shuffled by
  `default_rng((seed, epoch, cell))`: cells never synchronize on epoch
  boundaries (their streams have different lengths);
- stream positions (epoch, batch_index per cell) are checkpointable and
  fast-forward deterministically for an exact mid-stream resume.
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
    ):
        """min_chunk_rays: clamp each cell's chunk count so that its chunks
        hold at least this many rays. Masked cell streams are uneven (border
        cells of a grid see a few hundred rays where central cells see
        hundreds of thousands); a global --num_chunks sized for the big
        cells would cut the small ones into chunks smaller than a batch,
        which FilesystemDataset.batches refuses. CellRunner passes 4 x the
        batch."""
        self.num_cells = len(cell_items)
        self._streams: List[_CellStream] = []
        for cell, items in enumerate(cell_items):
            # Seeded as an independent job's dataset would be; the cell
            # index keeps the val-pixel draws distinct per cell.
            ds_rng = np.random.default_rng((seed, cell))
            if dataset_type == "memory":
                ds = MemoryDataset(items, near, far, ray_altitude_range,
                                   center_pixels, ds_rng)
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
                    cell_chunks, scale_factor, disk_flush_size, rng=ds_rng)
            else:
                raise ValueError(f"Unrecognized dataset type: {dataset_type}")
            self._streams.append(_CellStream(ds, seed, cell))

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
        """One (num_cells, batch_size, ...) batch; cells advance
        independently."""
        per_cell = [s.next_batch(batch_size) for s in self._streams]
        return {k: np.stack([b[k] for b in per_cell]) for k in per_cell[0]}

    def state(self) -> List[Dict[str, int]]:
        return [s.state() for s in self._streams]

    def set_state(self, states: List[Dict[str, int]], batch_size: int) -> None:
        if len(states) != self.num_cells:
            raise ValueError(f"{len(states)} stream states for {self.num_cells} cells")
        for stream, st in zip(self._streams, states):
            stream.set_state(st, batch_size)

    def close(self) -> None:
        """Stop the chunk stores' prefetch threads."""
        for s in self._streams:
            if isinstance(s._dataset, FilesystemDataset):
                s._dataset.close()
