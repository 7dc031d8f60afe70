"""In-RAM ray dataset: load every image, pregenerate all rays.

Counterpart of the JAX package's `data/memory_dataset.py`: rays come from
the port's own `generate_image_rays` (on the CPU), rgbs stay uint8 until a
batch is built, and `batches()` yields shuffled minibatches of host numpy
arrays that the trainer moves to its device. With P ranks (a data-parallel
run, `process_scope="global"`) every rank builds the same dataset and yields
its disjoint `batch_size / P` slice of the same global shuffle (the
reference's DistributedSampler); a rank's private stream
(`process_scope="private"`, a cell's under `CellDataset`) yields whole
batches.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from mega_nerf_tpu_torch.data.dataset_utils import get_rgb_index_mask
from mega_nerf_tpu_torch.data.image_metadata import ImageMetadata
from mega_nerf_tpu_torch.ops.rays import generate_image_rays
from mega_nerf_tpu_torch.parallel.distributed import rank, world_size


class MemoryDataset:
    def __init__(
        self,
        metadata_items: List[ImageMetadata],
        near: float,
        far: float,
        ray_altitude_range: Optional[Sequence[float]],
        center_pixels: bool,
        rng: Optional[np.random.Generator] = None,
        process_scope: str = "global",
    ):
        if process_scope not in ("global", "private"):
            raise ValueError(f"process_scope {process_scope!r}")
        self._shared = process_scope == "global"
        rgb_list, ray_list, idx_list = [], [], []
        for item in metadata_items:
            data = get_rgb_index_mask(item, rng)
            if data is None:
                continue
            rgbs, indices, keep_mask = data
            rays = generate_image_rays(
                item, near, far, ray_altitude_range, center_pixels
            ).numpy()
            if keep_mask is not None:
                rays = rays[keep_mask]
            rgb_list.append(rgbs)
            ray_list.append(rays)
            idx_list.append(indices)

        self.rgbs = np.concatenate(rgb_list)  # (M, 3) uint8
        self.rays = np.concatenate(ray_list)  # (M, 8) f32
        self.img_indices = np.concatenate(idx_list)  # (M,) i32

    def __len__(self) -> int:
        return self.rgbs.shape[0]

    def batches(
        self,
        batch_size: int,
        rng: np.random.Generator,
        drop_remainder: bool = True,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch of shuffled minibatches (host numpy); `batch_size` is
        the global batch, of which each of P ranks yields its slice."""
        if drop_remainder and len(self) < batch_size:
            raise ValueError(
                f"dataset has {len(self)} rays < batch_size {batch_size}: "
                f"the epoch would contain zero batches"
            )
        procs, index = (world_size(), rank()) if self._shared else (1, 0)
        if batch_size % procs:
            raise ValueError(f"batch_size {batch_size} is not a multiple of the "
                             f"{procs} ranks")
        local = batch_size // procs
        order = rng.permutation(len(self))
        stop = (len(self) // batch_size) * batch_size if drop_remainder else len(self)
        for start in range(0, stop, batch_size):
            sel = order[start + index * local:start + (index + 1) * local]
            yield {
                "rgbs": self.rgbs[sel].astype(np.float32) / 255.0,
                "rays": self.rays[sel],
                "img_indices": self.img_indices[sel],
            }
