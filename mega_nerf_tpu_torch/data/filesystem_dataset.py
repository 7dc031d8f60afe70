"""Disk-backed shuffled ray store: the reference's parquet chunk contract.

Counterpart of the JAX package's `data/filesystem_dataset.py` for one
process. The on-disk format is the same, so a store written by either
package reads back in the other:

- `{index:06d}.parquet` files with BROTLI compression, allocated over one
  or more scratch directories in proportion to their free space;
- columns `img_indices` (u16, or i32 past 65,535 images), `rgbs_0..2`
  (u8), then `pixel_indices` (i32, when every image shares W, H and
  intrinsics: rays are regenerated at load time) or `rays_0..7` (f32);
- a `metadata.pt` stamp per directory with `images`, `scale_factor` and
  `chunk_rows` (rows per chunk file), plus near, far, `center_pixels` and
  `ray_altitude_range` when rays are materialized; written only after
  every writer has closed, so a stamped directory is complete.

At run time: the chunk after the current one loads on a one-worker
prefetch thread while the current one trains; `position` counts the
chunks served and `set_position` fast-forwards the deterministic cycle
(checkpoint resume: the runner's epoch is the chunk position). A chunk's
rays are regenerated on the host in float32 by one batched product
(`ops.rays.get_rays_flat`).

With P ranks and a store shared by all of them (`process_scope="global"`),
rank 0 checks or writes the store while the others wait at a barrier, and
each rank yields `batch_size / P` rows a step in one of two modes:

- per-rank chunk streams (a stamped store of at least P chunks): epoch e of
  rank p reads chunk `(e * P + p) % N`, and the epoch's batch count is the
  smallest of its P chunks' `chunk_rows` over the local batch, the same on
  every rank without communication;
- a shared chunk (a store without `chunk_rows`, such as the reference's):
  every rank reads the same chunk and takes its slice of one shuffle.

A rank's private store (`process_scope="private"`, a cell's under a
multi-process `CellRunner`) is written by that rank with no barrier and
yields whole batches.
"""

from __future__ import annotations

import math
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from mega_nerf_tpu_torch.data.dataset_utils import get_rgb_index_mask
from mega_nerf_tpu_torch.data.image_metadata import ImageMetadata
from mega_nerf_tpu_torch.data.native_packer import shuffle_gather
from mega_nerf_tpu_torch.data.torch_io import load_pt, save_pt
from mega_nerf_tpu_torch.ops.rays import (
    generate_image_rays,
    get_ray_directions,
    get_rays_flat,
)
from mega_nerf_tpu_torch.parallel.distributed import (
    barrier,
    is_master,
    main_print,
    rank,
    world_size,
)


def _check(condition: bool, message: str) -> None:
    """A stale or incomplete store raises AssertionError, as in the JAX
    package, also under `python -O`."""
    if not condition:
        raise AssertionError(message)


class FilesystemDataset:
    def __init__(
        self,
        metadata_items: List[ImageMetadata],
        near: float,
        far: float,
        ray_altitude_range: Optional[Sequence[float]],
        center_pixels: bool,
        chunk_paths: List[Path],
        num_chunks: int,
        scale_factor: int,
        disk_flush_size: int,
        rng: Optional[np.random.Generator] = None,
        process_scope: str = "global",
    ):
        if process_scope not in ("global", "private"):
            raise ValueError(f"process_scope {process_scope!r}")
        private = process_scope == "private"
        self._near = near
        self._far = far
        self._ray_altitude_range = ray_altitude_range
        self._center_pixels = center_pixels
        self._rng = rng if rng is not None else np.random.default_rng(0)
        self._c2ws = np.stack(
            [np.asarray(x.c2w, np.float32) for x in metadata_items])

        intrinsics = np.stack([
            np.concatenate([[x.W, x.H], np.asarray(x.intrinsics)])
            for x in metadata_items
        ])
        if np.abs(intrinsics - intrinsics[0]).max() == 0:
            first = metadata_items[0]
            print(f"All intrinsics identical: W: {first.W} H: {first.H}, "
                  f"intrinsics: {first.intrinsics}", flush=True)
            fx, fy, cx, cy = (float(v) for v in first.intrinsics)
            self._directions = get_ray_directions(
                first.W, first.H, fx, fy, cx, cy, center_pixels
            ).reshape(-1, 3).numpy()
        else:
            print("Differing intrinsics", flush=True)
            self._directions = None

        # Rank 0 probes or writes first; the others look only after the
        # barrier, or they would see a half-written store.
        if private or is_master():
            existing = self._check_existing_paths(
                chunk_paths, center_pixels, scale_factor, len(metadata_items))
            if existing is not None:
                print(f"Reusing {len(existing)} chunks from previous run", flush=True)
                self._parquet_paths = existing
            else:
                self._parquet_paths = []
                self._write_chunks(metadata_items, chunk_paths, num_chunks,
                                   scale_factor, disk_flush_size)
        if not private:
            barrier("chunk_store_written")
            if not is_master():
                self._parquet_paths = self._check_existing_paths(
                    chunk_paths, center_pixels, scale_factor, len(metadata_items)) or []
        self._parquet_paths.sort(key=lambda x: x.name)
        # Rows per chunk file (None for stores written without the field,
        # such as the reference's): what per-rank chunk streams need.
        self._chunk_rows = self._load_chunk_rows(chunk_paths)
        self._procs, self._index = (1, 0) if private else (world_size(), rank())
        self._shard_chunks = (self._procs > 1 and self._chunk_rows is not None
                              and len(self._parquet_paths) >= self._procs)
        if self._procs > 1:
            main_print("Multi-process data feeding: " + (
                "per-rank chunk streams" if self._shard_chunks
                else "shared chunks, sliced shuffle"))

        self.position = 0  # chunks served so far (resume token)
        self._executor = ThreadPoolExecutor(max_workers=1)
        self._future = self._executor.submit(self._load_chunk_inner, 0)

    # ------------------------------------------------------------------ read

    def set_position(self, position: int) -> None:
        """Fast-forward the deterministic chunk cycle (checkpoint resume)."""
        if position != self.position:
            if not self._future.cancel():
                self._future.result()  # running: let it finish, raise its error
            self.position = position
            self._future = self._executor.submit(self._load_chunk_inner, position)

    def load_chunk(self) -> Dict[str, np.ndarray]:
        """Block on the prefetched chunk, kick off the next one."""
        chunk = self._future.result()
        self.position += 1
        self._future = self._executor.submit(self._load_chunk_inner, self.position)
        return chunk

    def close(self) -> None:
        """Stop the prefetch thread (a load under way finishes first)."""
        self._future.cancel()
        self._executor.shutdown(wait=True)

    def _chunk_for(self, position: int) -> Path:
        n = len(self._parquet_paths)
        if self._shard_chunks:
            return self._parquet_paths[(position * self._procs + self._index) % n]
        return self._parquet_paths[position % n]

    def _aligned_num_batches(self, position: int, local: int) -> int:
        """Epoch `position`'s batch count under per-rank chunk streams: the
        smallest of its P chunks' rows over the local batch, from the
        stamps, so every rank takes the same number of steps."""
        n = len(self._parquet_paths)
        return min(
            self._chunk_rows[self._parquet_paths[(position * self._procs + p) % n].name]
            for p in range(self._procs)) // local

    def _load_chunk_inner(self, position: int) -> Dict[str, np.ndarray]:
        path = self._chunk_for(position)
        table = pq.read_table(path)
        img_indices = table["img_indices"].to_numpy().astype(np.int32)
        rgbs = np.stack([table[f"rgbs_{i}"].to_numpy() for i in range(3)], axis=1)

        if self._directions is not None:
            pixel_indices = table["pixel_indices"].to_numpy()
            rays = get_rays_flat(
                torch.from_numpy(self._directions[pixel_indices]),
                torch.from_numpy(self._c2ws[img_indices]),
                self._near, self._far, self._ray_altitude_range,
            ).numpy()
        else:
            rays = np.stack(
                [table[f"rays_{i}"].to_numpy() for i in range(8)], axis=1
            ).astype(np.float32)

        return {"rgbs": rgbs, "rays": rays, "img_indices": img_indices}

    def batches(
        self,
        batch_size: int,
        rng: np.random.Generator,
        drop_remainder: bool = True,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Load the next chunk and yield its shuffled minibatches;
        `batch_size` is the global batch, of which each of P ranks yields
        its rows."""
        if batch_size % self._procs:
            raise ValueError(f"batch_size {batch_size} is not a multiple of the "
                             f"{self._procs} ranks")
        local = batch_size // self._procs
        epoch_position = self.position
        chunk = self.load_chunk()
        n = chunk["rgbs"].shape[0]
        if self._shard_chunks:
            # Each rank its own chunk; the stamps align the step counts.
            order = rng.permutation(n)
            num_batches = self._aligned_num_batches(epoch_position, local)
            if drop_remainder and num_batches == 0:
                raise ValueError(
                    f"epoch {epoch_position}: the smallest chunk of this cycle "
                    f"step holds fewer rays than the per-rank batch {local}; "
                    f"rewrite the store with fewer chunks")
            for b in range(num_batches):
                sel = order[b * local:(b + 1) * local]
                yield {
                    "rgbs": chunk["rgbs"][sel].astype(np.float32) / 255.0,
                    "rays": chunk["rays"][sel],
                    "img_indices": chunk["img_indices"][sel],
                }
            return
        if drop_remainder and n < batch_size:
            # A chunk smaller than one batch would yield no batch, and the
            # training loop would load chunks forever without a step.
            raise ValueError(
                f"chunk has {n} rays < batch_size {batch_size}; rewrite the "
                f"chunk store with fewer chunks (--num_chunks) or shrink the "
                f"batch"
            )
        order = rng.permutation(n)
        stop = (n // batch_size) * batch_size if drop_remainder else n
        for start in range(0, stop, batch_size):
            sel = order[start + self._index * local:start + (self._index + 1) * local]
            yield {
                "rgbs": chunk["rgbs"][sel].astype(np.float32) / 255.0,
                "rays": chunk["rays"][sel],
                "img_indices": chunk["img_indices"][sel],
            }

    # ----------------------------------------------------------------- write

    def _write_chunks(
        self,
        metadata_items: List[ImageMetadata],
        chunk_paths: List[Path],
        num_chunks: int,
        scale_factor: int,
        disk_flush_size: int,
    ) -> None:
        path_frees = []
        for chunk_path in chunk_paths:
            chunk_path.mkdir(parents=True)
            path_frees.append(shutil.disk_usage(chunk_path).free)
        total_free = sum(path_frees)

        max_index = max(x.image_index for x in metadata_items)
        if max_index <= np.iinfo(np.uint16).max:
            img_dtype = np.uint16
        else:
            _check(max_index <= np.iinfo(np.int32).max,
                   f"image index {max_index} does not fit int32")
            img_dtype = np.int32
        print(f"Max image index is {max_index}: using dtype: {img_dtype}",
              flush=True)

        writers = []
        for chunk_path, path_free in zip(chunk_paths, path_frees):
            # At least one chunk for every path.
            allocated = max(int(path_free / total_free * num_chunks), 1)
            print(f"Allocating {allocated} chunks to dataset path {chunk_path}",
                  flush=True)
            for _ in range(allocated):
                parquet_path = chunk_path / f"{len(writers):06d}.parquet"
                self._parquet_paths.append(parquet_path)
                fields = [("img_indices", pa.from_numpy_dtype(img_dtype))]
                fields += [(f"rgbs_{i}", pa.uint8()) for i in range(3)]
                if self._directions is not None:
                    fields.append(("pixel_indices", pa.int32()))
                else:
                    fields += [(f"rays_{i}", pa.float32()) for i in range(8)]
                writers.append(pq.ParquetWriter(
                    parquet_path, pa.schema(fields), compression="BROTLI"))
        print(f"{len(writers)} chunks allocated", flush=True)

        self._written_rows = [0] * len(writers)
        rgbs_buf: List[np.ndarray] = []
        rays_buf: List[np.ndarray] = []
        idx_buf: List[np.ndarray] = []
        in_memory = 0

        if self._directions is not None:
            all_pixel_indices = np.arange(self._directions.shape[0], dtype=np.int32)

        with ThreadPoolExecutor(max_workers=min(8, len(writers))) as executor:
            pending = []
            for item in metadata_items:
                data = get_rgb_index_mask(item, self._rng)
                if data is None:
                    continue
                image_rgbs, img_indices, keep_mask = data
                rgbs_buf.append(image_rgbs)
                idx_buf.append(img_indices)
                in_memory += len(image_rgbs)

                if self._directions is not None:
                    pix = all_pixel_indices
                    if keep_mask is not None:
                        pix = pix[keep_mask]
                    rays_buf.append(pix)
                else:
                    image_rays = generate_image_rays(
                        item, self._near, self._far, self._ray_altitude_range,
                        self._center_pixels,
                    ).numpy()
                    if keep_mask is not None:
                        image_rays = image_rays[keep_mask]
                    rays_buf.append(image_rays)

                if in_memory >= disk_flush_size:
                    for f in pending:
                        f.result()
                    pending = self._flush(
                        executor, rgbs_buf, rays_buf, idx_buf, writers, img_dtype)
                    rgbs_buf, rays_buf, idx_buf, in_memory = [], [], [], 0

            for f in pending:
                f.result()
            if in_memory > 0:
                for f in self._flush(
                        executor, rgbs_buf, rays_buf, idx_buf, writers, img_dtype):
                    f.result()

        # Close (parquet footers) BEFORE stamping: the stamp is the
        # completeness guard `_check_existing_paths` trusts.
        for w in writers:
            w.close()

        rows_by_name = {
            p.name: r for p, r in zip(self._parquet_paths, self._written_rows)
        }
        for chunk_path in chunk_paths:
            stamp = {"images": len(metadata_items), "scale_factor": scale_factor}
            stamp["chunk_rows"] = {
                p.name: rows_by_name[p.name]
                for p in self._parquet_paths if p.parent == chunk_path
            }
            if self._directions is None:
                stamp.update(
                    near=self._near,
                    far=self._far,
                    center_pixels=self._center_pixels,
                    ray_altitude_range=(
                        list(self._ray_altitude_range)
                        if self._ray_altitude_range is not None else None
                    ),
                )
            save_pt(stamp, chunk_path / "metadata.pt")
        print("Finished writing chunks to dataset paths", flush=True)

    def _flush(self, executor, rgbs_buf, rays_buf, idx_buf, writers, img_dtype):
        """Shuffle the buffered rows together and append an equal slice to
        every chunk file; -> the append futures."""
        rgbs = np.concatenate(rgbs_buf)
        rays = np.concatenate(rays_buf)
        indices = np.concatenate(idx_buf)
        perm = self._rng.permutation(rgbs.shape[0])
        rgbs = shuffle_gather(rgbs, perm)
        rays = shuffle_gather(rays, perm)
        indices = shuffle_gather(indices, perm)

        num_chunks = len(writers)
        chunk_size = math.ceil(rgbs.shape[0] / num_chunks)
        for i in range(num_chunks):
            lo = min(i * chunk_size, rgbs.shape[0])
            hi = min((i + 1) * chunk_size, rgbs.shape[0])
            self._written_rows[i] += hi - lo

        def append(i: int) -> None:
            sl = slice(i * chunk_size, (i + 1) * chunk_size)
            columns = {"img_indices": indices[sl].astype(img_dtype)}
            for c in range(3):
                columns[f"rgbs_{c}"] = rgbs[sl, c]
            if self._directions is not None:
                columns["pixel_indices"] = rays[sl].astype(np.int32)
            else:
                for c in range(8):
                    columns[f"rays_{c}"] = rays[sl, c].astype(np.float32)
            writers[i].write_table(pa.table(columns))

        return [executor.submit(append, i) for i in range(num_chunks)]

    # ------------------------------------------------------------------ misc

    @staticmethod
    def _load_chunk_rows(chunk_paths: List[Path]) -> Optional[Dict[str, int]]:
        """name -> rows from the stamps, or None for a store whose stamps
        lack the field."""
        rows: Dict[str, int] = {}
        for chunk_path in chunk_paths:
            stamp_path = chunk_path / "metadata.pt"
            if not stamp_path.exists():
                return None
            stamp = load_pt(stamp_path)
            if "chunk_rows" not in stamp:
                return None
            rows.update({str(k): int(v) for k, v in stamp["chunk_rows"].items()})
        return rows

    def _check_existing_paths(
        self,
        chunk_paths: List[Path],
        center_pixels: bool,
        scale_factor: int,
        images: int,
    ) -> Optional[List[Path]]:
        """The parquet files of a complete store matching this dataset, or
        None when no chunk path exists yet. A stale stamp raises."""
        parquet_files: List[Path] = []
        num_exist = 0
        for chunk_path in chunk_paths:
            if not chunk_path.exists():
                continue
            stamp_path = chunk_path / "metadata.pt"
            _check(stamp_path.exists(),
                   f"{chunk_path} has no metadata.pt stamp (incomplete write?)")
            stamp = load_pt(stamp_path)
            _check(stamp["images"] == images,
                   f"{chunk_path} holds {stamp['images']} images, not {images}")
            _check(stamp["scale_factor"] == scale_factor,
                   f"{chunk_path} scale factor {stamp['scale_factor']}, "
                   f"not {scale_factor}")
            if self._directions is None:
                _check(stamp["near"] == self._near, f"{chunk_path}: near differs")
                _check(stamp["far"] == self._far, f"{chunk_path}: far differs")
                _check(stamp["center_pixels"] == center_pixels,
                       f"{chunk_path}: center_pixels differs")
                if self._ray_altitude_range is not None:
                    _check(np.allclose(
                        np.asarray(stamp["ray_altitude_range"], np.float32),
                        np.asarray(self._ray_altitude_range, np.float32)),
                        f"{chunk_path}: ray_altitude_range differs")
                else:
                    _check(stamp["ray_altitude_range"] is None,
                           f"{chunk_path}: ray_altitude_range differs")
            parquet_files += [child for child in chunk_path.iterdir()
                              if child.name != "metadata.pt"]
            num_exist += 1
        if num_exist == 0:
            return None
        _check(num_exist == len(chunk_paths),
               "some chunk paths exist and others do not")
        return parquet_files
