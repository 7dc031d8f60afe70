"""Undistort raw photos into a converted dataset (the UrbanScene3D flow).

    python -m mega_nerf_tpu_torch.scripts.copy_images \
        --image_path <raw photos> --dataset_path <dataset> [--workers 8]

Counterpart of the JAX package's `scripts/copy_images.py`: the dataset's
`mappings.txt` pairs each raw photo with a metadata file; each photo is
undistorted with that metadata's intrinsics and distortion (cv2) and
written to its split's `rgbs/` under the metadata's stem, by a pool of
`--workers` threads (decode, undistort and encode are independent host IO
per photo). Host work only (numpy and cv2): it takes no `--device`.
"""

from __future__ import annotations

import argparse
from argparse import Namespace
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from mega_nerf_tpu_torch.data.torch_io import load_pt
from mega_nerf_tpu_torch.parallel.distributed import main_print


def _get_images_opts(args=None) -> Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument('--image_path', type=str, required=True)
    parser.add_argument('--dataset_path', type=str, required=True)
    parser.add_argument('--workers', type=int, default=8)
    return parser.parse_args(args)


def _metadata_index(dataset_path: Path) -> Dict[str, Path]:
    """metadata file name -> its path, across both splits."""
    return {p.name: p for split in ('train', 'val')
            for p in (dataset_path / split / 'metadata').iterdir()}


def undistort_image(raw_path: Path, metadata_path: Path, out_dir: Path) -> Path:
    """Undistort one photo with its metadata's camera -> the written path;
    the output must be the metadata's W x H."""
    import cv2

    metadata = load_pt(metadata_path)
    fx, fy, cx, cy = np.asarray(metadata['intrinsics'], np.float64)
    camera_matrix = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    distorted = cv2.imread(str(raw_path))
    if distorted is None:
        raise FileNotFoundError(f"cannot read {raw_path}")
    undistorted = cv2.undistort(distorted, camera_matrix,
                                np.asarray(metadata['distortion']))
    h, w = undistorted.shape[:2]
    if (h, w) != (metadata['H'], metadata['W']):
        raise ValueError(f"{raw_path}: {w}x{h}, its metadata says "
                         f"{metadata['W']}x{metadata['H']}")
    out = out_dir / f"{metadata_path.stem}{raw_path.suffix}"
    cv2.imwrite(str(out), undistorted)
    return out


def main(hparams: Namespace) -> None:
    image_path = Path(hparams.image_path)
    dataset_path = Path(hparams.dataset_path)
    for split in ('train', 'val'):
        (dataset_path / split / 'rgbs').mkdir(exist_ok=True)

    index = _metadata_index(dataset_path)
    jobs: List[Tuple[Path, Path]] = []
    for line in (dataset_path / 'mappings.txt').read_text().splitlines():
        image_name, metadata_name = line.strip().split(',')
        if metadata_name not in index:
            raise FileNotFoundError(f"no metadata for {metadata_name}")
        jobs.append((image_path / image_name, index[metadata_name]))

    with ThreadPoolExecutor(max_workers=getattr(hparams, 'workers', 8)) as pool:
        futures = [pool.submit(undistort_image, raw, meta, meta.parent.parent / 'rgbs')
                   for raw, meta in jobs]
        for f in futures:
            f.result()
    main_print(f"{len(jobs)} images undistorted into {dataset_path}")


if __name__ == '__main__':
    main(_get_images_opts())
