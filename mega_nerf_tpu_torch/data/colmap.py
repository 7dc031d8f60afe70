"""Minimal COLMAP sparse-model readers (bin and txt), and a txt writer.

The port's own copy of the JAX package's `data/colmap.py` (numpy and
struct only), for `scripts/colmap_to_mega_nerf.py`. The format is
COLMAP's (colmap.github.io/format.html); only what the dataset converter
needs is read: cameras and images (a model's points3D are not read).
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) w x y z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(f, fmt: str):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: Path) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            cameras[cam_id] = ColmapCamera(cam_id, name, width, height, params)
    return cameras


def read_images_bin(path: Path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (img_id,) = _read(f, "<i")
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            (camera_id,) = _read(f, "<i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_points,) = _read(f, "<Q")
            f.seek(24 * num_points, 1)  # skip (x f64, y f64, id i64) triples
            images[img_id] = ColmapImage(
                img_id, qvec, tvec, camera_id, name.decode("utf-8")
            )
    return images


def read_cameras_txt(path: Path) -> Dict[int, ColmapCamera]:
    cameras = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cam_id = int(parts[0])
        cameras[cam_id] = ColmapCamera(
            cam_id, parts[1], int(parts[2]), int(parts[3]),
            np.array([float(x) for x in parts[4:]]),
        )
    return cameras


def read_images_txt(path: Path) -> Dict[int, ColmapImage]:
    images = {}
    expecting_points = False  # every header line is followed by a (possibly
    # empty) 2D-point line
    for raw in Path(path).read_text().splitlines():
        line = raw.strip()
        if line.startswith("#"):
            continue
        if expecting_points:
            expecting_points = False
            continue
        if not line:
            continue
        parts = line.split()
        img_id = int(parts[0])
        images[img_id] = ColmapImage(
            img_id,
            np.array([float(x) for x in parts[1:5]]),
            np.array([float(x) for x in parts[5:8]]),
            int(parts[8]),
            parts[9],
        )
        expecting_points = True
    return images


def read_model(path) -> Tuple[Dict[int, ColmapCamera], Dict[int, ColmapImage]]:
    """Auto-detect bin vs txt model in `path` -> (cameras, images)."""
    path = Path(path)
    if (path / "cameras.bin").exists():
        return read_cameras_bin(path / "cameras.bin"), read_images_bin(
            path / "images.bin"
        )
    if (path / "cameras.txt").exists():
        return read_cameras_txt(path / "cameras.txt"), read_images_txt(
            path / "images.txt"
        )
    raise FileNotFoundError(f"No COLMAP model (bin or txt) found in {path}")


def write_model_txt(path, cameras: Dict[int, ColmapCamera],
                    images: Dict[int, ColmapImage]) -> None:
    """Write a txt model (used by tests and tooling)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "cameras.txt", "w") as f:
        for cam in cameras.values():
            params = " ".join(str(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")
    with open(path / "images.txt", "w") as f:
        for img in images.values():
            q = " ".join(str(float(v)) for v in img.qvec)
            t = " ".join(str(float(v)) for v in img.tvec)
            f.write(f"{img.id} {q} {t} {img.camera_id} {img.name}\n\n")
