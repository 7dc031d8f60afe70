"""Convert a COLMAP/PixSFM sparse model into the Mega-NeRF dataset layout.

    python -m mega_nerf_tpu_torch.scripts.colmap_to_mega_nerf \
        --model_path <sparse model> --images_path <photos> \
        --output_path <dataset> --scale <pose scale factor> [--num_val 20]

Counterpart of the JAX package's `scripts/colmap_to_mega_nerf.py`: poses go
from COLMAP's RDF camera convention to the DRB world convention, are
centred on the camera bounding box's midpoint and divided by `--scale`;
images are undistorted (cv2) into `{train,val}/rgbs/`; `coordinates.pt`
and each image's metadata `.pt` (H, W, c2w, intrinsics, distortion) are
written with `data/torch_io.py`, every len/num_val-th image (by name)
going to val; `mappings.txt` pairs each photo with its metadata file.
Host work only (numpy and cv2): it takes no `--device`.

Camera models: SIMPLE_RADIAL (as the reference), SIMPLE_PINHOLE and
PINHOLE (no distortion), RADIAL and OPENCV (cv2's k1 k2 [p1 p2]).
"""

from __future__ import annotations

import argparse
from argparse import Namespace
from pathlib import Path

import numpy as np

from mega_nerf_tpu_torch.data.colmap import qvec_to_rotmat, read_model
from mega_nerf_tpu_torch.data.torch_io import save_pt
from mega_nerf_tpu_torch.parallel.distributed import main_print

RDF_TO_DRB = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])
PROGRESS_EVERY = 100  # images between progress lines


def _get_opts(args=None) -> Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model_path', type=str, required=True)
    parser.add_argument('--images_path', type=str, required=True)
    parser.add_argument('--output_path', type=str, required=True)
    parser.add_argument('--scale', type=float, required=True,
                        help='pose scale factor (brings cameras into [-1, 1])')
    parser.add_argument('--num_val', type=int, default=20)
    return parser.parse_args(args)


def camera_matrix_and_distortion(camera):
    """A COLMAP camera -> (3x3 camera matrix, cv2's (k1, k2, p1, p2))."""
    p = camera.params
    if camera.model in ("SIMPLE_RADIAL", "SIMPLE_PINHOLE", "RADIAL"):  # f, cx, cy, ...
        k = np.array([[p[0], 0, p[1]], [0, p[0], p[2]], [0, 0, 1]])
    elif camera.model in ("PINHOLE", "OPENCV"):  # fx, fy, cx, cy, ...
        k = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1]])
    else:
        raise ValueError(f"Unsupported camera model: {camera.model}")
    if camera.model == "SIMPLE_RADIAL":
        dist = np.array([p[3], 0, 0, 0])
    elif camera.model == "RADIAL":
        dist = np.array([p[3], p[4], 0, 0])
    elif camera.model == "OPENCV":
        dist = np.array(p[4:8])
    else:
        dist = np.zeros(4)
    return k, dist


def colmap_c2w_to_drb(qvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    """COLMAP world-to-camera (RDF) -> camera-to-world in DRB, (3, 4)."""
    w2c = np.eye(4)
    w2c[:3, :3] = qvec_to_rotmat(qvec)
    w2c[:3, 3] = tvec
    c2w = np.linalg.inv(w2c)
    return np.hstack([RDF_TO_DRB @ c2w[:3, :3] @ np.linalg.inv(RDF_TO_DRB),
                      RDF_TO_DRB @ c2w[:3, 3:]])


def main(hparams: Namespace) -> None:
    import cv2

    cameras, images = read_model(hparams.model_path)
    c2ws = {image.id: colmap_c2w_to_drb(image.qvec, image.tvec)
            for image in images.values()}

    positions = np.stack([c2w[:3, 3] for c2w in c2ws.values()])
    main_print(f"{positions.shape[0]} images")
    max_values = positions.max(axis=0)
    min_values = positions.min(axis=0)
    origin = (max_values + min_values) * 0.5
    diagonal = np.linalg.norm(positions - origin, axis=-1).max()
    main_print(origin, diagonal, max_values, min_values)

    output_path = Path(hparams.output_path)
    output_path.mkdir(parents=True)
    for split in ("train", "val"):
        (output_path / split / "metadata").mkdir(parents=True)
        (output_path / split / "rgbs").mkdir(parents=True)

    images_path = Path(hparams.images_path)
    val_stride = max(1, int(positions.shape[0] / hparams.num_val))
    ordered = sorted(images.values(), key=lambda x: x.name)
    with (output_path / "mappings.txt").open("w") as f:
        for i, image in enumerate(ordered):
            split_dir = output_path / ("val" if i % val_stride == 0 else "train")

            distorted = cv2.imread(str(images_path / image.name))
            camera_matrix, distortion = camera_matrix_and_distortion(
                cameras[image.camera_id])
            undistorted = cv2.undistort(distorted, camera_matrix, distortion)
            cv2.imwrite(str(split_dir / "rgbs" / f"{i:06d}.jpg"), undistorted)

            camera_in_drb = c2ws[image.id].copy()
            camera_in_drb[:, 3] = (camera_in_drb[:, 3] - origin) / hparams.scale
            if not np.logical_and(camera_in_drb >= -1, camera_in_drb <= 1).all():
                raise ValueError("increase --scale: poses fall outside [-1, 1]")

            metadata_name = f"{i:06d}.pt"
            # The final column remap into the renderer's DRB camera frame
            # (reference colmap_to_mega_nerf.py:408-411).
            c2w_final = np.concatenate(
                [camera_in_drb[:, 1:2], -camera_in_drb[:, :1], camera_in_drb[:, 2:4]],
                axis=-1).astype(np.float32)
            save_pt({
                "H": int(distorted.shape[0]),
                "W": int(distorted.shape[1]),
                "c2w": c2w_final,
                "intrinsics": np.array([camera_matrix[0][0], camera_matrix[1][1],
                                        camera_matrix[0][2], camera_matrix[1][2]],
                                       np.float32),
                "distortion": distortion.astype(np.float32),
            }, split_dir / "metadata" / metadata_name)
            f.write(f"{image.name},{metadata_name}\n")
            if (i + 1) % PROGRESS_EVERY == 0 or i + 1 == len(ordered):
                main_print(f"{i + 1} / {len(ordered)} images written")

    save_pt({"origin_drb": origin, "pose_scale_factor": hparams.scale},
            output_path / "coordinates.pt")


if __name__ == '__main__':
    main(_get_opts())
