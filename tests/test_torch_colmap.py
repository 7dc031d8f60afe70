"""The port's COLMAP import against the JAX package's, on a tiny model.

Mirrors `tests/test_colmap.py`: the quaternion round trip; `read_model` on
a txt and a bin model; `scripts/colmap_to_mega_nerf.py` end to end; and
`scripts/copy_images.py`. The same synthetic sparse model (two cameras,
SIMPLE_RADIAL and OPENCV, six photos on a ring) goes through both
packages: `coordinates.pt` and every metadata file agree to 1e-6,
`mappings.txt` and every image file are byte-equal.
"""

import shutil
import struct
from argparse import Namespace

import numpy as np
import pytest

import scripts.colmap_to_mega_nerf as j_conv
import scripts.copy_images as j_copy
from mega_nerf_tpu.data import colmap as j_colmap
from mega_nerf_tpu.data.torch_io import load_pt as j_load_pt
from mega_nerf_tpu_torch.data import colmap
from mega_nerf_tpu_torch.data.torch_io import load_coordinates, load_pt
from mega_nerf_tpu_torch.scripts import colmap_to_mega_nerf, copy_images
from tests.test_colmap import _rot_to_qvec

CAMERAS = {1: ("SIMPLE_RADIAL", [30.0, 16.0, 12.0, 0.01]),
           2: ("OPENCV", [29.0, 31.0, 15.5, 12.5, 0.02, -0.01, 0.001, 0.002])}


def test_qvec_identity_and_roundtrip():
    np.testing.assert_allclose(colmap.qvec_to_rotmat(np.array([1.0, 0, 0, 0])), np.eye(3),
                               atol=1e-9)
    rng = np.random.default_rng(0)
    for _ in range(4):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        angle = rng.uniform(0.1, 2.5)
        q = np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])
        r = colmap.qvec_to_rotmat(q)
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-9)
        np.testing.assert_allclose(_rot_to_qvec(r), q, atol=1e-9)
        np.testing.assert_array_equal(r, j_colmap.qvec_to_rotmat(q))


def _write_model_bin(path, cameras, images):
    """COLMAP's binary model: cameras.bin and images.bin (no 2D points)."""
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            f.write(struct.pack("<iiQQ", cam.id, colmap.MODEL_NAME_TO_ID[cam.model],
                                cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))
    with open(path / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for img in images.values():
            f.write(struct.pack("<i4d3di", img.id, *img.qvec, *img.tvec, img.camera_id))
            f.write(img.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 1) + struct.pack("<ddq", 1.5, 2.5, -1))


@pytest.fixture()
def colmap_scene(tmp_path):
    """A sparse model (txt and bin) of 6 cameras ringed around the origin,
    and their distorted photos."""
    import cv2

    rng = np.random.default_rng(1)
    cameras = {i: colmap.ColmapCamera(i, model, 32, 24, np.array(params))
               for i, (model, params) in CAMERAS.items()}
    images = {}
    (tmp_path / "photos").mkdir()
    for i in range(6):
        theta = 2 * np.pi * i / 6
        pos = 3.0 * np.array([np.cos(theta), np.sin(theta), 0.4])
        angle = 0.2 * rng.normal()
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        q = np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])
        tvec = -colmap.qvec_to_rotmat(q) @ pos  # the camera centre at pos
        # Names out of id order: the split follows the sorted names.
        images[i + 1] = colmap.ColmapImage(i + 1, q, tvec, 1 + i % 2, f"img_{(5 * i) % 6}.jpg")
        cv2.imwrite(str(tmp_path / "photos" / f"img_{(5 * i) % 6}.jpg"),
                    rng.integers(0, 255, (24, 32, 3), np.uint8))
    colmap.write_model_txt(tmp_path / "sparse_txt", cameras, images)
    _write_model_bin(tmp_path / "sparse_bin", cameras, images)
    return tmp_path


@pytest.mark.parametrize("kind", ["txt", "bin"])
def test_read_model_matches_jax(colmap_scene, kind):
    cameras, images = colmap.read_model(colmap_scene / f"sparse_{kind}")
    j_cameras, j_images = j_colmap.read_model(colmap_scene / f"sparse_{kind}")
    assert len(cameras) == 2 and len(images) == 6
    assert cameras[1].model == "SIMPLE_RADIAL" and cameras[2].model == "OPENCV"
    assert images[1].name == "img_0.jpg" and images[2].camera_id == 2
    np.testing.assert_allclose(np.linalg.norm(images[3].qvec), 1.0, atol=1e-6)
    for got, want in ((cameras, j_cameras), (images, j_images)):
        assert got.keys() == want.keys()
        for k in want:
            for field, value in vars(want[k]).items():
                np.testing.assert_array_equal(getattr(got[k], field), value,
                                              err_msg=f"{k} {field}")


def _convert(module, scene, out):
    module.main(Namespace(model_path=str(scene / "sparse_bin"),
                          images_path=str(scene / "photos"), output_path=str(out),
                          scale=10.0, num_val=3))


def _assert_same_datasets(got, want, images=True):
    np.testing.assert_allclose(load_coordinates(got)["origin_drb"],
                               j_load_pt(want / "coordinates.pt")["origin_drb"], atol=1e-6)
    assert load_pt(got / "coordinates.pt")["pose_scale_factor"] == 10.0
    assert (got / "mappings.txt").read_bytes() == (want / "mappings.txt").read_bytes()
    for split in ("train", "val"):
        names = sorted(p.name for p in (want / split / "metadata").iterdir())
        assert sorted(p.name for p in (got / split / "metadata").iterdir()) == names
        for name in names:
            g, w = load_pt(got / split / "metadata" / name), j_load_pt(
                want / split / "metadata" / name)
            assert g.keys() == w.keys() and (g["H"], g["W"]) == (w["H"], w["W"]) == (24, 32)
            for key in ("c2w", "intrinsics", "distortion"):
                assert g[key].dtype == w[key].dtype == np.float32, key
                np.testing.assert_allclose(g[key], w[key], atol=1e-6, err_msg=f"{name} {key}")
        if images:
            files = sorted(p.name for p in (want / split / "rgbs").iterdir())
            assert sorted(p.name for p in (got / split / "rgbs").iterdir()) == files
            for name in files:
                assert (got / split / "rgbs" / name).read_bytes() == \
                    (want / split / "rgbs" / name).read_bytes(), name


def test_converter_end_to_end_matches_jax(colmap_scene):
    _convert(colmap_to_mega_nerf, colmap_scene, colmap_scene / "port")
    _convert(j_conv, colmap_scene, colmap_scene / "jax")
    out = colmap_scene / "port"
    _assert_same_datasets(out, colmap_scene / "jax")
    val = sorted((out / "val" / "metadata").glob("*.pt"))
    train = sorted((out / "train" / "metadata").glob("*.pt"))
    assert len(val) == 3 and len(train) == 3  # every 2nd image (6 // num_val=3)
    c2w = np.asarray(load_pt(train[0])["c2w"])
    np.testing.assert_allclose(c2w[:, :3] @ c2w[:, :3].T, np.eye(3), atol=1e-5)
    positions = np.stack([np.asarray(load_pt(p)["c2w"])[:, 3] for p in train + val])
    assert np.abs(positions).max() <= 0.5  # scale 10 on a radius-3 ring
    assert len(np.unique(positions.round(4), axis=0)) == 6


def test_copy_images_matches_jax(colmap_scene):
    _convert(colmap_to_mega_nerf, colmap_scene, colmap_scene / "port")
    shutil.copytree(colmap_scene / "port", colmap_scene / "jax")
    for root in ("port", "jax"):  # metadata and mappings.txt, no rgbs
        for split in ("train", "val"):
            shutil.rmtree(colmap_scene / root / split / "rgbs")
    photos = str(colmap_scene / "photos")
    copy_images.main(Namespace(image_path=photos, dataset_path=str(colmap_scene / "port"),
                               workers=2))
    j_copy.main(Namespace(image_path=photos, dataset_path=str(colmap_scene / "jax")))
    _assert_same_datasets(colmap_scene / "port", colmap_scene / "jax")
    assert sum(len(list((colmap_scene / "port" / s / "rgbs").iterdir()))
               for s in ("train", "val")) == 6
