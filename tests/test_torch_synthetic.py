"""The port's analytic scenes (`data/synthetic.py`) against the JAX
package's `tests/synthetic.py`, on the CPU.

- `scene_density_color` and `drone_density_color` at 4,096 seeded points:
  sigma equal, rgb within 1e-6;
- `make_synthetic_dataset` and `make_drone_dataset` at 16x16: the same
  files, `coordinates.pt` and every view's metadata within 1e-6, every PNG
  within one level per channel with at least 99.9% of its pixels equal;
- the builders render on the card unless told otherwise: without one,
  the default device raises and writes no `coordinates.pt`.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mega_nerf_tpu_torch.data import synthetic as port
from mega_nerf_tpu_torch.data.torch_io import load_pt
from tests import synthetic as ref

SCENES = {
    "ring": (ref.scene_density_color, port.scene_density_color,
             ref.make_synthetic_dataset, port.make_synthetic_dataset,
             dict(n_train=4, n_val=1)),
    "drone": (ref.drone_density_color, port.drone_density_color,
              ref.make_drone_dataset, port.make_drone_dataset,
              dict(n_train=5, n_val=2)),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_density_and_color_match_jax(scene):
    j_fn, t_fn = SCENES[scene][:2]
    # Points spanning both scenes' geometry: balls, shell, ground, boxes.
    pts = np.random.default_rng(7).uniform(-2.0, 2.0, (4096, 3)).astype(np.float32)
    j_sigma, j_rgb = j_fn(jnp.asarray(pts))
    t_sigma, t_rgb = t_fn(torch.from_numpy(pts))
    assert 0.1 < float((t_sigma > 0).float().mean()) < 0.9  # both kinds of point
    np.testing.assert_array_equal(t_sigma.numpy(), np.asarray(j_sigma))
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), rtol=0, atol=1e-6)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_dataset_files_match_jax(tmp_path, scene):
    j_make, t_make, kw = SCENES[scene][2:]
    j_root = j_make(tmp_path / "jax", hw=(16, 16), **kw)
    t_root = t_make(tmp_path / "port", hw=(16, 16), device="cpu", **kw)
    j_files = sorted(p.relative_to(j_root) for p in Path(j_root).rglob("*") if p.is_file())
    t_files = sorted(p.relative_to(t_root) for p in Path(t_root).rglob("*") if p.is_file())
    assert t_files == j_files
    assert sum(f.suffix == ".png" for f in j_files) == kw["n_train"] + kw["n_val"]
    for rel in j_files:
        if rel.suffix == ".pt":
            want, got = load_pt(j_root / rel), load_pt(t_root / rel)
            assert set(got) == set(want), rel
            for key in want:
                np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                           np.asarray(want[key], np.float64),
                                           rtol=0, atol=1e-6, err_msg=f"{rel} {key}")
        else:
            want = np.asarray(Image.open(j_root / rel)).astype(np.int16)
            got = np.asarray(Image.open(t_root / rel)).astype(np.int16)
            diff = np.abs(got - want)
            assert diff.max() <= 1, rel
            assert (diff.max(-1) == 0).mean() >= 0.999, rel


def test_builders_render_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.make_synthetic_dataset(tmp_path / "ds", n_train=1, n_val=1, hw=(8, 8))
    assert not (tmp_path / "ds" / "coordinates.pt").exists()
