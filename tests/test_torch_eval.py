"""The port's `eval` entry point against the JAX package's, end to end.

A synthetic dataset (tests/synthetic.py), weights from a JAX-initialised
model saved as a reference `{iter}.pt`, then the JAX `Runner(hp).eval()`
and the port's `eval.main(hp)` with `--device cpu`. Rendered rgb agrees to
atol 1e-4 and PSNR to 0.01 dB. Also: the port imports neither jax nor
mega_nerf_tpu, and asking it for cuda without a card raises.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mega_nerf_tpu.data.torch_io import save_pt
from mega_nerf_tpu.models.torch_interop import torch_state_from_flax_params
from mega_nerf_tpu.opts import get_opts_base as j_opts
from mega_nerf_tpu.opts import parse_opts as j_parse
from mega_nerf_tpu.runtime.runner import Runner as JRunner
from mega_nerf_tpu_torch import eval as port_eval
from mega_nerf_tpu_torch.runtime.runner import Runner as TRunner
from tests.synthetic import make_synthetic_dataset

REPO = Path(__file__).resolve().parents[1]


def _args(ds, exp, bg):
    args = [
        "--dataset_path", str(ds), "--exp_name", str(exp),
        "--near", "0.5", "--coarse_samples", "16", "--fine_samples", "24",
        "--pos_xyz_dim", "6", "--pos_dir_dim", "2", "--layers", "4",
        "--skip_layers", "2", "--layer_dim", "32", "--bg_layer_dim", "32",
        "--appearance_dim", "4", "--compute_dtype", "float32",
        "--val_scale_factor", "1",
    ]
    if bg:
        args += ["--ray_altitude_range", "-1.0", "1.0"]
    else:
        args += ["--far", "3.5", "--no_bg_nerf"]
    return args


def _j_hparams(args):
    parser = j_opts()
    parser.add_argument("--exp_name", type=str)
    parser.add_argument("--dataset_path", type=str)
    return j_parse(parser, args)


def _metric(exp, key):
    text = (Path(exp) / "0" / "metrics.txt").read_text()
    return float([l for l in text.splitlines() if key in l][0].split(":")[-1])


@pytest.mark.parametrize("bg", [False, True])
def test_eval_matches_jax(tmp_path, bg):
    ds = make_synthetic_dataset(tmp_path / "ds", n_train=3, n_val=1, hw=(16, 16))

    # Random-init JAX weights -> a reference-format checkpoint.
    init = JRunner(_j_hparams(_args(ds, tmp_path / "init", bg)),
                   set_experiment_path=False)
    state = init.make_eval_state()
    ckpt = {"model_state_dict": torch_state_from_flax_params(
        init.fg.config, jax.device_get(state.fg_params)), "iteration": 7}
    if bg:
        ckpt["bg_model_state_dict"] = torch_state_from_flax_params(
            init.bg.config, jax.device_get(state.bg_params))
    save_pt(ckpt, tmp_path / "7.pt")

    j_hp = _j_hparams(_args(ds, tmp_path / "jexp", bg)
                      + ["--ckpt_path", str(tmp_path / "7.pt")])
    j_runner = JRunner(j_hp)
    j_runner.eval()
    t_hp = port_eval.get_eval_opts(
        _args(ds, tmp_path / "texp", bg)
        + ["--ckpt_path", str(tmp_path / "7.pt"), "--device", "cpu"])
    metrics = port_eval.main(t_hp)

    assert abs(_metric(tmp_path / "jexp", "val/psnr") - metrics["val/psnr"]) < 0.01
    assert abs(_metric(tmp_path / "texp", "val/psnr") - metrics["val/psnr"]) < 1e-6
    assert abs(_metric(tmp_path / "jexp", "val/ssim") - metrics["val/ssim"]) < 1e-3
    assert list((tmp_path / "texp" / "0" / "val_images").rglob("*.jpg"))

    meta = j_runner.val_items[0]
    want = j_runner.render_image(meta, j_runner.make_eval_state())
    t_runner = TRunner(t_hp, set_experiment_path=False)
    t_runner.make_eval_state()
    got = t_runner.render_image(t_runner.val_items[0])
    np.testing.assert_allclose(got["rgb_fine"], want["rgb_fine"], atol=1e-4)


def test_render_image_ragged_last_chunk(tmp_path):
    """A view split into chunks with a shorter last one renders exactly as
    in one chunk."""
    ds = make_synthetic_dataset(tmp_path / "ds", n_train=2, n_val=1, hw=(16, 16))
    hp = port_eval.get_eval_opts(_args(ds, tmp_path / "exp", True)
                                 + ["--device", "cpu"])
    runner = TRunner(hp, set_experiment_path=False)
    meta = runner.val_items[0]
    whole = runner.render_image(meta)
    hp.image_pixel_batch_size = 100  # 256 rays -> 100 + 100 + 56
    chunked = runner.render_image(meta)
    assert set(chunked) == set(whole)
    for key, value in whole.items():
        assert chunked[key].shape == value.shape == (256,) + value.shape[1:]
        np.testing.assert_allclose(chunked[key], value, rtol=1e-6, atol=1e-6,
                                   err_msg=key)


# Modules the walk below must reach (a package without an `__init__.py`
# would be skipped silently): the octree, the serving features and the
# bake scripts.
REQUIRED_MODULES = (
    "mega_nerf_tpu_torch.octree", "mega_nerf_tpu_torch.octree.n3tree",
    "mega_nerf_tpu_torch.octree.grid_weight", "mega_nerf_tpu_torch.octree.render",
    "mega_nerf_tpu_torch.render.cell_cull", "mega_nerf_tpu_torch.render.ray_bounds",
    "mega_nerf_tpu_torch.scripts.create_octree", "mega_nerf_tpu_torch.scripts.bake_occupancy",
    "mega_nerf_tpu_torch.scripts.render_octree", "mega_nerf_tpu_torch.data.synthetic",
    "mega_nerf_tpu_torch.scripts.convergence_run",
    "mega_nerf_tpu_torch.scripts.cell_convergence_run",
    "mega_nerf_tpu_torch.scripts.cell_diagnostics",
)


def test_port_imports_no_jax(tmp_path):
    """Every module of the port, and chip_smoke, import without jax or
    mega_nerf_tpu (run in a fresh interpreter); the walk reaches the
    octree, serving and bake modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mega_nerf_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'mega_nerf_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"missing = set({REQUIRED_MODULES!r}) - set(names)\n"
        "assert not missing, missing\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'mega_nerf_tpu' or m.startswith('mega_nerf_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules if m.startswith('mega_nerf_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ds = make_synthetic_dataset(tmp_path / "ds", n_train=2, n_val=1, hw=(8, 8))
    hp = port_eval.get_eval_opts(_args(ds, tmp_path / "exp", False))
    assert hp.device == "cuda"  # the default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRunner(hp)


def test_chip_smoke_refuses_without_card_or_port(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    card, and alone in a directory without the port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    for cwd in (REPO, alone):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
