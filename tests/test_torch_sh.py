"""The port's SH output head and affine appearance against the JAX package.

- `ops/sh.py::eval_sh` at degrees 0-4 against the JAX `eval_sh` on the
  same seeded coefficients and unit directions: atol 1e-5;
- the `NeRF` forward with the SH head (raw coefficients) and with affine
  appearance against the Flax `NeRF`, weights carried by
  `state_from_flax_params`: atol 5e-5 (float32 compute), and in bfloat16
  compute the affine head to the kernels' 1e-2;
- the fused gate refuses both heads, which run on the eager module;
- eval `render_rays` with the SH head against the JAX renderer (XLA MLP
  path): rgb 1e-4, depth rtol 5e-4;
- tiny `train.main` + `eval.main` runs on `--device cpu` with `sh_deg`,
  the port's eval and the JAX eval on the port's checkpoint within 0.01 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.models.torch_interop import torch_state_from_flax_params
from mega_nerf_tpu.ops.sh import eval_sh as j_eval_sh
from mega_nerf_tpu.render import RenderSettings as JSettings
from mega_nerf_tpu.render import render_rays as j_render_rays
from mega_nerf_tpu.runtime.runner import Runner as JRunner
from mega_nerf_tpu_torch import eval as port_eval
from mega_nerf_tpu_torch import train as port_train
from mega_nerf_tpu_torch.models import (
    NeRF,
    flax_params_from_state,
    make_bg_nerf,
    make_nerf,
    nerf_config_from_hparams,
    state_from_flax_params,
)
from mega_nerf_tpu_torch.ops import eval_sh
from mega_nerf_tpu_torch.render import fused_mlp, rendering
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays
from tests.synthetic import make_synthetic_dataset
from tests.test_models import tiny_hparams
from tests.test_torch_eval import _args, _j_hparams, _metric

CENTER = np.array([0.05, -0.1, 0.0], np.float32)
RADIUS = np.array([1.4, 1.1, 1.2], np.float32)

HEADS = {
    "sh1": dict(sh_deg=1, pos_dir_dim=0, appearance_dim=0),
    "sh2_app": dict(sh_deg=2, pos_dir_dim=0, appearance_dim=4),
    "affine": dict(appearance_dim=4, affine_appearance=True),
    "affine_no_dirs": dict(appearance_dim=4, affine_appearance=True, pos_dir_dim=0),
}


def _unit_dirs(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(257, 3, (deg + 1) ** 2)).astype(np.float32)
    dirs = _unit_dirs(rng, 257)
    want = j_eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs))
    got = eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs))
    assert got.shape == (257, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _flax_and_port(kw, bg, seed=0, compute_dtype="float32"):
    hp = tiny_hparams(**kw, compute_dtype=compute_dtype)
    jb = (j_make_bg_nerf if bg else j_make_nerf)(hp, 5)
    params = jax.device_get(jb.init(jax.random.key(seed)))
    cfg = nerf_config_from_hparams(hp, 5, hp.bg_layer_dim if bg else hp.layer_dim,
                                   4 if bg else 3)
    module = NeRF(cfg)
    module.load_state_dict(state_from_flax_params(cfg, params))
    return jb, params, module, cfg


def _forward_pair(kw, bg, compute_dtype="float32"):
    jb, params, module, cfg = _flax_and_port(kw, bg, compute_dtype=compute_dtype)
    rng = np.random.default_rng(11)
    n = 300
    xyz = rng.normal(size=(n, cfg.xyz_dim)).astype(np.float32)
    dirs = _unit_dirs(rng, n)
    idx = rng.integers(0, 5, n).astype(np.int32)
    use_dirs, use_app = cfg.pos_dir_dim > 0, cfg.appearance_dim > 0
    want = jb.apply(params, "fine", jnp.asarray(xyz),
                    jnp.asarray(dirs) if use_dirs else None,
                    jnp.asarray(idx) if use_app else None)
    with torch.no_grad():
        got = module(torch.from_numpy(xyz),
                     torch.from_numpy(dirs) if use_dirs else None,
                     torch.from_numpy(idx) if use_app else None)
    assert got.shape == (n, cfg.rgb_dim + 1)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_nerf_heads_match_flax(head, bg):
    got, want = _forward_pair(HEADS[head], bg)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_affine_head_bf16_matches_flax():
    """bf16 compute: the affine transform is rounded after the product and
    after the sum, as the JAX module's einsum and add in that dtype."""
    got, want = _forward_pair(HEADS["affine"], False, "bfloat16")
    np.testing.assert_allclose(got, want, atol=1e-2)
    assert np.abs(got - want).mean() < 1e-3


@pytest.mark.parametrize("head", sorted(HEADS))
def test_heads_weight_names_match_the_reference(head):
    """Every key of the reference naming (`affine.*` included) round-trips."""
    _, params, module, cfg = _flax_and_port(HEADS[head], False)
    j_cfg = j_make_nerf(tiny_hparams(**HEADS[head]), 5).config
    ref = torch_state_from_flax_params(j_cfg, params)
    assert list(ref) == list(state_from_flax_params(cfg, params))
    assert set(ref) == set(module.state_dict())
    back = flax_params_from_state(cfg, module.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, np.asarray(leaf))


def test_sh_config_requires_no_view_dirs():
    from mega_nerf_tpu_torch.models import NeRFConfig

    with pytest.raises(AssertionError):
        NeRFConfig(pos_dir_dim=4, rgb_dim=27)


def test_sh_gate_refuses_the_head():
    """The renderer's gate refuses the SH head for eval and training on
    either device, as the JAX package's Pallas gate does."""
    bundle = make_nerf(tiny_hparams(**HEADS["sh1"]), 1)
    settings = RenderSettings(sh_deg=1)
    assert rendering.fused_gate(bundle, settings, False, "cpu") == (False, "SH output head")
    assert rendering.fused_gate(bundle, settings, True, "cuda") == (False, "SH output head")
    assert not fused_mlp.supports_fused_kernel(bundle.config)[0]


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-0.3, 0.3, size=(n, 3)) * 0.5).astype(np.float32)
    d = _unit_dirs(rng, n)
    near = np.full((n, 1), 0.05, np.float32)
    far = np.where(np.arange(n)[:, None] % 2 == 0, 1e5, 0.8).astype(np.float32)
    return np.concatenate([o, d, near, far], -1)


@pytest.mark.parametrize("head", ["sh2_app", "affine"])
def test_render_rays_with_heads_matches_jax(head, capsys, monkeypatch):
    monkeypatch.setattr(rendering, "_LOGGED_MLP_PATHS", set())
    kw = HEADS[head]
    hp = tiny_hparams(**kw, compute_dtype="float32")
    bundles = []
    for j_make, t_make, seed in ((j_make_nerf, make_nerf, 0),
                                 (j_make_bg_nerf, make_bg_nerf, 1)):
        jb = j_make(hp, 5)
        params = jax.device_get(jb.init(jax.random.key(seed)))
        tb = t_make(hp, 5)
        tb.module.load_state_dict(state_from_flax_params(tb.config, params))
        bundles.append((jb, params, tb))
    (jfg, pfg, tfg), (jbg, pbg, tbg) = bundles
    rays = _rays(32, 3)
    idx = np.arange(32, dtype=np.int32) % 5
    sh_deg = kw.get("sh_deg")
    jset = JSettings(coarse_samples=16, fine_samples=24, use_pallas=False,
                     eval_compositor="merge", sh_deg=sh_deg, get_depth=True,
                     get_bg_fg_rgb=True)
    want, _ = j_render_rays(jfg, jbg, pfg, pbg, jnp.asarray(rays), jnp.asarray(idx),
                            jset, jnp.asarray(CENTER), jnp.asarray(RADIUS))
    tset = RenderSettings(coarse_samples=16, fine_samples=24, sh_deg=sh_deg,
                          get_depth=True, get_bg_fg_rgb=True)
    with torch.no_grad():
        got, _ = render_rays(tfg, tbg, torch.from_numpy(rays),
                             torch.from_numpy(idx).long(), tset,
                             torch.from_numpy(CENTER), torch.from_numpy(RADIUS))
    logged = capsys.readouterr().out
    assert logged.count("eager NeRF module") == 4 and "fused" not in logged
    for key in ("rgb_fine", "fg_rgb_fine", "bg_rgb_fine"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)
    for key in ("depth_fine", "fg_depth_fine"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=5e-4, atol=1e-5, err_msg=key)
    assert set(got) == set(want)


def test_train_and_eval_main_with_sh_head(tmp_path):
    """`train.main` and `eval.main` on the CPU with `--sh_deg 1` (fg + bg,
    eager module): finite metrics, a `{iter}.pt` whose eval agrees with
    the JAX package's eval of it to 0.01 dB."""
    ds = make_synthetic_dataset(tmp_path / "ds", n_train=3, n_val=1, hw=(16, 16))
    sh = ["--sh_deg", "1", "--pos_dir_dim", "0"]
    hp = port_train.get_train_opts(_args(ds, tmp_path / "texp", True) + sh + [
        "--dataset_type", "memory", "--batch_size", "64", "--train_iterations", "2",
        "--ckpt_interval", "100", "--lr", "5e-3", "--device", "cpu"])
    val = port_train.main(hp)
    assert np.isfinite(val["val/psnr"])
    ckpt = tmp_path / "texp" / "0" / "models" / "2.pt"
    e_hp = port_eval.get_eval_opts(_args(ds, tmp_path / "teval", True) + sh
                                   + ["--ckpt_path", str(ckpt), "--device", "cpu"])
    metrics = port_eval.main(e_hp)
    assert abs(metrics["val/psnr"] - val["val/psnr"]) < 1e-6
    JRunner(_j_hparams(_args(ds, tmp_path / "jexp", True) + sh
                       + ["--ckpt_path", str(ckpt)])).eval()
    assert abs(_metric(tmp_path / "jexp", "val/psnr") - metrics["val/psnr"]) < 0.01
