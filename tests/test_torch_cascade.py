"""The port's coarse/fine cascade against the JAX package, on the CPU.

Both packages hold the same Flax-initialised weights (the two levels of a
cascade differ), carried over with `state_from_flax_params(cascade=True)`:

- the weight round trip with the reference's `coarse.*` / `fine.*` keys
  against `mega_nerf_tpu/models/torch_interop.py`, bit for bit, and the
  parameter order the JAX package reads a torch Adam state in;
- one kernel-layout weight cache per level;
- eval `render_rays`, fg only and fg + bg, through the fused wrappers (their
  plain versions on the CPU) and the eager module, against the JAX renderer
  (XLA MLP path, merge compositor): rgb 1e-4, depth rtol 5e-4; and one
  640-wide bf16 case on the wide route, rgb 1e-3 (mean 1e-4);
- train-mode loss and gradients (fine + coarse MSE, no jitter or noise):
  the eager module against the JAX XLA path at 1e-5, the fused plain
  versions against the JAX Pallas kernels in interpret mode at 2e-4;
- two Adam steps of `TrainStep` against the JAX `make_train_step`: loss,
  `coarse_loss`, parameters and Adam moments of both levels at 1e-5;
- `train.main` + `eval.main` on `--device cpu`: the JAX checkpoint import
  reads the port's cascade `{iter}.pt` with weights and Adam moments equal,
  and the JAX eval of it agrees to 0.01 dB;
- `_eval_chunk_cap` against the JAX one.
"""

from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.models.torch_interop import (
    flax_params_from_torch_state,
    torch_state_from_flax_params,
)
from mega_nerf_tpu.parallel.train_step import make_optimizer as j_make_optimizer
from mega_nerf_tpu.parallel.train_step import make_train_state as j_make_state
from mega_nerf_tpu.parallel.train_step import make_train_step as j_make_step
from mega_nerf_tpu.render import RenderSettings as JSettings
from mega_nerf_tpu.render import render_rays as j_render_rays
from mega_nerf_tpu.runtime.runner import Runner as JRunner
from mega_nerf_tpu.runtime.runner import _eval_chunk_cap as j_eval_chunk_cap
from mega_nerf_tpu_torch import eval as port_eval
from mega_nerf_tpu_torch import train as port_train
from mega_nerf_tpu_torch.models import (
    Cascade,
    flax_params_from_state,
    make_bg_nerf,
    make_nerf,
    state_from_flax_params,
)
from mega_nerf_tpu_torch.parallel.train_step import TrainStep
from mega_nerf_tpu_torch.render import fused_wide, rendering
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays
from mega_nerf_tpu_torch.runtime.runner import _eval_chunk_cap
from tests.synthetic import make_synthetic_dataset
from tests.test_models import tiny_hparams
from tests.test_torch_eval import _args, _j_hparams, _metric
from tests.test_torch_train_loop import _assert_trees_close

CENTER = np.array([0.05, -0.1, 0.0], np.float32)
RADIUS = np.array([1.4, 1.1, 1.2], np.float32)


def _bundles(hp, count, bg=True):
    """[(JAX bundle, its Flax params, the port's bundle holding them)] for
    fg (and bg), each a cascade."""
    makers = [(j_make_nerf, make_nerf, 0)]
    if bg:
        makers.append((j_make_bg_nerf, make_bg_nerf, 1))
    out = []
    for j_make, t_make, seed in makers:
        jb = j_make(hp, count)
        assert jb.cascade
        params = jax.device_get(jb.init(jax.random.key(seed)))
        tb = t_make(hp, count)
        assert tb.cascade and isinstance(tb.module, Cascade)
        tb.module.load_state_dict(state_from_flax_params(tb.config, params, cascade=True))
        tb.module.eval()
        out.append((jb, params, tb))
    return out


def _rays(n, seed, far_bg=1e5):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-0.3, 0.3, size=(n, 3)) * 0.5).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    near = np.full((n, 1), 0.05, np.float32)
    # Half the rays end inside the ellipsoid (no bg), half run to far_bg.
    far = np.where(np.arange(n)[:, None] % 2 == 0, far_bg, 0.8).astype(np.float32)
    return np.concatenate([o, d, near, far], -1)


def test_cascade_weight_round_trip_and_reference_naming():
    hp = tiny_hparams(appearance_dim=4, use_cascade=True)
    [(jb, params, tb)] = _bundles(hp, 5, bg=False)
    ref = torch_state_from_flax_params(jb.config, params, cascade=True)
    state = state_from_flax_params(tb.config, params, cascade=True)
    assert set(ref) == set(state) == set(tb.module.state_dict())
    # The JAX package names a torch Adam state's moments by the state dict's
    # key order: it must be the parameter order, the coarse level first.
    names = list(tb.module.state_dict())
    assert [n for n, _ in tb.module.named_parameters()] == names
    levels = [n.split(".")[0] for n in names]
    assert levels == sorted(levels) and levels[0] == "coarse" and levels[-1] == "fine"
    for k, v in ref.items():
        np.testing.assert_array_equal(state[k].numpy(), v)
    back = flax_params_from_state(tb.config, tb.module.state_dict(), cascade=True)
    _assert_trees_close(back, params, 0, "port round trip")
    numpy_state = {k: v.numpy() for k, v in tb.module.state_dict().items()}
    _assert_trees_close(flax_params_from_torch_state(jb.config, numpy_state, cascade=True),
                        params, 0, "JAX reading the port's state")
    c, f = tb.level("coarse"), tb.level("fine")
    assert c is tb.module.coarse and f is tb.module.fine
    assert not torch.equal(c.rgb.weight, f.rgb.weight)


def test_packed_weights_are_cached_per_level():
    """Each level packs its own weights once; a change to one level's
    weights repacks that level only."""
    hp = tiny_hparams(appearance_dim=4, use_cascade=True)
    [(_, _, tb)] = _bundles(hp, 5, bg=False)
    coarse = rendering.packed_params(tb, "coarse")
    fine = rendering.packed_params(tb, "fine")
    assert not torch.equal(coarse.mats[0], fine.mats[0])
    assert rendering.packed_params(tb, "coarse") is coarse
    assert rendering.packed_params(tb, "fine") is fine
    with torch.no_grad():
        tb.level("fine").xyz_encodings[0][0].weight.mul_(2.0)
    assert rendering.packed_params(tb, "coarse") is coarse
    repacked = rendering.packed_params(tb, "fine")
    assert repacked is not fine
    torch.testing.assert_close(repacked.mats[0].float(), 2.0 * fine.mats[0].float())
    single = make_nerf(tiny_hparams(), 1)  # one NeRF: both levels share it
    assert single.level("coarse") is single.level("fine") is single.module
    assert rendering.packed_params(single, "coarse") is \
        rendering.packed_params(single, "fine")


def _render_pair(hp, fine, mlp, bg, n=48):
    bundles = _bundles(hp, 5, bg=bg)
    (jfg, pfg, tfg) = bundles[0]
    jbg, pbg, tbg = bundles[1] if bg else (None, None, None)
    rays = _rays(n, seed=3)
    idx = np.arange(n, dtype=np.int32) % 5
    geom = (jnp.asarray(CENTER), jnp.asarray(RADIUS)) if bg else (None, None)
    jset = JSettings(coarse_samples=16, fine_samples=fine, use_cascade=True,
                     use_pallas=False, eval_compositor="merge", get_depth=True,
                     get_bg_fg_rgb=True)
    want, _ = jax.jit(lambda fp, bp: j_render_rays(
        jfg, jbg, fp, bp, jnp.asarray(rays), jnp.asarray(idx), jset, *geom,
        train=False))(pfg, pbg)
    tset = RenderSettings(coarse_samples=16, fine_samples=fine, use_cascade=True,
                          use_fused_kernel=(mlp == "fused"), get_depth=True,
                          get_bg_fg_rgb=True)
    t_geom = (torch.from_numpy(CENTER), torch.from_numpy(RADIUS)) if bg else (None, None)
    with torch.no_grad():
        got, _ = render_rays(tfg, tbg, torch.from_numpy(rays),
                             torch.from_numpy(idx).long(), tset, *t_geom)
    return got, want


@pytest.mark.parametrize("mlp", ["fused", "eager"])
@pytest.mark.parametrize("bg", [False, True])
def test_render_rays_cascade_matches_jax(mlp, bg, capsys, monkeypatch):
    monkeypatch.setattr(rendering, "_LOGGED_MLP_PATHS", set())
    hp = tiny_hparams(appearance_dim=4, use_cascade=True, compute_dtype="float32")
    got, want = _render_pair(hp, 24, mlp, bg)
    logged = capsys.readouterr().out
    route = "fused eval (kernel's plain version)" if mlp == "fused" else "eager"
    assert logged.count(route) == (4 if bg else 2)
    rgb_keys = ["rgb_fine", "rgb_coarse"]
    if bg:
        rgb_keys += ["fg_rgb_fine", "bg_rgb_fine", "fg_rgb_coarse", "bg_rgb_coarse"]
    for key in rgb_keys:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)
    for key in ["depth_fine"] + (["fg_depth_fine"] if bg else []):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=5e-4, atol=1e-5, err_msg=key)
    assert set(got) == set(want)
    # The levels differ, so a coarse-only render differs from the fine one.
    assert not np.allclose(got["rgb_coarse"].numpy(), got["rgb_fine"].numpy())


def test_render_rays_cascade_through_the_wide_route_matches_jax(capsys, monkeypatch):
    """640-wide bf16 fg + bg cascades: each level through the wide route's
    plain version (4 passes) against the JAX renderer; tolerances as the
    non-cascade wide render test (a float32 sum in another order can flip
    one bf16 rounding of an activation)."""
    monkeypatch.setattr(rendering, "_LOGGED_MLP_PATHS", set())
    hp = tiny_hparams(pos_xyz_dim=4, pos_dir_dim=2, layers=3, skip_layers=[2],
                      layer_dim=640, bg_layer_dim=640, appearance_dim=4,
                      use_cascade=True, compute_dtype="bfloat16")
    calls = fused_wide.fused_nerf_eval_wide_plain.calls
    got, want = _render_pair(hp, 24, "fused", True)
    assert fused_wide.fused_nerf_eval_wide_plain.calls == calls + 4
    assert capsys.readouterr().out.count("fused eval (wide kernel's plain version)") == 4
    for key in ("rgb_fine", "rgb_coarse", "fg_rgb_fine", "bg_rgb_fine"):
        diff = np.abs(got[key].numpy() - np.asarray(want[key]))
        assert diff.max() <= 1e-3 and diff.mean() <= 1e-4, key
    for key in ("depth_fine", "fg_depth_fine"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=5e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("mlp", ["fused", "eager"])
def test_render_rays_cascade_train_loss_and_grads_match_jax(mlp):
    """The JAX package's cascade gradient setup (its fused-vs-XLA test of
    `tests/test_pallas_train.py`): fg cascade, fine + coarse MSE, without a
    key (no jitter, no sigma noise). eager vs XLA at 1e-5; the port's fused
    plain versions vs the JAX Pallas kernels in interpret mode at 2e-4."""
    hp = tiny_hparams(appearance_dim=4, use_cascade=True)
    [(jfg, pfg, tfg)] = _bundles(hp, 3, bg=False)
    rays = _rays(8, seed=5, far_bg=4.0)
    idx = np.arange(8, dtype=np.int32) % 3
    target = np.full((8, 3), 0.5, np.float32)
    jset = JSettings(coarse_samples=16, fine_samples=16, use_cascade=True,
                     use_pallas=(mlp == "fused"), get_depth_variance=True)

    def j_loss(fp):
        res, _ = j_render_rays(jfg, None, fp, None, jnp.asarray(rays), jnp.asarray(idx),
                               jset, train=True, key=None)
        return (jnp.mean((res["rgb_fine"] - target) ** 2)
                + jnp.mean((res["rgb_coarse"] - target) ** 2))

    want_v, want_g = jax.jit(jax.value_and_grad(j_loss))(pfg)
    tset = RenderSettings(coarse_samples=16, fine_samples=16, use_cascade=True,
                          use_fused_kernel=(mlp == "fused"), get_depth_variance=True)
    res, _ = render_rays(tfg, None, torch.from_numpy(rays), torch.from_numpy(idx).long(),
                         tset, train=True)
    t = torch.from_numpy(target)
    loss = torch.mean((res["rgb_fine"] - t) ** 2) + torch.mean((res["rgb_coarse"] - t) ** 2)
    loss.backward()
    tol = 2e-4 if mlp == "fused" else 1e-5
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in tfg.module.named_parameters()}
    got_g = flax_params_from_state(tfg.config, grads, cascade=True)
    _assert_trees_close(got_g, want_g, tol, "grads")
    assert float(np.abs(np.asarray(want_g["coarse"]["rgb"]["kernel"])).max()) > 0


def _torch_moments(opt, bundle, key):
    state = {name: opt.state[p][key] for name, p in bundle.module.named_parameters()}
    return flax_params_from_state(bundle.config, state, cascade=True)


def test_two_cascade_train_steps_match_jax():
    hp = tiny_hparams(appearance_dim=4, use_cascade=True, compute_dtype="float32")
    (jfg, _, tfg), (jbg, _, tbg) = _bundles(hp, 5)
    jset = JSettings(coarse_samples=16, fine_samples=16, use_cascade=True,
                     use_pallas=False, perturb=0.0, sigma_noise=False)
    opt = j_make_optimizer(1e-3, 0.1, 50)  # lr 1e-3: see the non-cascade test
    state = j_make_state(jfg, jbg, opt, jax.random.key(0))
    for tb, side in ((tfg, state.fg_params), (tbg, state.bg_params)):
        tb.module.load_state_dict(state_from_flax_params(
            tb.config, jax.device_get(side), cascade=True))
    j_step = jax.jit(j_make_step(jfg, jbg, jset, opt, jnp.asarray(CENTER),
                                 jnp.asarray(RADIUS)))
    tset = RenderSettings(coarse_samples=16, fine_samples=16, use_cascade=True,
                          perturb=0.0, sigma_noise=False)
    step = TrainStep(tfg, tbg, tset, 1e-3, 0.1, 50, torch.from_numpy(CENTER),
                     torch.from_numpy(RADIUS))
    rng = np.random.default_rng(9)
    for i in range(2):
        b = {"rays": _rays(16, seed=10 + i),
             "rgbs": rng.uniform(size=(16, 3)).astype(np.float32),
             "img_indices": (np.arange(16) % 5).astype(np.int32)}
        state, jm = j_step(state, {k: jnp.asarray(v) for k, v in b.items()})
        tm = step({"rays": torch.from_numpy(b["rays"]), "rgbs": torch.from_numpy(b["rgbs"]),
                   "img_indices": torch.from_numpy(b["img_indices"]).long()})
        assert set(tm) == set(jm) and "coarse_loss" in tm
        for k in ("loss", "coarse_loss", "photo_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["loss"]),
                                   (float(tm["photo_loss"]) + float(tm["coarse_loss"])) / 2,
                                   rtol=1e-6)
        for side, tb, t_opt in (("fg", tfg, step.fg_opt), ("bg", tbg, step.bg_opt)):
            _assert_trees_close(
                flax_params_from_state(tb.config, tb.module.state_dict(), cascade=True),
                getattr(state, f"{side}_params"), 1e-5, f"step {i} {side} params")
            adam = getattr(state, f"{side}_opt")[0]
            _assert_trees_close(_torch_moments(t_opt, tb, "exp_avg"), adam.mu, 1e-5,
                                f"step {i} {side} mu")
            _assert_trees_close(_torch_moments(t_opt, tb, "exp_avg_sq"), adam.nu, 1e-5,
                                f"step {i} {side} nu")


def test_cascade_train_and_eval_main_into_jax(tmp_path):
    """`train.main` with `--use_cascade` (fg + bg) on the CPU writes a
    reference-layout `{iter}.pt` with `coarse.*` / `fine.*` state dicts;
    `eval.main` renders it; the JAX runner imports its weights and Adam
    moments equal and its eval of it agrees to 0.01 dB."""
    ds = make_synthetic_dataset(tmp_path / "ds", n_train=3, n_val=1, hw=(16, 16))
    hp = port_train.get_train_opts(_args(ds, tmp_path / "texp", True) + [
        "--use_cascade", "--dataset_type", "memory", "--batch_size", "64",
        "--train_iterations", "2", "--ckpt_interval", "100", "--lr", "5e-3",
        "--device", "cpu"])
    runner = port_train.Runner(hp)
    val = runner.train()
    assert np.isfinite(val["val/psnr"])
    ckpt = tmp_path / "texp" / "0" / "models" / "2.pt"
    saved = torch.load(ckpt, weights_only=False)
    for key in ("model_state_dict", "bg_model_state_dict"):
        keys = list(saved[key])
        assert keys[0].startswith("coarse.") and keys[-1].startswith("fine.")
    t_metrics = port_eval.main(port_eval.get_eval_opts(
        _args(ds, tmp_path / "teval", True)
        + ["--use_cascade", "--ckpt_path", str(ckpt), "--device", "cpu"]))
    assert abs(t_metrics["val/psnr"] - val["val/psnr"]) < 1e-6

    j_hp = _j_hparams(_args(ds, tmp_path / "jexp", True)
                      + ["--use_cascade", "--ckpt_path", str(ckpt)])
    JRunner(j_hp).eval()
    assert abs(_metric(tmp_path / "jexp", "val/psnr") - t_metrics["val/psnr"]) < 0.01
    j_runner = JRunner(j_hp, set_experiment_path=False)
    opt = j_make_optimizer(5e-3, 0.1, 2)
    j_state = j_make_state(j_runner.fg, j_runner.bg, opt, jax.random.PRNGKey(0))
    j_state, aux = j_runner._load_checkpoint_into_state(ckpt, j_state)
    assert aux["iteration"] == 2
    step = runner.train_step
    for side, bundle, t_opt in (("fg", runner.fg, step.fg_opt),
                                ("bg", runner.bg, step.bg_opt)):
        _assert_trees_close(
            flax_params_from_state(bundle.config, bundle.module.state_dict(), cascade=True),
            jax.device_get(getattr(j_state, f"{side}_params")), 0, f"{side} params")
        adam = getattr(j_state, f"{side}_opt")[0]
        assert isinstance(adam, optax.ScaleByAdamState)
        for key, want in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            _assert_trees_close(_torch_moments(t_opt, bundle, key), want, 0,
                                f"{side} {key}")


@pytest.mark.parametrize("coarse,fine,cascade", [
    (256, 512, False), (256, 512, True), (256, 0, True), (64, 32, True),
    (16, 24, True),
])
def test_eval_chunk_cap_matches_jax(coarse, fine, cascade):
    hp = Namespace(coarse_samples=coarse, fine_samples=fine, use_cascade=cascade)
    assert _eval_chunk_cap(hp) == j_eval_chunk_cap(hp, 1)
