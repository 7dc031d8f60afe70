"""Parity of the port's training loop with the JAX package, on the CPU.

- `render_rays(train=True)` without a generator (no jitter, no noise,
  deterministic fine samples), fg + bg: loss rtol 1e-5 and gradients atol
  1e-5 against the JAX `render_rays(train=True, key=None)` (XLA MLP path,
  pairwise merge);
- two `TrainStep`s (perturb 0, no sigma noise, f32 compute) against the JAX
  `make_train_step` from the same parameters and batches: loss, parameters
  and Adam moments atol 1e-5; a batch without background rays leaves the
  background parameters and Adam state unchanged in both;
- `Runner.train` on `tests/synthetic.py`'s dataset: `{iter}.pt` written;
  the port's `eval` and the JAX `Runner.eval` on it agree to 0.01 dB PSNR;
  the JAX checkpoint import reads the port's Adam moments; resume continues
  the iteration count; the final validation renders the trained weights;
  asking for cuda without a card raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.parallel.train_step import make_optimizer as j_make_optimizer
from mega_nerf_tpu.parallel.train_step import make_train_state as j_make_state
from mega_nerf_tpu.parallel.train_step import make_train_step as j_make_step
from mega_nerf_tpu.render import RenderSettings as JSettings
from mega_nerf_tpu.render import render_rays as j_render_rays
from mega_nerf_tpu.runtime.runner import Runner as JRunner
from mega_nerf_tpu_torch import eval as port_eval
from mega_nerf_tpu_torch import train as port_train
from mega_nerf_tpu_torch.models import (
    flax_params_from_state,
    make_bg_nerf,
    make_nerf,
    state_from_flax_params,
)
from mega_nerf_tpu_torch.parallel.train_step import TrainStep
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays
from mega_nerf_tpu_torch.runtime.runner import Runner as TRunner
from tests.synthetic import make_synthetic_dataset
from tests.test_models import tiny_hparams
from tests.test_torch_eval import _args, _j_hparams, _metric

CENTER = np.array([0.05, -0.1, 0.0], np.float32)
RADIUS = np.array([1.4, 1.1, 1.2], np.float32)


def _bundles(hp, count):
    out = []
    for j_make, t_make, seed in ((j_make_nerf, make_nerf, 0),
                                 (j_make_bg_nerf, make_bg_nerf, 1)):
        jb = j_make(hp, count)
        params = jax.device_get(jb.init(jax.random.key(seed)))
        tb = t_make(hp, count)
        tb.module.load_state_dict(state_from_flax_params(tb.config, params))
        out.append((jb, params, tb))
    return out


def _rays(n, seed, far_bg=1e5):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-0.3, 0.3, size=(n, 3)) * 0.5).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    near = np.full((n, 1), 0.05, np.float32)
    far = np.where(np.arange(n)[:, None] % 2 == 0, far_bg, 0.8).astype(np.float32)
    return np.concatenate([o, d, near, far], -1)


def _grads(module, cfg):
    g = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
         for k, p in module.named_parameters()}
    return flax_params_from_state(cfg, g)


def _assert_trees_close(got, want, atol, what):
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    got = jax.tree_util.tree_leaves_with_path(got)
    assert len(got) == len(flat_w)
    for path, leaf in got:
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(flat_w[path]),
                                   atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("mlp", ["fused", "eager"])
def test_render_rays_train_loss_and_grads_match_jax(mlp):
    hp = tiny_hparams(appearance_dim=4, compute_dtype="float32")
    (jfg, pfg, tfg), (jbg, pbg, tbg) = _bundles(hp, 5)
    rays = _rays(24, seed=3)
    idx = np.arange(24, dtype=np.int32) % 5
    target = np.random.default_rng(4).uniform(size=(24, 3)).astype(np.float32)
    jset = JSettings(coarse_samples=16, fine_samples=16, use_pallas=False,
                     perturb=0.0, sigma_noise=False, get_depth_variance=True)

    def j_loss(fp, bp):
        res, _ = j_render_rays(jfg, jbg, fp, bp, jnp.asarray(rays),
                               jnp.asarray(idx), jset, jnp.asarray(CENTER),
                               jnp.asarray(RADIUS), train=True, key=None)
        return jnp.mean((res["rgb_fine"] - target) ** 2)

    want_v, (gf, gb) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(pfg, pbg)
    tset = RenderSettings(coarse_samples=16, fine_samples=16, perturb=0.0,
                          sigma_noise=False, get_depth_variance=True,
                          use_fused_kernel=(mlp == "fused"))
    res, bg_present = render_rays(tfg, tbg, torch.from_numpy(rays),
                                  torch.from_numpy(idx).long(), tset,
                                  torch.from_numpy(CENTER),
                                  torch.from_numpy(RADIUS), train=True)
    loss = torch.mean((res["rgb_fine"] - torch.from_numpy(target)) ** 2)
    loss.backward()
    assert bool(bg_present)
    assert "depth_variance_fine" in res
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    _assert_trees_close(_grads(tfg.module, tfg.config), gf, 1e-5, "fg")
    _assert_trees_close(_grads(tbg.module, tbg.config), gb, 1e-5, "bg")


def _torch_moments(opt, module, cfg, key):
    state = {name: opt.state[p][key] for name, p in module.named_parameters()}
    return flax_params_from_state(cfg, state)


def test_two_train_steps_match_jax_and_bg_skip():
    hp = tiny_hparams(appearance_dim=4, compute_dtype="float32")
    (jfg, _, tfg), (jbg, _, tbg) = _bundles(hp, 5)
    jset = JSettings(coarse_samples=16, fine_samples=16, use_pallas=False,
                     perturb=0.0, sigma_noise=False)
    # Adam divides each gradient element by its own magnitude, so an element
    # whose gradient is near eps turns float noise into an update of up to
    # lr: lr 1e-3 keeps such elements inside the 1e-5 parameter tolerance.
    opt = j_make_optimizer(1e-3, 0.1, 50)
    state = j_make_state(jfg, jbg, opt, jax.random.key(0))
    tfg.module.load_state_dict(state_from_flax_params(tfg.config, jax.device_get(state.fg_params)))
    tbg.module.load_state_dict(state_from_flax_params(tbg.config, jax.device_get(state.bg_params)))
    j_step = jax.jit(j_make_step(jfg, jbg, jset, opt, jnp.asarray(CENTER),
                                 jnp.asarray(RADIUS)))
    tset = RenderSettings(coarse_samples=16, fine_samples=16, perturb=0.0,
                          sigma_noise=False)
    step = TrainStep(tfg, tbg, tset, 1e-3, 0.1, 50, torch.from_numpy(CENTER),
                     torch.from_numpy(RADIUS))

    rng = np.random.default_rng(9)
    batches = []
    for i, far_bg in enumerate((1e5, 1e5, 0.8)):  # the last has no bg ray
        rays = _rays(16, seed=10 + i, far_bg=far_bg)
        batches.append({"rays": rays, "rgbs": rng.uniform(size=(16, 3)).astype(np.float32),
                        "img_indices": (np.arange(16) % 5).astype(np.int32)})
    for i, b in enumerate(batches):
        bg_before = jax.device_get(state.bg_params)
        bg_opt_before = jax.device_get(state.bg_opt)
        t_bg_before = {k: v.clone() for k, v in tbg.module.state_dict().items()}
        t_bg_mu_before = None if i == 0 else _torch_moments(
            step.bg_opt, tbg.module, tbg.config, "exp_avg")
        state, jm = j_step(state, {k: jnp.asarray(v) for k, v in b.items()})
        tm = step({"rays": torch.from_numpy(b["rays"]),
                   "rgbs": torch.from_numpy(b["rgbs"]),
                   "img_indices": torch.from_numpy(b["img_indices"]).long()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5)
        np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]), rtol=1e-5)
        _assert_trees_close(flax_params_from_state(tfg.config, tfg.module.state_dict()),
                            state.fg_params, 1e-5, f"step {i} fg params")
        _assert_trees_close(flax_params_from_state(tbg.config, tbg.module.state_dict()),
                            state.bg_params, 1e-5, f"step {i} bg params")
        adam = state.fg_opt[0]
        _assert_trees_close(_torch_moments(step.fg_opt, tfg.module, tfg.config, "exp_avg"),
                            adam.mu, 1e-5, f"step {i} fg mu")
        _assert_trees_close(_torch_moments(step.fg_opt, tfg.module, tfg.config, "exp_avg_sq"),
                            adam.nu, 1e-5, f"step {i} fg nu")
        _assert_trees_close(_torch_moments(step.bg_opt, tbg.module, tbg.config, "exp_avg"),
                            state.bg_opt[0].mu, 1e-5, f"step {i} bg mu")
        if i == 2:  # no background ray: the bg step is skipped in both
            _assert_trees_close(jax.device_get(state.bg_params), bg_before, 0, "jax bg")
            _assert_trees_close(jax.device_get(state.bg_opt), bg_opt_before, 0, "jax bg opt")
            for k, v in tbg.module.state_dict().items():
                assert torch.equal(v, t_bg_before[k]), k
            _assert_trees_close(_torch_moments(step.bg_opt, tbg.module, tbg.config, "exp_avg"),
                                t_bg_mu_before, 0, "port bg mu")
            assert step.bg_sched.last_epoch == 2 and step.fg_sched.last_epoch == 3
    assert int(state.step) == 3


def _train_args(ds, exp, steps, extra=()):
    return _args(ds, exp, True) + [
        "--dataset_type", "memory", "--batch_size", "64",
        "--train_iterations", str(steps), "--ckpt_interval", "2", "--lr", "5e-3",
        "--device", "cpu", *extra]


def test_runner_train_checkpoint_resume_and_jax_interop(tmp_path):
    ds = make_synthetic_dataset(tmp_path / "ds", n_train=3, n_val=1, hw=(16, 16))
    hp = port_train.get_train_opts(_train_args(ds, tmp_path / "texp", 3,
                                               ["--val_interval", "1"]))
    runner = TRunner(hp)
    renders = []  # every validation's view, in order (one val image)
    render_image = runner.render_image

    def recording_render(meta):
        out = render_image(meta)
        renders.append(out["rgb_fine"])
        return out

    runner.render_image = recording_render
    metrics = runner.train()
    models = tmp_path / "texp" / "0" / "models"
    assert sorted(p.name for p in models.iterdir()) == ["2.pt", "3.pt"]
    assert (tmp_path / "texp" / "0" / "metrics.txt").exists()
    assert np.isfinite(metrics["val/psnr"])

    # The validation after step 1 packed the eval weights; the final one
    # (after two more optimizer steps) rendered the trained weights: its
    # view differs from step 1's and equals one from freshly packed weights.
    assert len(renders) == 4
    for b in (runner.fg, runner.bg):
        b.packed = None
    fresh = render_image(runner.val_items[0])["rgb_fine"]
    assert not np.array_equal(renders[0], renders[-1])
    np.testing.assert_array_equal(renders[-1], fresh)

    ckpt = models / "3.pt"
    # The port's eval and the JAX eval on the port's checkpoint.
    t_hp = port_eval.get_eval_opts(_args(ds, tmp_path / "teval", True)
                                   + ["--ckpt_path", str(ckpt), "--device", "cpu"])
    t_metrics = port_eval.main(t_hp)
    assert abs(t_metrics["val/psnr"] - metrics["val/psnr"]) < 1e-6
    j_hp = _j_hparams(_args(ds, tmp_path / "jexp", True) + ["--ckpt_path", str(ckpt)])
    JRunner(j_hp).eval()
    assert abs(_metric(tmp_path / "jexp", "val/psnr") - t_metrics["val/psnr"]) < 0.01

    # The JAX checkpoint import reads the port's Adam moments.
    j_runner = JRunner(j_hp, set_experiment_path=False)
    opt = j_make_optimizer(5e-3, 0.1, 3)
    j_state = j_make_state(j_runner.fg, j_runner.bg, opt, jax.random.PRNGKey(0))
    j_state, aux = j_runner._load_checkpoint_into_state(ckpt, j_state)
    assert aux["iteration"] == 3
    step = runner.train_step
    for side, bundle, t_opt in (("fg", runner.fg, step.fg_opt),
                                ("bg", runner.bg, step.bg_opt)):
        adam = getattr(j_state, f"{side}_opt")[0]
        assert isinstance(adam, optax.ScaleByAdamState)
        for key, want in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            _assert_trees_close(_torch_moments(t_opt, bundle.module, bundle.config, key),
                                want, 0, f"{side} {key}")

    # Resume continues the iteration count (and the schedule).
    r_hp = port_train.get_train_opts(_train_args(ds, tmp_path / "texp", 5)
                                     + ["--ckpt_path", str(ckpt)])
    resumed = TRunner(r_hp)
    resumed.train()
    assert sorted(p.name for p in (tmp_path / "texp" / "1" / "models").iterdir()) \
        == ["4.pt", "5.pt"]
    assert torch.load(tmp_path / "texp" / "1" / "models" / "5.pt",
                      weights_only=False)["iteration"] == 5
    assert resumed.train_step.fg_sched.last_epoch == 5


def test_train_cuda_without_card_and_filesystem_dataset_raise(tmp_path):
    ds = make_synthetic_dataset(tmp_path / "ds", n_train=2, n_val=1, hw=(8, 8))
    args = [a for a in _train_args(ds, tmp_path / "exp", 2) if a not in ("--device", "cpu")]
    hp = port_train.get_train_opts(args)
    assert hp.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_train.main(hp)
    # The filesystem dataset (the default) trains; without --chunk_paths
    # it has no store to write and raises.
    hp = port_train.get_train_opts(_train_args(ds, tmp_path / "exp2", 2)
                                   + ["--dataset_type", "filesystem"])
    with pytest.raises(ValueError, match="needs --chunk_paths"):
        port_train.main(hp)
