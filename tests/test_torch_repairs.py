"""`--remat` and `--occupancy_path` in the port, on the CPU.

- `--remat` recomputes the eager module's activations in the backward pass
  (`torch.utils.checkpoint`): the same loss and gradients as without it,
  with sigma noise and jitter drawn from one generator; two Adam steps
  with `--remat` on both sides match the JAX package's `make_train_step`
  (its `jax.checkpoint` over the XLA MLP) at 1e-5, lr 1e-3.
- `--occupancy_path`, which raised in the port until occupancy bounds
  were ported, renders as the JAX package's does, in the eval entry point
  and in the training entry point's Runner.
- `--cluster_mask_path` with masks made for another scene: a `params.pt`
  whose `near`, `origin_drb`, `pose_scale_factor` or `ray_altitude_range`
  disagrees with the scene makes the JAX `Runner` and the port's `Runner`
  raise (the port's names the key); the masks' own `params.pt` passes.
"""

from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from mega_nerf_tpu.parallel.train_step import make_optimizer as j_make_optimizer
from mega_nerf_tpu.parallel.train_step import make_train_state as j_make_state
from mega_nerf_tpu.parallel.train_step import make_train_step as j_make_step
from mega_nerf_tpu.render import RenderSettings as JSettings
from mega_nerf_tpu.models.torch_interop import torch_state_from_flax_params
from mega_nerf_tpu.runtime.runner import Runner as JRunner
from mega_nerf_tpu_torch import eval as port_eval
from mega_nerf_tpu_torch import train as port_train
from mega_nerf_tpu_torch.models import flax_params_from_state, state_from_flax_params
from mega_nerf_tpu_torch.parallel.train_step import TrainStep
from mega_nerf_tpu_torch.data.torch_io import load_pt, save_pt
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays
from mega_nerf_tpu_torch.runtime.runner import Runner as TRunner
from mega_nerf_tpu_torch.scripts import create_cluster_masks
from tests.synthetic import make_synthetic_dataset
from tests.test_torch_cell_cull import write_occupancy
from tests.test_torch_eval import _args, _j_hparams, _metric
from tests.test_models import tiny_hparams
from tests.test_torch_train_loop import (
    CENTER,
    RADIUS,
    _assert_trees_close,
    _bundles,
    _rays,
    _torch_moments,
)


class CheckpointCalls:
    """Counts `torch.utils.checkpoint.checkpoint` calls while patched in."""

    def __init__(self, monkeypatch):
        self.count = 0
        real = torch.utils.checkpoint.checkpoint

        def counting(*args, **kwargs):
            self.count += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)


def test_remat_flag_reaches_the_settings():
    assert RenderSettings.from_hparams(Namespace(remat=True)).remat
    assert not RenderSettings.from_hparams(Namespace()).remat


@pytest.mark.parametrize("mlp", ["eager", "fused"])
def test_remat_gives_the_same_loss_and_grads(monkeypatch, mlp):
    """Eager: checkpointed, identical loss and gradients. Fused: the flag is
    ignored (no checkpoint), as the JAX package's Pallas route ignores it."""
    hp = tiny_hparams(appearance_dim=4, compute_dtype="float32")
    (_, _, tfg), (_, _, tbg) = _bundles(hp, 5)
    rays = torch.from_numpy(_rays(24, seed=3))
    idx = torch.arange(24) % 5
    target = torch.from_numpy(np.random.default_rng(4).uniform(size=(24, 3)).astype(np.float32))
    calls = CheckpointCalls(monkeypatch)
    out = {}
    for remat in (False, True):
        for b in (tfg, tbg):
            b.module.zero_grad(set_to_none=True)
        settings = RenderSettings(coarse_samples=16, fine_samples=16, remat=remat,
                                  use_fused_kernel=(mlp == "fused"))
        res, _ = render_rays(tfg, tbg, rays, idx, settings, torch.from_numpy(CENTER),
                             torch.from_numpy(RADIUS), train=True,
                             generator=torch.Generator().manual_seed(5))
        loss = torch.mean((res["rgb_fine"] - target) ** 2)
        loss.backward()
        grads = [p.grad.clone() for b in (tfg, tbg) for p in b.module.parameters()]
        out[remat] = (loss.item(), grads)
    assert calls.count == (4 if mlp == "eager" else 0)  # fg and bg, coarse and fine
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_remat_two_adam_steps_match_jax(monkeypatch):
    hp = tiny_hparams(appearance_dim=4, compute_dtype="float32")
    (jfg, _, tfg), (jbg, _, tbg) = _bundles(hp, 5)
    jset = JSettings(coarse_samples=16, fine_samples=16, use_pallas=False, remat=True,
                     perturb=0.0, sigma_noise=False)
    opt = j_make_optimizer(1e-3, 0.1, 50)
    state = j_make_state(jfg, jbg, opt, jax.random.key(0))
    tfg.module.load_state_dict(state_from_flax_params(tfg.config, jax.device_get(state.fg_params)))
    tbg.module.load_state_dict(state_from_flax_params(tbg.config, jax.device_get(state.bg_params)))
    j_step = jax.jit(j_make_step(jfg, jbg, jset, opt, jnp.asarray(CENTER), jnp.asarray(RADIUS)))
    tset = RenderSettings(coarse_samples=16, fine_samples=16, perturb=0.0, sigma_noise=False,
                          remat=True, use_fused_kernel=False)
    step = TrainStep(tfg, tbg, tset, 1e-3, 0.1, 50, torch.from_numpy(CENTER),
                     torch.from_numpy(RADIUS))
    calls = CheckpointCalls(monkeypatch)
    rng = np.random.default_rng(9)
    for i in range(2):
        b = {"rays": _rays(16, seed=10 + i), "rgbs": rng.uniform(size=(16, 3)).astype(np.float32),
             "img_indices": (np.arange(16) % 5).astype(np.int32)}
        state, jm = j_step(state, {k: jnp.asarray(v) for k, v in b.items()})
        tm = step({"rays": torch.from_numpy(b["rays"]), "rgbs": torch.from_numpy(b["rgbs"]),
                   "img_indices": torch.from_numpy(b["img_indices"]).long()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5)
        _assert_trees_close(flax_params_from_state(tfg.config, tfg.module.state_dict()),
                            state.fg_params, 1e-5, f"step {i} fg params")
        _assert_trees_close(flax_params_from_state(tbg.config, tbg.module.state_dict()),
                            state.bg_params, 1e-5, f"step {i} bg params")
        _assert_trees_close(_torch_moments(step.fg_opt, tfg.module, tfg.config, "exp_avg"),
                            state.fg_opt[0].mu, 1e-5, f"step {i} fg mu")
    assert calls.count == 8  # 4 MLP passes a step


@pytest.mark.parametrize("entry", ["eval", "train"])
def test_occupancy_path_raises(tmp_path, entry):
    """`--occupancy_path` (which raised until occupancy bounds were ported)
    renders as the JAX package's does: eval.main's PSNR within 0.01 dB of
    the JAX Runner's and the view's rgb within 1e-4, and the training entry
    point's Runner (its validation renders) likewise."""
    ds = make_synthetic_dataset(tmp_path / "ds", n_train=3, n_val=1, hw=(16, 16))
    init = JRunner(_j_hparams(_args(ds, tmp_path / "init", True)), set_experiment_path=False)
    state = init.make_eval_state()
    save_pt({"model_state_dict": torch_state_from_flax_params(
        init.fg.config, jax.device_get(state.fg_params)),
        "bg_model_state_dict": torch_state_from_flax_params(
            init.bg.config, jax.device_get(state.bg_params)), "iteration": 7},
        tmp_path / "7.pt")
    ckpt = ["--ckpt_path", str(tmp_path / "7.pt")]
    occupancy = ["--occupancy_path", str(write_occupancy(tmp_path / "occupancy.npz")),
                 "--occupancy_mode", "both"]
    j_runner = JRunner(_j_hparams(_args(ds, tmp_path / "jexp", True) + ckpt + occupancy))
    want = j_runner.render_image(j_runner.val_items[0], j_runner.make_eval_state())
    args = _args(ds, tmp_path / "texp", True) + ckpt + occupancy + ["--device", "cpu"]
    if entry == "eval":
        j_runner.eval()
        metrics = port_eval.main(port_eval.get_eval_opts(args))
        assert abs(_metric(tmp_path / "jexp", "val/psnr") - metrics["val/psnr"]) < 0.01
        runner = TRunner(port_eval.get_eval_opts(args), set_experiment_path=False)
        runner.make_eval_state()
    else:
        runner = TRunner(port_train.get_train_opts(args), set_experiment_path=False)
        runner._load_weights(tmp_path / "7.pt")
    got = runner.render_image(runner.val_items[0])
    assert runner.view_stats["bounded"]
    plain = TRunner(port_eval.get_eval_opts(_args(ds, tmp_path / "plain", True) + ckpt
                                            + ["--device", "cpu"]), set_experiment_path=False)
    plain.make_eval_state()
    assert not np.allclose(plain.render_image(plain.val_items[0])["rgb_fine"],
                           got["rgb_fine"], atol=1e-3)  # the bounds change the view
    np.testing.assert_allclose(got["rgb_fine"], want["rgb_fine"], rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def masked_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("mask_params")
    ds = make_synthetic_dataset(root / "ds", n_train=2, n_val=1, hw=(8, 8))
    create_cluster_masks.main(create_cluster_masks.get_mask_opts([
        "--dataset_path", str(ds), "--output", str(root / "masks"), "--grid_dim", "2", "1",
        "--ray_samples", "8", "--ray_altitude_range", "-1.0", "1.0", "--near", "0.5",
        "--device", "cpu"]))
    return root, ds


def _masked_args(root, ds, masks):
    return _args(ds, root / "exp", True) + ["--cluster_mask_path", str(masks / "0")]


@pytest.mark.parametrize("key, value", [
    ("near", 0.6), ("origin_drb", np.array([0.5, 0.0, 0.0])),
    ("pose_scale_factor", 2.0), ("ray_altitude_range", [-1.0, 0.8])])
def test_masks_of_another_scene_raise_in_both_runners(masked_scene, tmp_path, key, value):
    root, ds = masked_scene
    masks = tmp_path / "masks"
    masks.mkdir()
    params = load_pt(root / "masks" / "params.pt")
    params[key] = value
    save_pt(params, masks / "params.pt")
    with pytest.raises(AssertionError):
        JRunner(_j_hparams(_masked_args(root, ds, masks)), set_experiment_path=False)
    with pytest.raises(ValueError, match=key):
        TRunner(port_train.get_train_opts(_masked_args(root, ds, masks) + ["--device", "cpu"]),
                set_experiment_path=False)


def test_masks_of_this_scene_pass_the_check(masked_scene):
    root, ds = masked_scene
    args = _masked_args(root, ds, root / "masks")
    JRunner(_j_hparams(args), set_experiment_path=False)
    runner = TRunner(port_train.get_train_opts(args + ["--device", "cpu"]),
                     set_experiment_path=False)
    assert runner.train_items[0]._mask_path.parent == root / "masks" / "0"
