"""The port's joint Mega-NeRF training (`--train_mega_nerf`) against the JAX
package's, on the CPU.

- A train-mode `render_rays` of K = 2 fg and bg mixtures (hard assignment,
  the bg routed on real-world coordinates) without a generator: loss rtol
  1e-5 and every submodule's gradients atol 1e-5 against the JAX
  `render_rays(train=True)` (XLA's dense blend), through the kernels' plain
  versions and through the eager module;
- two `TrainStep`s against the JAX `make_train_step` from the same stacked
  parameters (one Adam over the K submodules), the second on a batch in
  which submodule 1 gets no point: parameters and Adam moments atol 1e-5
  after each; the empty submodule moves by its momentum in both;
- `Runner.train --train_mega_nerf` end to end (as `tests/test_joint_mega.py`):
  every submodule moves, a run resumed from a mid-epoch checkpoint ends bit
  for bit where the uninterrupted one ended, and `eval.main
  --train_mega_nerf --ckpt_path` serves the checkpoint densely and routed
  with the final validation's PSNR;
- `scripts/create_octree.py --train_mega_nerf` against the JAX script on the
  same stacked weights, from the JAX `.ckpt` and from a port `{iter}.pt`:
  the same voxels, leaf data 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mega_nerf_tpu.octree.n3tree as j_n3tree
import scripts.create_octree as j_create_octree
from mega_nerf_tpu.data.torch_io import save_pt
from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.parallel.train_step import make_optimizer as j_make_optimizer
from mega_nerf_tpu.parallel.train_step import make_train_state as j_make_state
from mega_nerf_tpu.parallel.train_step import make_train_step as j_make_step
from mega_nerf_tpu.render import RenderSettings as JSettings
from mega_nerf_tpu.render import render_rays as j_render_rays
from mega_nerf_tpu.runtime import checkpoints as j_ckpt
from mega_nerf_tpu_torch import eval as port_eval
from mega_nerf_tpu_torch import train as port_train
from mega_nerf_tpu_torch.models import flax_params_from_state, make_bg_nerf, make_nerf
from mega_nerf_tpu_torch.parallel.cell_parallel import mixture_states_from_flax
from mega_nerf_tpu_torch.parallel.train_step import TrainStep
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays
from mega_nerf_tpu_torch.runtime.checkpoints import load_checkpoint
from mega_nerf_tpu_torch.scripts import create_octree
from tests.synthetic import make_synthetic_dataset
from tests.test_models import tiny_hparams
from tests.test_torch_cell_cull import CENTROIDS as SCENE_CENTROIDS
from tests.test_torch_cell_cull import bake_args, j_bake_hparams, mixture_scene  # noqa: F401
from tests.test_torch_eval import _args, _metric
from tests.test_torch_octree import captured_jax_tree  # noqa: F401
from tests.test_torch_train_loop import CENTER, RADIUS, _assert_trees_close, _rays

# Two cells split along y (`tests/test_joint_mega.py`'s).
CENTROIDS = np.array([[0.0, -0.7, 0.0], [0.0, 0.7, 0.0]], np.float32)


def _hparams():
    hp = tiny_hparams(appearance_dim=4, compute_dtype="float32", mega_routing="auto",
                      routing_max_experts=4)
    hp._mega_centroid_metadata = {"centroids": CENTROIDS, "cluster_2d": False}
    return hp


def _bundles(hp, count, state):
    """The port's fg and bg mixtures holding a JAX train state's weights."""
    out = []
    for make, params in ((make_nerf, state.fg_params), (make_bg_nerf, state.bg_params)):
        b = make(hp, count)
        for sub, sd in zip(b.module, mixture_states_from_flax(
                b.config, jax.device_get(params), len(b.module))):
            sub.load_state_dict(sd)
        out.append(b)
    return out


def _stacked(bundle, fn):
    """A mixture's per-submodule trees (fn(module) -> state dict) stacked
    on a leading axis, in the JAX package's layout."""
    trees = [flax_params_from_state(bundle.config, fn(m)) for m in bundle.module]
    return jax.tree.map(lambda *leaves: np.stack([np.asarray(x) for x in leaves]), *trees)


def _grads(module):
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in module.named_parameters()}


def _moments(opt, key):
    return lambda m: {n: opt.state[p][key] for n, p in m.named_parameters()}


def _one_sided_rays(n, seed):
    """Rays on the y < 0 side heading further into it: every fg and bg
    sample routes to submodule 0."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.3, -0.1, n),
                  rng.uniform(-0.1, 0.1, n)], 1)
    d = np.stack([rng.normal(0, 0.2, n), -np.ones(n), rng.normal(0, 0.2, n)], 1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    far = np.where(np.arange(n) % 2 == 0, 1e5, 0.8)[:, None]
    return np.concatenate([o, d, np.full((n, 1), 0.05), far], -1).astype(np.float32)


@pytest.mark.parametrize("mlp", ["fused", "eager"])
def test_joint_render_loss_and_grads_match_jax(mlp):
    hp = _hparams()
    jfg, jbg = j_make_nerf(hp, 5), j_make_bg_nerf(hp, 5)
    state = j_make_state(jfg, jbg, j_make_optimizer(1e-3, 0.1, 50), jax.random.key(0))
    tfg, tbg = _bundles(hp, 5, state)
    assert tfg.is_mega and len(tfg.module) == 2 and tbg.xyz_real and not tfg.xyz_real
    rays = _rays(24, seed=3)
    idx = np.arange(24, dtype=np.int32) % 5
    target = np.random.default_rng(4).uniform(size=(24, 3)).astype(np.float32)
    jset = JSettings(coarse_samples=16, fine_samples=16, use_pallas=False, perturb=0.0,
                     sigma_noise=False, get_depth_variance=True)

    def j_loss(fp, bp):
        res, _ = j_render_rays(jfg, jbg, fp, bp, jnp.asarray(rays), jnp.asarray(idx), jset,
                               jnp.asarray(CENTER), jnp.asarray(RADIUS), train=True, key=None)
        return jnp.mean((res["rgb_fine"] - target) ** 2)

    want, (gf, gb) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(
        state.fg_params, state.bg_params)
    tset = RenderSettings(coarse_samples=16, fine_samples=16, perturb=0.0, sigma_noise=False,
                          get_depth_variance=True, use_fused_kernel=(mlp == "fused"))
    tfg.route_log, tbg.route_log = [], []
    res, _ = render_rays(tfg, tbg, torch.from_numpy(rays), torch.from_numpy(idx).long(), tset,
                         torch.from_numpy(CENTER), torch.from_numpy(RADIUS), train=True)
    loss = torch.mean((res["rgb_fine"] - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _assert_trees_close(_stacked(tfg, _grads), gf, 1e-5, "fg")
    _assert_trees_close(_stacked(tbg, _grads), gb, 1e-5, "bg")
    # Each pass ran each submodule once, on the points assigned to it.
    for log, per_ray in ((tfg.route_log, 16), (tbg.route_log, 8)):
        assert len(log) == 2 and all(sum(c) == 24 * per_ray for c in log)


def test_two_joint_steps_match_optax_with_an_empty_submodule():
    hp = _hparams()
    jfg, jbg = j_make_nerf(hp, 5), j_make_bg_nerf(hp, 5)
    opt = j_make_optimizer(1e-3, 0.1, 50)
    state = j_make_state(jfg, jbg, opt, jax.random.key(1))
    tfg, tbg = _bundles(hp, 5, state)
    jset = JSettings(coarse_samples=16, fine_samples=16, use_pallas=False, perturb=0.0,
                     sigma_noise=False)
    j_step = jax.jit(j_make_step(jfg, jbg, jset, opt, jnp.asarray(CENTER),
                                 jnp.asarray(RADIUS)))
    step = TrainStep(tfg, tbg, RenderSettings(coarse_samples=16, fine_samples=16,
                                              perturb=0.0, sigma_noise=False),
                     1e-3, 0.1, 50, torch.from_numpy(CENTER), torch.from_numpy(RADIUS))
    rng = np.random.default_rng(9)
    batches = [_rays(16, seed=10), _one_sided_rays(16, seed=11)]
    for i, rays in enumerate(batches):
        b = {"rays": rays, "rgbs": rng.uniform(size=(16, 3)).astype(np.float32),
             "img_indices": (np.arange(16) % 5).astype(np.int32)}
        before = [sd for sd in (tfg.module[1].state_dict(), tbg.module[1].state_dict())]
        before = [{k: v.clone() for k, v in sd.items()} for sd in before]
        tfg.route_log, tbg.route_log = [], []
        state, jm = j_step(state, {k: jnp.asarray(v) for k, v in b.items()})
        tm = step({"rays": torch.from_numpy(b["rays"]), "rgbs": torch.from_numpy(b["rgbs"]),
                   "img_indices": torch.from_numpy(b["img_indices"]).long()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5)
        for side, bundle, opt_t, params, adam in (
                ("fg", tfg, step.fg_opt, state.fg_params, state.fg_opt[0]),
                ("bg", tbg, step.bg_opt, state.bg_params, state.bg_opt[0])):
            _assert_trees_close(_stacked(bundle, lambda m: m.state_dict()), params, 1e-5,
                                f"step {i} {side} params")
            _assert_trees_close(_stacked(bundle, _moments(opt_t, "exp_avg")), adam.mu, 1e-5,
                                f"step {i} {side} mu")
            _assert_trees_close(_stacked(bundle, _moments(opt_t, "exp_avg_sq")), adam.nu,
                                1e-5, f"step {i} {side} nu")
        if i == 1:
            # Submodule 1 got no point, in fg or bg, yet moved by its momentum.
            assert all(c[1] == 0 for c in tfg.route_log + tbg.route_log)
            for sd, sub in zip(before, (tfg.module[1], tbg.module[1])):
                assert any(not torch.equal(v, sub.state_dict()[k]) for k, v in sd.items())
    assert all(int(s["step"]) == 2 for s in step.fg_opt.state.values())


def _train_args(ds, params, exp, steps, extra=()):
    return _args(ds, exp, True) + [
        "--dataset_type", "memory", "--batch_size", "64", "--train_iterations", str(steps),
        "--ckpt_interval", "3", "--lr", "5e-3", "--device", "cpu",
        "--train_mega_nerf", str(params), *extra]


def test_runner_trains_a_joint_mixture_and_resumes_bit_equal(tmp_path):
    ds = make_synthetic_dataset(tmp_path / "ds", n_train=3, n_val=1, hw=(16, 16))
    save_pt({"centroids": CENTROIDS, "cluster_2d": False, "grid_dim": [2, 1],
             "min_position": np.full(3, -1.5, np.float32),
             "max_position": np.full(3, 1.5, np.float32)}, tmp_path / "params.pt")
    params = tmp_path / "params.pt"
    val = port_train.main(port_train.get_train_opts(
        _train_args(ds, params, tmp_path / "a", 6)))
    assert np.isfinite(val["val/psnr"])
    a3, a6 = (load_checkpoint(tmp_path / "a" / "0" / "models" / f"{i}.pt") for i in (3, 6))
    fg_keys = a6["model_state_dict"].keys()
    assert {k.split(".")[0] for k in fg_keys} == {"0", "1"}
    # Every submodule of both mixtures moved from the seeded initialisation.
    hp0 = port_train.get_train_opts(_train_args(ds, params, tmp_path / "unused", 6))
    from mega_nerf_tpu_torch.runtime.runner import Runner

    init = Runner(hp0, set_experiment_path=False)
    from mega_nerf_tpu_torch.models import init_weights

    init_weights(init.fg.module, torch.Generator().manual_seed(hp0.random_seed))
    for k, v in init.fg.module.state_dict().items():
        if not k.endswith("bias"):
            assert not torch.equal(v, a6["model_state_dict"][k]), k
    # Resumed mid-epoch from step 3: bit for bit the uninterrupted run.
    port_train.main(port_train.get_train_opts(_train_args(
        ds, params, tmp_path / "b", 6, ["--ckpt_path", str(
            tmp_path / "a" / "0" / "models" / "3.pt")])))
    b6 = load_checkpoint(tmp_path / "b" / "0" / "models" / "6.pt")
    assert a3["iteration"] == 3 and b6["iteration"] == 6
    for key in ("model_state_dict", "bg_model_state_dict"):
        for k, v in a6[key].items():
            assert torch.equal(v, b6[key][k]), (key, k)
    # eval.main serves the checkpoint, densely and routed (hard assignment:
    # the same blend), with the final validation's PSNR.
    for routing in ("dense", "routed"):
        metrics = port_eval.main(port_eval.get_eval_opts(_args(ds, tmp_path / f"e_{routing}", True) + [
            "--ckpt_path", str(tmp_path / "a" / "0" / "models" / "6.pt"), "--device", "cpu",
            "--train_mega_nerf", str(params), "--mega_routing", routing]))
        assert abs(metrics["val/psnr"] - val["val/psnr"]) <= 0.01
    assert abs(_metric(tmp_path / "a", "val/psnr") - val["val/psnr"]) <= 1e-6


@pytest.mark.parametrize("source", ["jax_ckpt", "port_pt"])
def test_create_octree_train_mega_nerf_matches_jax(mixture_scene, tmp_path,  # noqa: F811
                                                   captured_jax_tree, source):  # noqa: F811
    ds, _, _ = mixture_scene
    save_pt({"centroids": SCENE_CENTROIDS, "cluster_2d": False, "grid_dim": [4, 1],
             "min_position": SCENE_CENTROIDS.min(0), "max_position": SCENE_CENTROIDS.max(0)},
            tmp_path / "params.pt")
    mega = ["--train_mega_nerf", str(tmp_path / "params.pt")]
    j_hp = j_bake_hparams(ds, mega, tmp_path / "unused.npz")
    j_hp._mega_centroid_metadata = {"centroids": SCENE_CENTROIDS, "cluster_2d": False}
    state = j_make_state(j_make_nerf(j_hp, 4), j_make_bg_nerf(j_hp, 4),
                         j_make_optimizer(1e-3, 0.1, 10), jax.random.PRNGKey(6))
    j_ckpt.save_checkpoint(tmp_path / "10.ckpt", state, {"iteration": 10})
    j_model = mega + ["--ckpt_path", str(tmp_path / "10.ckpt")]
    model = j_model
    if source == "port_pt":
        fg = make_nerf(j_hp, 4)
        for sub, sd in zip(fg.module, mixture_states_from_flax(
                fg.config, jax.device_get(state.fg_params), 4)):
            sub.load_state_dict(sd)
        torch.save({"model_state_dict": fg.module.state_dict(), "iteration": 10},
                   tmp_path / "10.pt")
        model = mega + ["--ckpt_path", str(tmp_path / "10.pt")]
    j_create_octree.main(j_bake_hparams(ds, j_model, tmp_path / "jax.npz"))
    tree = create_octree.main(create_octree._get_extraction_opts(
        bake_args(ds, model, tmp_path / "port.npz")))
    want = captured_jax_tree[-1]
    assert isinstance(want, j_n3tree.N3Tree)
    assert tree.n_internal == want.n_internal > 1
    np.testing.assert_array_equal(tree.child, want.child)
    np.testing.assert_array_equal(tree.parent_depth, want.parent_depth)
    np.testing.assert_allclose(tree.data, want.data, rtol=0, atol=1e-4)
