"""The port's Mega-NeRF mixture against the JAX package's, on the CPU.

Tiny f32 submodules (K = 3, JAX-initialised, carried over as reference
state dicts in one container that both packages load), inputs from numpy
seeds:
- `cluster_weights`: the one-hot (margin 1) bit-equal, the blend (margin
  1.15) within 1e-6, with and without the altitude axis;
- `depth2pts_outside` with real-world routing coordinates: 1e-5;
- the dense `mega_apply` of the fg and the bg mixture against the JAX
  `ModelBundle.apply`: 5e-5 (the blend sums in another order);
- eval `render_rays` with fg and bg mixtures against the JAX renderer (XLA
  mixture, pairwise merge compositor): rgb 1e-4, depth rtol 5e-4, through
  the kernels' plain versions and through the eager module;
- training from --container_path raises (the routed forms and joint
  training: `tests/test_torch_mega_routing.py`,
  `tests/test_torch_joint_mega.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models.container import ContainerData as JContainerData
from mega_nerf_tpu.models.container import container_to_bundles as j_to_bundles
from mega_nerf_tpu.models.mega import cluster_weights as j_cluster_weights
from mega_nerf_tpu.models.torch_interop import torch_state_from_flax_params
from mega_nerf_tpu.ops.geometry import depth2pts_outside as j_depth2pts_outside
from mega_nerf_tpu.render import RenderSettings as JSettings
from mega_nerf_tpu.render import render_rays as j_render_rays
from mega_nerf_tpu_torch.models.container import ContainerData, container_to_bundles
from mega_nerf_tpu_torch.models.mega import cluster_weights
from mega_nerf_tpu_torch.ops.geometry import depth2pts_outside
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays
from mega_nerf_tpu_torch.scripts.merge_submodules import mixture_forward
from tests.test_models import tiny_hparams

CENTER = np.array([0.05, -0.1, 0.0], np.float32)
RADIUS = np.array([1.4, 1.1, 1.2], np.float32)
# Three cells around the origin (DRB), each owning part of the rays.
CENTROIDS = np.array([[0.0, -0.5, -0.2], [0.1, 0.5, -0.3], [-0.1, 0.0, 0.6]], np.float32)


def mixture_hparams(margin=1.15, **kw):
    base = dict(appearance_dim=4, compute_dtype="float32", boundary_margin=margin,
                mega_routing="auto", routing_max_experts=4)
    base.update(kw)
    return tiny_hparams(**base)


def container_data(hp, k=3, count=5, seed=0, bg=True, cluster_2d=False, cls=ContainerData):
    """K JAX-initialised fg (and bg) submodules as reference state dicts."""
    def states(make, offset):
        jb = make(hp, count)
        return [torch_state_from_flax_params(
            jb.config, jax.device_get(jb.init(jax.random.key(seed + offset + i))))
            for i in range(k)]

    return cls(
        centroids=CENTROIDS[:k], grid_dim=(k, 1),
        min_position=CENTROIDS[:k].min(0), max_position=CENTROIDS[:k].max(0),
        need_viewdir=hp.pos_dir_dim > 0, need_appearance_embedding=hp.appearance_dim > 0,
        cluster_2d=cluster_2d, fg_states=states(j_make_nerf, 0),
        bg_states=states(j_make_bg_nerf, 100) if bg else [])


def both_bundles(hp, **kw):
    """(JAX fg, bg, their stacked params) and (port fg, bg) of one container."""
    jfg, jbg = j_to_bundles(container_data(hp, cls=JContainerData, **kw), hp)
    tfg, tbg = container_to_bundles(container_data(hp, **kw), hp)
    return (jfg, jbg), (tfg, tbg)


@pytest.mark.parametrize("cluster_dim_start", [0, 1])
@pytest.mark.parametrize("margin", [1.0, 1.15])
def test_cluster_weights_match_jax(margin, cluster_dim_start):
    rng = np.random.default_rng(0)
    pts = rng.normal(scale=0.6, size=(777, 3)).astype(np.float32)
    cents = rng.normal(scale=0.5, size=(3, 3)).astype(np.float32)
    want = np.asarray(j_cluster_weights(jnp.asarray(pts), jnp.asarray(cents), margin,
                                        cluster_dim_start))
    got = cluster_weights(torch.from_numpy(pts), torch.from_numpy(cents), margin,
                          cluster_dim_start).numpy()
    assert got.shape == want.shape == (777, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    if margin == 1:
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) == {0.0, 1.0}
    else:
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert ((got > 0).sum(-1) > 1).any()  # some points blend


@pytest.mark.parametrize("cluster_2d", [False, True])
def test_depth2pts_outside_routing_coords_match_jax(cluster_2d):
    rng = np.random.default_rng(1)
    o = rng.uniform(-0.2, 0.2, size=(40, 1, 3)).astype(np.float32)
    d = rng.normal(size=(40, 1, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depth = np.sort(rng.uniform(0, 1, size=(40, 9)), -1).astype(np.float32)
    args = (o, d, depth, CENTER, RADIUS)
    want_pts, want_real = j_depth2pts_outside(*map(jnp.asarray, args), True, cluster_2d)
    got_pts, got_real = depth2pts_outside(*map(torch.from_numpy, args),
                                          include_xyz_real=True, cluster_2d=cluster_2d)
    assert got_pts.shape == (40, 9, 7)
    np.testing.assert_allclose(got_pts.numpy(), np.asarray(want_pts), atol=1e-5)
    np.testing.assert_allclose(got_real.numpy(), np.asarray(want_real), rtol=1e-5)
    plain, _ = depth2pts_outside(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(got_pts[..., 3:].numpy(), plain.numpy())


@pytest.mark.parametrize("margin", [1.0, 1.15])
def test_mega_apply_matches_jax(margin):
    """The dense blend of the fg mixture (xyz) and the bg mixture (routing
    xyz + the 4-d input) on the same weights: 5e-5."""
    hp = mixture_hparams(margin)
    (jfg, jbg), (tfg, tbg) = both_bundles(hp)
    rng = np.random.default_rng(2)
    n = 300
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    idx = rng.integers(0, 5, size=n)
    for jb, tb, width in ((jfg, tfg, 3), (jbg, tbg, 7)):
        xyz = rng.normal(scale=0.6, size=(n, width)).astype(np.float32)
        want = np.asarray(jb.apply(jb.pretrained_params, "fine", jnp.asarray(xyz),
                                   jnp.asarray(dirs), jnp.asarray(idx, jnp.int32)))
        got = mixture_forward(tb, torch.from_numpy(xyz), torch.from_numpy(dirs),
                              torch.from_numpy(idx).long()).numpy()
        assert got.shape == want.shape == (n, 4)
        np.testing.assert_allclose(got, want, atol=5e-5)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-0.3, 0.3, size=(n, 3)) * 0.5).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    near = np.full((n, 1), 0.05, np.float32)
    far = np.where(np.arange(n)[:, None] % 2 == 0, 1e5, 0.8).astype(np.float32)
    return np.concatenate([o, d, near, far], -1)


@pytest.mark.parametrize("mlp", ["fused", "eager"])
@pytest.mark.parametrize("margin,cluster_2d", [(1.0, False), (1.15, True)])
def test_render_rays_mixture_matches_jax(margin, cluster_2d, mlp):
    hp = mixture_hparams(margin)
    (jfg, jbg), (tfg, tbg) = both_bundles(hp, cluster_2d=cluster_2d)
    rays = _rays(40, seed=3)
    idx = np.arange(40, dtype=np.int32) % 5
    jset = JSettings(coarse_samples=16, fine_samples=24, use_pallas=False,
                     eval_compositor="merge", get_depth=True, get_bg_fg_rgb=True)
    want, _ = j_render_rays(jfg, jbg, jfg.pretrained_params, jbg.pretrained_params,
                            jnp.asarray(rays), jnp.asarray(idx), jset, jnp.asarray(CENTER),
                            jnp.asarray(RADIUS), train=False)
    tset = RenderSettings(coarse_samples=16, fine_samples=24, get_depth=True,
                          get_bg_fg_rgb=True, use_fused_kernel=(mlp == "fused"))
    with torch.no_grad():
        got, _ = render_rays(tfg, tbg, torch.from_numpy(rays), torch.from_numpy(idx).long(),
                             tset, torch.from_numpy(CENTER), torch.from_numpy(RADIUS))
    assert set(got) == set(want)
    for key in ("rgb_fine", "fg_rgb_fine", "bg_rgb_fine"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                   err_msg=key)
    for key in ("depth_fine", "fg_depth_fine"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=5e-4,
                                   atol=1e-5, err_msg=key)
    if mlp == "fused":  # each submodule on its own packed weights
        assert set(tfg.packed) == {("sub", k) for k in range(3)}


def test_training_from_container_path_raises(tmp_path):
    """The JAX Runner trains a freshly initialised mixture from
    --container_path and ignores the container's weights (an open check in
    ROADMAP.md C), so the port's Runner raises there rather than guess."""
    from mega_nerf_tpu_torch import train as port_train
    from mega_nerf_tpu_torch.models.container import save_native_container
    from mega_nerf_tpu_torch.runtime.runner import Runner
    from tests.synthetic import make_synthetic_dataset
    from tests.test_torch_eval import _args

    ds = make_synthetic_dataset(tmp_path / "ds", n_train=2, n_val=1, hw=(8, 8))
    hp = port_train.get_train_opts(_args(ds, tmp_path / "exp", True) + [
        "--dataset_type", "memory", "--device", "cpu"])
    save_native_container(tmp_path / "c.pt", container_data(hp, count=3))
    hp.container_path = str(tmp_path / "c.pt")
    runner = Runner(hp)
    assert runner.fg.is_mega
    with pytest.raises(NotImplementedError, match="ROADMAP.md C"):
        runner.train()
