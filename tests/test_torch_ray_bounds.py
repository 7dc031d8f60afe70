"""The port's occupancy bounds against the JAX package's, on the CPU.

- `render/ray_bounds.py` (numpy in both packages): `_dilate6`,
  `occupancy_grid` (leaves at several depths, capped resolutions),
  `tighten_rays` (`near` and `both`, with and without the fg ellipsoid) and
  `load_occupancy` (a packed grid, a viewer octree with the automatic and a
  given threshold) equal the JAX functions.
- `render_rays(fg_bounds=...)` against the JAX renderer (the tolerances of
  `tests/test_torch_render.py`): bounds that change nothing, shrunk
  bounds, collapsed rays, and rays without a background whose last
  sample keeps the INF_DELTA catch-all; pass-through bounds equal no
  bounds in the port.
- `scripts/bake_occupancy.py` on a K = 4 container: the same grid and
  keys as the JAX script's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_nerf_tpu.octree.n3tree import N3Tree as JTree
from mega_nerf_tpu.render import RenderSettings as JSettings
from mega_nerf_tpu.render import ray_bounds as jrb
from mega_nerf_tpu.render import render_rays as j_render_rays
from mega_nerf_tpu_torch.octree import N3Tree
from mega_nerf_tpu_torch.render import ray_bounds as trb
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays
from mega_nerf_tpu_torch.scripts import bake_occupancy
from tests.test_models import tiny_hparams
from tests.test_torch_cell_cull import mixture_scene  # noqa: F401 (fixture)
from tests.test_torch_eval import _args
from tests.test_torch_render import CENTER, RADIUS, _bundles


def _tree(cls, seed=0):
    tree = cls(N=2, data_dim=4, depth_limit=6, center=[0.2, -0.1, 0.0],
               radius=[1.5, 1.2, 1.3])
    rng = np.random.default_rng(seed)
    for depth in range(4):
        tree.refine_at_points(rng.normal(size=(60 // (depth + 1), 3)).astype(np.float32) * 0.5)
    leaves = tree.leaf_indices()
    data = rng.uniform(0, 1, (leaves.shape[0], 4)).astype(np.float32)
    data[:, 3] = np.where(rng.random(leaves.shape[0]) < 0.3, rng.uniform(5, 50, leaves.shape[0]),
                          rng.uniform(0, 0.5, leaves.shape[0]))
    tree.set_leaf_data(leaves, data)
    tree.shrink_to_fit()
    return tree


def _rays(rng, n, far=4.0):
    o = np.tile(np.array([[-1.2, 0.1, 0.2]], np.float32), (n, 1))  # inside the box
    o += rng.normal(scale=0.1, size=(n, 3)).astype(np.float32)
    d = rng.normal(scale=0.4, size=(n, 3)).astype(np.float32) + np.array([1.0, 0, 0], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((n, 1), 0.1, np.float32),
                           np.full((n, 1), far, np.float32)], 1)


@pytest.mark.parametrize("max_res,dilate", [(256, 1), (8, 0), (12, 2)])
def test_occupancy_grid_and_dilation_match_jax(max_res, dilate):
    jt, tt = _tree(JTree), _tree(N3Tree)
    for thresh in (0.0, 4.0):
        np.testing.assert_array_equal(
            trb.occupancy_grid(tt, thresh, dilate, max_res),
            jrb.occupancy_grid(jt, thresh, dilate, max_res))
    grid = np.random.default_rng(1).random((9, 7, 5)) < 0.1
    np.testing.assert_array_equal(trb._dilate6(grid, 2), jrb._dilate6(grid, 2))


@pytest.mark.parametrize("mode", ["near", "both"])
@pytest.mark.parametrize("sphere", [False, True])
def test_tighten_rays_matches_jax(mode, sphere):
    tree = _tree(N3Tree)
    grid = trb.occupancy_grid(tree, 4.0)
    assert 0 < grid.mean() < 0.9
    rays = _rays(np.random.default_rng(2), 300, far=1e5 if sphere else 4.0)
    kw = dict(probes=32, mode=mode, chunk=128)
    if sphere:
        kw.update(sphere_center=np.array([0.1, 0.0, 0.1]), sphere_radius=np.array([2.5, 2.0, 2.2]))
    got = trb.tighten_rays(rays, grid, tree.invradius, tree.offset, **kw)
    want = jrb.tighten_rays(rays, grid, tree.invradius, tree.offset, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] > rays[:, 6]).any()  # some rays tighten


def test_load_occupancy_matches_jax(tmp_path):
    tree = _tree(N3Tree)
    tree.save(tmp_path / "tree.npz")
    grid = np.random.default_rng(3).random((10, 10, 10)) < 0.2
    np.savez_compressed(tmp_path / "occ.npz", occupancy=np.packbits(grid.reshape(-1)),
                        res=np.int64(10), invradius3=np.full(3, 0.2, np.float32),
                        offset=np.full(3, 0.5, np.float32), sigma_thresh=np.float32(1.0))
    cases = [("tree.npz", dict()), ("tree.npz", dict(thresh=2.0, dilate=0)),
             ("occ.npz", dict(dilate=1)), ("occ.npz", dict(dilate=0))]
    for name, kw in cases:
        got = trb.load_occupancy(tmp_path / name, **kw)
        want = jrb.load_occupancy(tmp_path / name, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {kw}")
    with pytest.warns(UserWarning, match="ignored"):
        trb.load_occupancy(tmp_path / "occ.npz", thresh=1.0)


def _render_both(bounds_fn, bg=True, seed=3):
    hp = tiny_hparams(appearance_dim=4, compute_dtype="float32")
    (jfg, pfg, tfg), (jbg, pbg, tbg) = _bundles(hp, 5)
    rng = np.random.default_rng(seed)
    n = 48
    o = (rng.uniform(-0.3, 0.3, size=(n, 3)) * 0.5).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    far = np.where(np.arange(n)[:, None] % 2 == 0, 1e5, 0.8) if bg else np.full((n, 1), 0.8)
    rays = np.concatenate([o, d, np.full((n, 1), 0.05), far], -1).astype(np.float32)
    bounds = bounds_fn(rays, rng).astype(np.float32)
    idx = np.arange(n, dtype=np.int32) % 5
    jset = JSettings(coarse_samples=16, fine_samples=24, use_pallas=False,
                     eval_compositor="merge", get_depth=True, get_bg_fg_rgb=bg)
    args = (jnp.asarray(CENTER), jnp.asarray(RADIUS)) if bg else (None, None)
    render = jax.jit(lambda pf, pb, r, i, fb: j_render_rays(
        jfg, jbg if bg else None, pf, pb, r, i, jset, *args, train=False, fg_bounds=fb)[0])
    want = render(pfg, pbg if bg else None, jnp.asarray(rays), jnp.asarray(idx),
                  jnp.asarray(bounds))
    tset = RenderSettings(coarse_samples=16, fine_samples=24, get_depth=True,
                          get_bg_fg_rgb=bg)
    targs = (torch.from_numpy(CENTER), torch.from_numpy(RADIUS)) if bg else (None, None)
    with torch.no_grad():
        got, _ = render_rays(tfg, tbg if bg else None, torch.from_numpy(rays),
                             torch.from_numpy(idx).long(), tset, *targs,
                             fg_bounds=torch.from_numpy(bounds))
        plain, _ = render_rays(tfg, tbg if bg else None, torch.from_numpy(rays),
                               torch.from_numpy(idx).long(), tset, *targs)
    for key in ("rgb_fine", "fg_rgb_fine", "bg_rgb_fine") if bg else ("rgb_fine",):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(got["depth_fine"].numpy(), np.asarray(want["depth_fine"]),
                               rtol=5e-4, atol=1e-5)
    return rays, bounds, got, plain


def _passthrough(rays, rng):
    return np.stack([np.zeros(len(rays)), np.full(len(rays), 1e9)], 1)


def _shrunk(rays, rng):
    lo = rays[:, 6] + rng.uniform(0.0, 0.2, len(rays))
    return np.stack([lo, lo + rng.uniform(0.05, 0.4, len(rays))], 1)


def _collapsed(rays, rng):
    b = _shrunk(rays, rng)
    b[::3, 1] = b[::3, 0] = 0.9  # past the 0.8 far of the fg-only rays too
    b[1::3, 1] = b[1::3, 0] - 0.01  # hi below lo
    return b


@pytest.mark.parametrize("case", ["passthrough", "shrunk", "collapsed", "no_bg_catch_all"])
def test_render_rays_fg_bounds_match_jax(case):
    fn = {"passthrough": _passthrough, "shrunk": _shrunk, "collapsed": _collapsed,
          "no_bg_catch_all": _shrunk}[case]
    rays, bounds, got, plain = _render_both(fn, bg=case != "no_bg_catch_all")
    if case == "passthrough":
        for key in got:
            torch.testing.assert_close(got[key], plain[key], rtol=0, atol=0)
    if case == "collapsed":
        # Collapsed rays: no fg at all, the background alone.
        dead = np.flatnonzero(np.maximum(np.minimum(rays[:, 7], bounds[:, 1]),
                                         np.maximum(rays[:, 6], bounds[:, 0]))
                              <= np.maximum(rays[:, 6], bounds[:, 0]))
        assert dead.size
        assert float(got["fg_rgb_fine"][dead].abs().max()) == 0.0
    if case == "no_bg_catch_all":
        # Without a background the last fg sample absorbs the residual
        # transmittance: shrinking the interval darkens nothing wholesale.
        assert float((got["rgb_fine"].sum(-1) - plain["rgb_fine"].sum(-1)).abs().mean()) < 0.5


def test_bake_occupancy_matches_jax(mixture_scene, tmp_path, monkeypatch):
    import sys

    import scripts.bake_occupancy as j_bake

    ds, container, _ = mixture_scene
    args = _args(ds, tmp_path / "unused", True)
    args = args[:2] + args[4:] + ["--container_path", str(container), "--res", "12"]
    assert "--exp_name" not in args  # neither script takes one
    monkeypatch.setattr(sys, "argv", ["bake_occupancy"] + args
                        + ["--output", str(tmp_path / "jax.npz")])
    j_bake.main()
    share = bake_occupancy.main(bake_occupancy.get_bake_opts(
        args + ["--output", str(tmp_path / "port.npz"), "--device", "cpu"]))
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert set(got.files) == set(want.files) == {
            "occupancy", "res", "invradius3", "offset", "sigma_thresh"}
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    grid = trb.load_occupancy(tmp_path / "port.npz", dilate=0)[0]
    assert grid.shape == (12, 12, 12) and abs(grid.mean() - share) < 1e-9
