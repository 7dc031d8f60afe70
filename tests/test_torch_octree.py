"""The port's octree bake against the JAX package's, on the CPU.

- `N3Tree` (numpy in both packages): refinement, lookup, leaf sampling from
  one numpy generator, leaf bounds, internal-node averaging and the
  transforms give equal arrays; a tree saved by either package loads in the
  other with equal arrays and meets the svox contract of
  `tests/test_octree_svox_format.py`.
- `grid_weight_render_max` (torch here, jnp there) at reso 16 over two
  cameras: 1e-5.
- `render_octree_rays` of an RGBA and an SH tree: 1e-5.
- `scripts/create_octree.py` end to end at `--init_grid_depth` 4 on the
  same weights (a K = 4 container, and a JAX `.ckpt` of one NeRF): the same
  voxels (f32 compute; no voxel sits on a threshold here), leaf data within
  1e-4 before the f16 save; `render_octree` of the two trees reports the
  same PSNR. (`--train_mega_nerf`: `tests/test_torch_joint_mega.py`.)
"""

import json
import sys

import jax
import numpy as np
import pytest

import mega_nerf_tpu.octree.n3tree as j_n3tree
import scripts.create_octree as j_create_octree
import scripts.render_octree as j_render_octree
from mega_nerf_tpu.octree import grid_weight_render_max as j_grid_weight
from mega_nerf_tpu.octree.render import render_octree_rays as j_render_octree_rays
from mega_nerf_tpu_torch.octree import N3Tree, grid_weight_render_max
from mega_nerf_tpu_torch.octree.render import render_octree_rays
from mega_nerf_tpu_torch.scripts import create_octree, render_octree
from tests.synthetic import look_at_drb
from tests.test_octree_svox_format import SVOX_CONTRACT
from tests.test_torch_cell_cull import bake_args, j_bake_hparams, mixture_scene


def _both_trees(**kw):
    return j_n3tree.N3Tree(**kw), N3Tree(**kw)


def _assert_trees_equal(a, b):
    assert (a.N, a.data_dim, a.depth_limit, a.data_format, a.n_internal) == \
        (b.N, b.data_dim, b.depth_limit, b.data_format, b.n_internal)
    for key in ("data", "child", "parent_depth", "_corner", "_depth", "invradius",
                "offset"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)


def test_n3tree_matches_jax():
    kw = dict(N=2, data_dim=4, depth_limit=5, radius=[1.0, 2.0, 0.5],
              center=[0.1, -0.2, 0.3], init_reserve=4)
    jt, tt = _both_trees(**kw)
    pts = np.random.default_rng(0).uniform(-1, 1, (300, 3)).astype(np.float32)
    for _ in range(3):
        assert jt.refine_at_points(pts[:40]) == tt.refine_at_points(pts[:40])
    np.testing.assert_array_equal(jt.world_to_tree(pts), tt.world_to_tree(pts))
    np.testing.assert_array_equal(jt.tree_to_world(pts), tt.tree_to_world(pts))
    for got, want in zip(tt._locate(tt.world_to_tree(pts)), jt._locate(jt.world_to_tree(pts))):
        np.testing.assert_array_equal(got, want)
    leaves = tt.leaf_indices()
    np.testing.assert_array_equal(leaves, jt.leaf_indices())
    for got, want in zip(tt.leaf_bounds(leaves), jt.leaf_bounds(leaves)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tt.sample_leaves(leaves, 5, np.random.default_rng(1)),
        jt.sample_leaves(leaves, 5, np.random.default_rng(1)))
    values = np.random.default_rng(2).random((leaves.shape[0], 4)).astype(np.float32)
    for t in (jt, tt):
        t.set_leaf_data(leaves, values)
        t.shrink_to_fit()
        t.fill_internal()
    np.testing.assert_array_equal(tt.get_leaf_data(leaves), jt.get_leaf_data(leaves))
    _assert_trees_equal(jt, tt)
    assert repr(jt) == repr(tt)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_saved_tree_loads_in_the_other_package(tmp_path, writer):
    jt, tt = _both_trees(N=2, data_dim=4, depth_limit=4, radius=[1.0, 2.0, 3.0],
                         center=[0.1, 0.2, 0.3], data_format="RGBA")
    for t in (jt, tt):
        t.refine_at_points(np.random.default_rng(0).random((20, 3)) * 2 - 1)
        leaves = t.leaf_indices()
        t.set_leaf_data(leaves, np.random.default_rng(2).random(
            (leaves.shape[0], 4)).astype(np.float32))
        t.shrink_to_fit()
    path = tmp_path / "tree.npz"
    (jt if writer == "jax" else tt).save(path)
    with np.load(path, allow_pickle=False) as z:
        assert set(z.files) == set(SVOX_CONTRACT)
        for key, dtype in SVOX_CONTRACT.items():
            if dtype is not None:
                assert z[key].dtype == dtype, key
    other = (N3Tree if writer == "jax" else j_n3tree.N3Tree).load(path)
    same = (j_n3tree.N3Tree if writer == "jax" else N3Tree).load(path)
    _assert_trees_equal(other, same)
    # Each package's save of the same tree writes the same arrays.
    (tmp_path / "again").mkdir()
    other.save(tmp_path / "again" / "tree.npz")
    with np.load(path) as a, np.load(tmp_path / "again" / "tree.npz") as b:
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_grid_weight_matches_jax():
    reso = 16
    rng = np.random.default_rng(3)
    sigma = rng.uniform(0.0, 8.0, (reso, reso, reso)).astype(np.float32)
    sigma[:, :, 10:] *= 20.0  # an occluding slab
    invradius = np.array([0.5, 0.4, 0.45], np.float32)
    offset = np.array([0.5, 0.55, 0.5], np.float32)
    poses = np.stack([look_at_drb(np.array([0.3, 0.2, -2.5])),
                      look_at_drb(np.array([-0.2, 1.5, 1.8]))]).astype(np.float32)
    cam = [12, 10, 11.0, 11.0, 6.0, 5.0]
    want = j_grid_weight(sigma, poses, cam, offset, invradius, reso)
    got = grid_weight_render_max(sigma, poses, cam, offset, invradius, reso,
                                 pixel_chunk=50)
    assert want.max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("data_format", ["RGBA", "SH4"])
def test_render_octree_rays_matches_jax(data_format):
    dim = 4 if data_format == "RGBA" else 13
    tree = N3Tree(N=2, data_dim=dim, depth_limit=5, center=np.zeros(3),
                  radius=np.full(3, 1.5), data_format=data_format)
    rng = np.random.default_rng(4)
    for _ in range(4):
        tree.refine_at_points(rng.normal(size=(200, 3)).astype(np.float32) * 0.6)
    leaves = tree.leaf_indices()
    data = rng.uniform(0, 1, (leaves.shape[0], dim)).astype(np.float32)
    data[:, -1] *= 30.0
    tree.set_leaf_data(leaves, data)
    tree.fill_internal()
    o = np.tile(np.array([[-2.5, 0.2, 0.1]], np.float32), (64, 1))
    d = rng.normal(size=(64, 3)).astype(np.float32) * 0.3 + np.array([1.0, 0, 0], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((64, 1), 0.5, np.float32),
                           np.full((64, 1), 4.5, np.float32)], 1)
    want = j_render_octree_rays(tree, rays, steps=48)
    got = render_octree_rays(tree, rays, steps=48)
    assert set(got) == set(want) == {"rgb", "depth", "opacity"}
    assert want["opacity"].max() > 0.5
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.fixture
def captured_jax_tree(monkeypatch):
    """The JAX script's tree just before its f16 save (leaf data in f32)."""
    trees = []
    real = j_n3tree.N3Tree.save

    def save(self, *args, **kwargs):
        trees.append(self)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(j_n3tree.N3Tree, "save", save)
    return trees


@pytest.mark.parametrize("source", ["container", "jax_ckpt"])
def test_create_octree_matches_jax(mixture_scene, tmp_path, captured_jax_tree, monkeypatch,
                                   capsys, source):
    ds, container, _ = mixture_scene
    if source == "container":
        model = ["--container_path", str(container)]
    else:
        from mega_nerf_tpu.parallel.train_step import make_optimizer, make_train_state
        from mega_nerf_tpu.runtime import checkpoints as j_ckpt
        from mega_nerf_tpu.models import make_bg_nerf, make_nerf

        j_hp = j_bake_hparams(ds, [], tmp_path / "unused.npz")
        state = make_train_state(make_nerf(j_hp, 4), make_bg_nerf(j_hp, 4),
                                 make_optimizer(1e-3, 0.1, 10), jax.random.PRNGKey(5))
        j_ckpt.save_checkpoint(tmp_path / "10.ckpt", state, {"iteration": 10})
        model = ["--ckpt_path", str(tmp_path / "10.ckpt")]
    j_create_octree.main(j_bake_hparams(ds, model, tmp_path / "jax.npz"))
    times = {}
    tree = create_octree.main(create_octree._get_extraction_opts(
        bake_args(ds, model, tmp_path / "port.npz")), times)
    want = captured_jax_tree[-1]
    assert tree.n_internal == want.n_internal > 1
    np.testing.assert_array_equal(tree.child, want.child)
    np.testing.assert_array_equal(tree.parent_depth, want.parent_depth)
    np.testing.assert_allclose(tree.data, want.data, rtol=0, atol=1e-4)
    data = tree.get_leaf_data(tree.leaf_indices())
    assert np.isfinite(data).all() and data[:, 3].max() > 0
    assert set(times) == {"scale", "step1", "grid_weight", "step2", "total"}

    summaries = []
    for name, run in (("jax", lambda: j_render_octree.main()),
                      ("port", lambda: render_octree.main(render_octree.get_render_octree_opts(
                          sys.argv[1:])))):
        capsys.readouterr()
        monkeypatch.setattr(sys, "argv", ["render_octree", "--tree", str(tmp_path / f"{name}.npz"),
                                          "--dataset_path", str(ds), "--steps", "32"]
                            + (["--device", "cpu"] if name == "port" else []))
        run()
        summaries.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert summaries[0]["views"] == summaries[1]["views"] == 1
    assert abs(summaries[0]["mean_psnr"] - summaries[1]["mean_psnr"]) <= 0.01
