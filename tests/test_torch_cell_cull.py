"""The port's exact cell culling against the JAX package's, on the CPU.

- Every numpy function of `render/cell_cull.py` (`clamp_rays_to_fg`,
  `chunk_point_box`, `active_cells`, `active_cells_for_points`,
  `ray_support_masks`, `support_order`, `tile_order`, `_active_cells_box`,
  `_EDGE_SLACK`) equals the JAX package's on the same seeded inputs; the
  host fg clamp agrees with the port's device `intersect_sphere` and never
  ends before it.
- `mega_apply` over a chunk's active submodules equals the full blend bit
  for bit; `query_points` of a mixture (full and `sigma_only`, culled or
  not) matches the JAX `ModelBundle.apply` at 5e-5.
- `Runner.render_image` of a K = 4 mixture (two cells reachable, two far
  away) in several chunks: culled equals `--no_cell_cull` bit for bit in
  the port, and equals the JAX Runner's culled render (rgb 1e-4, depth
  rtol 5e-4), without bounds and with `--occupancy_path` in both modes;
  the decisions (tiles, support sets) are the JAX Runner's.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_nerf_tpu.models.container import ContainerData as JContainerData
from mega_nerf_tpu.models.container import container_to_bundles as j_to_bundles
from mega_nerf_tpu.models.container import load_container as j_load_container
from mega_nerf_tpu.models.container import save_native_container as j_save_native
from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.models.torch_interop import torch_state_from_flax_params
from mega_nerf_tpu.render import cell_cull as jcc
from mega_nerf_tpu.runtime.runner import Runner as JRunner
from mega_nerf_tpu_torch import eval as port_eval
from mega_nerf_tpu_torch.models.container import container_to_bundles, load_container
from mega_nerf_tpu_torch.models.mega import cluster_weights, mega_apply
from mega_nerf_tpu_torch.ops.geometry import intersect_sphere
from mega_nerf_tpu_torch.render import cell_cull as tcc
from mega_nerf_tpu_torch.render.rendering import RenderSettings, query_points
from mega_nerf_tpu_torch.runtime.runner import Runner as TRunner
from tests.synthetic import make_synthetic_dataset
from tests.test_torch_eval import _args, _j_hparams

# Two cells the synthetic cameras reach and two no sample box reaches.
CENTROIDS = np.array([[0, -0.7, 0], [0, 0.7, 0], [0, -50, 0], [0, 50, 0]], np.float32)
BAKE = ["--init_grid_depth", "4", "--samples_per_cell", "4", "--masking_mode", "weight",
        "--camera_params", "16", "16", "14", "14", "8", "8"]


def write_occupancy(path, res=16):
    """A packed occupancy grid over world [-4, 4]^3 occupied near the
    scene content (|p| < ~1.5): rays pointing away collapse, others
    tighten."""
    grid = np.zeros((res, res, res), bool)
    grid[5:11, 5:11, 5:11] = True
    np.savez_compressed(path, occupancy=np.packbits(grid.reshape(-1)), res=np.int64(res),
                        invradius3=np.full(3, 1.0 / 8.0, np.float32),
                        offset=np.full(3, 0.5, np.float32), sigma_thresh=np.float32(1.0))
    return path


@pytest.fixture(scope="module")
def mixture_scene(tmp_path_factory):
    """(dataset, a K = 4 container of JAX-initialised fg and bg submodules,
    an occupancy grid) on `tests/synthetic.py` data."""
    root = tmp_path_factory.mktemp("cull_scene")
    ds = make_synthetic_dataset(root / "ds", n_train=3, n_val=1, hw=(16, 16))
    hp = _j_hparams(_args(ds, root / "unused", True))

    def states(make, offset):
        jb = make(hp, 4)
        return [torch_state_from_flax_params(
            jb.config, jax.device_get(jb.init(jax.random.key(offset + i)))) for i in range(4)]

    data = JContainerData(
        centroids=CENTROIDS, grid_dim=(4, 1), min_position=CENTROIDS.min(0),
        max_position=CENTROIDS.max(0), need_viewdir=True, need_appearance_embedding=True,
        cluster_2d=False, fg_states=states(j_make_nerf, 0),
        bg_states=states(j_make_bg_nerf, 100))
    j_save_native(root / "merged.pt", data)
    return ds, root / "merged.pt", write_occupancy(root / "occupancy.npz")


def bake_args(ds, model, output):
    """The port's create_octree command line on the scene, at depth 4."""
    return (_args(ds, "unused", True) + list(model)
            + ["--output", str(output), "--device", "cpu"] + BAKE)


def j_bake_hparams(ds, model, output):
    """The JAX script's hparams for the same bake (its parser reads
    sys.argv, so the flags are added here)."""
    from mega_nerf_tpu.opts import get_opts_base, parse_opts

    parser = get_opts_base()
    for name in ("--exp_name", "--dataset_path", "--output", "--masking_mode"):
        parser.add_argument(name, type=str)
    for name, default in (("--alpha_thresh", 0.01), ("--scale_alpha_thresh", 0.01),
                          ("--weight_thresh", 0.001)):
        parser.add_argument(name, type=float, default=default)
    for name, default in (("--tree_branch_n", 2), ("--init_grid_depth", 8),
                          ("--samples_per_cell", 256), ("--embedding_index", 0)):
        parser.add_argument(name, type=int, default=default)
    parser.add_argument("--camera_params", type=int, nargs="+")
    return parse_opts(parser, _args(ds, "unused", True) + list(model)
                      + ["--output", str(output)] + BAKE)


def _rays(rng, n, origin_scale=2.0, collapsed=0):
    o = rng.uniform(-origin_scale, origin_scale, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = rng.uniform(0.1, 0.8, (n, 1))
    far = near + rng.uniform(0.5, 3.0, (n, 1))
    far[:collapsed] = near[:collapsed]
    return np.concatenate([o, d, near, far], axis=1).astype(np.float32)


def _grid_centroids(rng, k_side):
    ys, zs = np.meshgrid(np.linspace(-2, 2, k_side), np.linspace(-1.5, 1.5, 2), indexing="ij")
    c = np.stack([rng.uniform(-0.2, 0.2, ys.size), ys.reshape(-1), zs.reshape(-1)], 1)
    return c.astype(np.float32)


@pytest.mark.parametrize("margin,cds", [(1.0, 0), (1.15, 0), (1.15, 1), (2.0, 0)])
def test_cull_functions_match_jax(margin, cds):
    rng = np.random.default_rng(int(margin * 100) + cds)
    assert tcc._EDGE_SLACK == jcc._EDGE_SLACK
    centroids = _grid_centroids(rng, 4)
    for trial in range(4):
        rays = _rays(rng, 96, collapsed=8 * (trial % 2))
        c, r = rng.uniform(-0.3, 0.3, 3), rng.uniform(2.0, 3.0, 3)
        np.testing.assert_array_equal(tcc.clamp_rays_to_fg(rays, c, r),
                                      jcc.clamp_rays_to_fg(rays, c, r))
        np.testing.assert_array_equal(tcc.clamp_rays_to_fg(rays), jcc.clamp_rays_to_fg(rays))
        for got, want in zip(tcc.chunk_point_box(rays, cds), jcc.chunk_point_box(rays, cds)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tcc.active_cells(rays, centroids, margin, cds),
                                      jcc.active_cells(rays, centroids, margin, cds))
        pts = rays[:, :3] + rays[:, 3:6] * rays[:, 6:7]
        np.testing.assert_array_equal(
            tcc.active_cells_for_points(pts[:20], centroids, margin, cds),
            jcc.active_cells_for_points(pts[:20], centroids, margin, cds))
        lo, hi = pts.min(0)[cds:], pts.max(0)[cds:]
        np.testing.assert_array_equal(tcc._active_cells_box(lo, hi, centroids, margin, cds),
                                      jcc._active_cells_box(lo, hi, centroids, margin, cds))
        masks = tcc.ray_support_masks(rays, centroids, margin, cds, chunk=40)
        np.testing.assert_array_equal(
            masks, jcc.ray_support_masks(rays, centroids, margin, cds, chunk=40))
        np.testing.assert_array_equal(tcc.support_order(masks), jcc.support_order(masks))
    wide = rng.random((50, 70)) < 0.2  # K > 62: the lexsort branch
    np.testing.assert_array_equal(tcc.support_order(wide), jcc.support_order(wide))
    for w, h, chunk in ((20, 12, 70), (16, 16, 256), (33, 7, 16)):
        np.testing.assert_array_equal(tcc.tile_order(w, h, chunk), jcc.tile_order(w, h, chunk))


def test_clamp_rays_to_fg_matches_device_intersect():
    """The host clamp agrees with the port's `intersect_sphere` and never
    ends before it (the JAX package's test of its own clamp)."""
    rng = np.random.default_rng(11)
    c = np.array([0.4, -0.1, 0.05], np.float64)
    r = np.array([3.6, 2.7, 2.1], np.float64)
    o = c + rng.uniform(-0.5, 0.5, (64, 3)) * r
    d = rng.normal(size=(64, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((64, 1), 0.05), np.full((64, 1), 1e5)],
                          axis=1).astype(np.float32)
    clamped = tcc.clamp_rays_to_fg(rays, c, r)
    dev = intersect_sphere(torch.from_numpy(rays[:, :3]), torch.from_numpy(rays[:, 3:6]),
                           torch.tensor(c, dtype=torch.float32),
                           torch.tensor(r, dtype=torch.float32)).numpy()
    dev_end = np.minimum(rays[:, 7], np.maximum(dev, rays[:, 6]))
    assert (clamped[:, 7] >= dev_end).all()
    np.testing.assert_allclose(clamped[:, 7], dev_end, rtol=1e-4)
    np.testing.assert_array_equal(clamped[:, :7], rays[:, :7].astype(np.float64))


@pytest.mark.parametrize("margin", [1.0, 1.15])
def test_culled_mega_apply_is_bit_equal(margin):
    rng = np.random.default_rng(2)
    rays = _rays(rng, 48, origin_scale=1.0)
    mask = tcc.active_cells(rays, CENTROIDS, margin, 0)
    assert mask[:2].all() and not mask[2:].any()
    t = rng.uniform(0, 1, (48, 24, 1)).astype(np.float32)
    pts = torch.from_numpy((rays[:, None, :3] + (rays[:, None, 6:7] * (1 - t)
                            + rays[:, None, 7:8] * t) * rays[:, None, 3:6]).reshape(-1, 3))
    w = torch.from_numpy(rng.normal(size=(4, 3, 5)).astype(np.float32))
    calls = []

    def apply_fn(k):
        calls.append(k)
        return pts @ w[k]

    weights = cluster_weights(pts, torch.from_numpy(CENTROIDS), margin)
    full = mega_apply(apply_fn, weights)
    culled = mega_apply(apply_fn, weights, np.flatnonzero(mask).tolist())
    assert calls == [0, 1, 2, 3, 0, 1]
    assert torch.equal(culled, full)


@pytest.mark.parametrize("sigma_only", [False, True])
def test_query_points_matches_jax_apply(mixture_scene, sigma_only):
    ds, container, _ = mixture_scene
    hp = _j_hparams(_args(ds, "unused", True))
    jfg, _ = j_to_bundles(j_load_container(container), hp)
    tfg, _ = container_to_bundles(load_container(container), hp)
    rng = np.random.default_rng(6)
    xyz = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    xyz[:, 1] -= 0.5  # near the first cell: the others can be culled
    dirs = rng.normal(size=(300, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    idx = rng.integers(0, 4, 300)
    args = () if sigma_only else (dirs, idx.astype(np.int32))
    want = np.asarray(jfg.apply(jfg.pretrained_params, "fine", jnp.asarray(xyz),
                                *map(jnp.asarray, args), sigma_only=sigma_only))
    active = np.flatnonzero(tcc.active_cells_for_points(xyz, CENTROIDS, 1.15)).tolist()
    assert len(active) < 4
    settings = RenderSettings.from_hparams(hp)
    targs = () if sigma_only else (torch.from_numpy(dirs), torch.from_numpy(idx))
    with torch.no_grad():
        full = query_points(tfg, "fine", settings, torch.from_numpy(xyz), *targs,
                            sigma_only=sigma_only)
        culled = query_points(tfg, "fine", settings, torch.from_numpy(xyz), *targs,
                              active=active, sigma_only=sigma_only)
    assert full.shape == want.shape == ((300, 1) if sigma_only else (300, 4))
    assert torch.equal(culled, full)
    np.testing.assert_allclose(full.numpy(), want, rtol=0, atol=5e-5)


def _renders(ds, container, exp, extra):
    """(JAX render, port culled render, port unculled render, the port's
    view_stats when culled) of the val view."""
    args = _args(ds, exp, True) + ["--container_path", str(container),
                                   "--image_pixel_batch_size", "96"] + extra
    jr = JRunner(_j_hparams(args), set_experiment_path=False)
    want = jr.render_image(jr.val_items[0], jr.make_eval_state())
    hp = port_eval.get_eval_opts(args + ["--device", "cpu"])
    tr = TRunner(hp, set_experiment_path=False)
    tr.make_eval_state()
    culled = tr.render_image(tr.val_items[0])
    stats = tr.view_stats
    hp.cell_cull = False
    dense = tr.render_image(tr.val_items[0])
    assert not tr.view_stats["cull"]
    return want, culled, dense, stats


@pytest.mark.parametrize("occupancy", ["none", "near", "both"])
def test_render_image_culled_matches_dense_and_jax(mixture_scene, tmp_path, occupancy):
    ds, container, occ = mixture_scene
    extra = [] if occupancy == "none" else ["--occupancy_path", str(occ),
                                            "--occupancy_mode", occupancy]
    want, culled, dense, stats = _renders(ds, container, tmp_path, extra)
    assert stats["cull"] and stats["chunks"] == 3
    assert stats["bounded"] == (occupancy != "none")
    assert stats["support_sorted"] == (occupancy != "none")
    assert stats["tiled"] == (occupancy == "none")
    assert max(stats["active_per_chunk"]) <= 2
    assert culled.keys() == dense.keys()
    for key in culled:
        np.testing.assert_array_equal(culled[key], dense[key], err_msg=key)
    np.testing.assert_allclose(culled["rgb_fine"], want["rgb_fine"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(culled["depth_fine"], want["depth_fine"], rtol=5e-4)


def test_cull_gated_off_when_image_set_full(mixture_scene, tmp_path):
    """With every cell in the view's box and no bounds the culled path is
    skipped (the JAX gate); with bounds it engages again."""
    ds, container, occ = mixture_scene
    hp = port_eval.get_eval_opts(_args(ds, tmp_path, True) + [
        "--container_path", str(container), "--device", "cpu"])
    runner = TRunner(hp, set_experiment_path=False)
    runner.fg.centroids = torch.tensor([[0, -0.5, 0], [0, 0.5, 0]], dtype=torch.float32)
    del runner.fg.module[2:]
    runner.render_image(runner.val_items[0])
    assert not runner.view_stats["cull"]
    hp.occupancy_path, hp.occupancy_mode = str(occ), "both"
    runner.render_image(runner.val_items[0])
    assert runner.view_stats["bounded"]
