"""The port's routed Mega-NeRF mixtures against the JAX package's, on the CPU.

- `ray_route_capacity` and `ray_route_plan` (numpy in both packages):
  bit-equal on random, skewed, all-false, forced-capacity and padded
  supports at K = 25;
- `mega_apply_routed` (per point) against the JAX function on the same toy
  submodules (`tests/test_mega_routing.py`'s): margins 1 and 1.15, a
  truncation case (more nonzero weights than M), with and without dirs,
  appearance and sigma noise: 5e-5 (the blend sums in another order);
- `mega_apply_ray_routed` against the JAX function: full, superset and
  exact supports, `xyz_real` routing coordinates, and the JAX function
  over a `ray_route_plan`'s virtual experts (`cell_ids`) against the port
  over the per-cell supports the plan splits: 5e-5;
- eval `render_rays` of a K = 3 fg + bg mixture with per-ray fg supports
  (`fg_ray_support`, from `cell_cull.ray_support_masks`; the JAX renderer
  also over their `ray_route_plan`) against the JAX renderer: rgb 1e-4,
  depth rtol 5e-4;
  and the per-point routed mixture (`--mega_routing routed`) likewise;
- the routing gates: `use_routed`, `use_ray_routed` and
  `eval_submodule_cost` equal in both packages at K = 3 and 33 (`auto`
  routes past 32) for every `--mega_routing` and margin;
- `Runner.render_image` with `--mega_routing ray` and `routed` on a K = 25
  joint mixture against the JAX Runner (the gate forced open, as in
  `tests/test_mega_routing.py`): the same `use_ray` decision and plan cost,
  pixels 1e-4, depth rtol 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mega_nerf_tpu.models as j_models
from mega_nerf_tpu.models import cluster_weights as j_cluster_weights
from mega_nerf_tpu.models import mega_apply_ray_routed as j_ray_routed
from mega_nerf_tpu.models import mega_apply_routed as j_routed
from mega_nerf_tpu.models import ray_route_capacity as j_capacity
from mega_nerf_tpu.models import ray_route_plan as j_plan
from mega_nerf_tpu.models.factory import _make_bundle as j_make_bundle
from mega_nerf_tpu.render import RenderSettings as JSettings
from mega_nerf_tpu.render import render_rays as j_render_rays
from mega_nerf_tpu.render.cell_cull import clamp_rays_to_fg, ray_support_masks
from mega_nerf_tpu.runtime.runner import Runner as JRunner
from mega_nerf_tpu_torch.models import mega
from mega_nerf_tpu_torch.models.container import container_to_bundles
from mega_nerf_tpu_torch.models.factory import _make_bundle
from mega_nerf_tpu_torch.parallel.cell_parallel import mixture_states_from_flax
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays
from mega_nerf_tpu_torch.runtime.runner import Runner as TRunner
from tests.test_mega_routing import grid_centroids, toy_apply, toy_params
from tests.test_torch_mega import (
    CENTER,
    CENTROIDS,
    RADIUS,
    _rays,
    both_bundles,
    container_data,
    mixture_hparams,
)


# ----------------------------------------------------------------- the plan

def _supports():
    rng = np.random.default_rng(0)
    random = rng.random((200, 25)) < 0.3
    skewed = rng.random((200, 25)) < np.linspace(1.0, 0.0, 25)
    return {"random": random, "skewed": skewed, "all_false": np.zeros((64, 25), bool)}


@pytest.mark.parametrize("kw", [{}, {"bucket": False}, {"capacity": 16},
                                {"pad_experts_to": 64}, {"expert_cost": 1.0}])
@pytest.mark.parametrize("name", ["random", "skewed", "all_false"])
def test_ray_route_plan_and_capacity_bit_equal(name, kw):
    support = _supports()[name]
    if "pad_experts_to" in kw and name != "all_false":
        kw = {"pad_experts_to": len(j_plan(support)[1]) + 5}
    want, got = j_plan(support, **kw), mega.ray_route_plan(support, **kw)
    assert got[2] == want[2] and type(got[2]) is type(want[2])
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for bucket in (True, False):
        assert mega.ray_route_capacity(support, bucket) == j_capacity(support, bucket)


# ---------------------------------------------- the routed forms, toy models

def _toy_rows(params, xyz, dirs=None, idx=None, noise=None, real=False):
    """The port's apply_rows over `toy_apply`'s submodules (numpy params)."""
    w = torch.from_numpy(np.asarray(params["w"]))
    b = torch.from_numpy(np.asarray(params["b"]))
    x = xyz[:, 3:] if real else xyz

    def apply(k, rows, rays=None, samples=1):
        out = x[rows] @ w[k] + b[k]
        if dirs is not None:
            out = out + dirs[rows].sum(-1, keepdim=True)
        if idx is not None:
            ray = rows if rays is None else torch.div(rows, samples, rounding_mode="floor")
            out = out + 0.01 * idx[ray].float()[:, None]
        if noise is not None:
            out = out + noise[rows][:, None]
        return out

    return apply


@pytest.mark.parametrize("inputs", [False, True])
@pytest.mark.parametrize("case", ["margin1", "margin1.15", "truncated"])
def test_mega_apply_routed_matches_jax(case, inputs):
    k = 25
    centroids = grid_centroids(5, 5)
    params = toy_params(jax.random.key(7), k)
    rng = np.random.default_rng(1)
    n = 311
    pts = rng.uniform(-1.0, 9.0, size=(n, 3)).astype(np.float32)
    margin, cds, m = {"margin1": (1.0, 1, 1), "margin1.15": (1.15, 1, 4),
                      "truncated": (1.15, 0, 4)}[case]
    if case == "truncated":
        pts[:, 0] = 30.0  # far above the 2D grid: many cells within the margin
    dirs = rng.normal(size=(n, 3)).astype(np.float32) if inputs else None
    idx = rng.integers(0, 7, size=n).astype(np.int32) if inputs else None
    noise = rng.uniform(size=(n, 1)).astype(np.float32) if inputs else None
    w = j_cluster_weights(jnp.asarray(pts), centroids, margin, cds)
    if case == "truncated":
        assert int(jnp.max(jnp.sum(w > 0, axis=-1))) > m
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = np.asarray(j_routed(toy_apply, params, w, jnp.asarray(pts), opt(dirs), opt(idx),
                               opt(noise), max_experts=m, block=64, blocks_per_step=4))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    log = []
    got = mega.mega_apply_routed(
        _toy_rows(params, t(pts), t(dirs), t(idx), None if noise is None else t(noise[:, 0])),
        torch.from_numpy(np.asarray(w)), m, 4, log=log).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)
    # Each point is evaluated once per kept weight; a submodule without
    # points is not run.
    assert len(log) == 1 and len(log[0]) == k
    assert sum(log[0]) == int(np.minimum((np.asarray(w) > 0).sum(-1), m).sum())


def _ray_case(k_side, r, s, width, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.0, 2.0 * k_side - 1.0, size=(r, s, width)).astype(np.float32)
    dirs = rng.normal(size=(r, 3)).astype(np.float32)
    idx = rng.integers(0, 7, size=r).astype(np.int32)
    return xyz, dirs, idx


def _cell_support(support_v, cells, k):
    """The per-cell (R, K) support a `ray_route_plan` split into virtual
    experts: each cell's column holds the rays of all its replicas."""
    support = np.zeros((support_v.shape[0], k), bool)
    for col, cell in enumerate(np.asarray(cells)):
        support[:, cell] |= support_v[:, col]
    return support


def _ray_port(params, centroids, margin, cds, xyz, dirs, idx, support, real=False):
    r, s, width = xyz.shape
    flat = torch.from_numpy(xyz.reshape(r * s, width))
    d = None if dirs is None else torch.from_numpy(np.repeat(dirs, s, axis=0))
    i = None if idx is None else torch.from_numpy(idx)
    apply = _toy_rows(params, flat, d, i, real=real)
    weights = mega.cluster_weights(flat[:, :3], torch.from_numpy(np.asarray(centroids)),
                                   margin, cds)
    return mega.mega_apply_ray_routed(
        lambda k, rows, rays: apply(k, rows, rays, s), weights,
        mega.ray_route_experts(support), s, 4).reshape(r, s, 4).numpy()


@pytest.mark.parametrize("support_kind", ["exact", "superset", "full", "plan"])
@pytest.mark.parametrize("margin,cds", [(1.0, 0), (1.15, 1)])
def test_mega_apply_ray_routed_matches_jax(margin, cds, support_kind):
    k = 25
    centroids = grid_centroids(5, 5)
    params = toy_params(jax.random.key(20), k)
    r, s = 53, 7
    xyz, dirs, idx = _ray_case(5, r, s, 3, seed=2)
    w = np.asarray(j_cluster_weights(jnp.asarray(xyz.reshape(-1, 3)), centroids, margin, cds))
    support = (w > 0).reshape(r, s, k).any(1)
    j_support, cells = support, None
    if support_kind == "superset":
        support[:, 0] = True
    elif support_kind == "full":
        support = j_support = np.ones((r, k), bool)
    elif support_kind == "plan":
        support[:, 0] = True  # a hot cell, split into replicas by the plan
        j_support, cells, _ = j_plan(support)
        assert (cells == 0).sum() > 1
        np.testing.assert_array_equal(_cell_support(j_support, cells, k), support)
    want = np.asarray(j_ray_routed(
        toy_apply, params, centroids, margin, cds, jnp.asarray(xyz), jnp.asarray(dirs),
        jnp.asarray(idx), jnp.asarray(j_support), j_capacity(j_support),
        cell_ids=None if cells is None else jnp.asarray(cells)))
    got = _ray_port(params, centroids, margin, cds, xyz, dirs, idx, support)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_mega_apply_ray_routed_xyz_real_matches_jax():
    """Background-style input, [routing xyz | 4-d model input]: routing on
    the real coordinates, the model on the tail; no dirs or appearance."""
    k = 4
    centroids = grid_centroids(2, 2)
    params = toy_params(jax.random.key(24), k, d=4)
    r, s = 11, 3
    xyz, _, _ = _ray_case(2, r, s, 7, seed=3)
    w = np.asarray(j_cluster_weights(jnp.asarray(xyz.reshape(-1, 7)[:, :3]), centroids,
                                     1.15, 1))
    support = (w > 0).reshape(r, s, k).any(1)
    want = np.asarray(j_ray_routed(
        toy_apply, params, centroids, 1.15, 1, jnp.asarray(xyz), None, None,
        jnp.asarray(support), j_capacity(support), xyz_real=True))
    got = _ray_port(params, centroids, 1.15, 1, xyz, None, None, support, real=True)
    np.testing.assert_allclose(got, want, atol=5e-5)


# ------------------------------------------------ real mixtures, rendering

def _render_pair(hp, rays, fg_support=None, fg_cells=None, mlp="fused"):
    """The port and the JAX renderer on the same rays. With `fg_cells`,
    `fg_support` is a `ray_route_plan`'s virtual experts for the JAX
    renderer, and the port gets the per-cell supports they split."""
    (jfg, jbg), (tfg, tbg) = both_bundles(hp)
    n = rays.shape[0]
    idx = np.arange(n, dtype=np.int32) % 5
    jset = JSettings(coarse_samples=16, fine_samples=24, use_pallas=False,
                     eval_compositor="merge", get_depth=True, get_bg_fg_rgb=True)
    kw = {}
    if fg_support is not None:
        kw = dict(fg_ray_support=jnp.asarray(fg_support),
                  fg_ray_cells=None if fg_cells is None else jnp.asarray(fg_cells))
    capacity = None if fg_support is None else j_capacity(fg_support)
    as_jax = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    # One compiled program, as the JAX Runner renders, in place of hundreds
    # of op-by-op compiles.
    render = jax.jit(lambda fp, bp, r, i, **k: j_render_rays(
        jfg, jbg, fp, bp, r, i, jset, jnp.asarray(CENTER), jnp.asarray(RADIUS),
        train=False, fg_ray_capacity=capacity, **k))
    want, _ = render(as_jax(jfg.pretrained_params), as_jax(jbg.pretrained_params),
                     jnp.asarray(rays), jnp.asarray(idx), **kw)
    tset = RenderSettings(coarse_samples=16, fine_samples=24, get_depth=True,
                          get_bg_fg_rgb=True, use_fused_kernel=(mlp == "fused"))
    tfg.route_log = []
    with torch.no_grad():
        got, _ = render_rays(tfg, tbg, torch.from_numpy(rays), torch.from_numpy(idx).long(),
                             tset, torch.from_numpy(CENTER), torch.from_numpy(RADIUS),
                             fg_ray_support=fg_support if fg_cells is None else
                             _cell_support(fg_support, fg_cells, len(tfg.module)))
    assert set(got) == set(want)
    for key in ("rgb_fine", "fg_rgb_fine", "bg_rgb_fine"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                   err_msg=key)
    for key in ("depth_fine", "fg_depth_fine"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=5e-4,
                                   atol=1e-5, err_msg=key)
    return got, tfg.route_log


@pytest.mark.parametrize("plan", [False, True])
@pytest.mark.parametrize("margin", [1.0, 1.15])
def test_render_rays_fg_ray_support_matches_jax(margin, plan):
    hp = mixture_hparams(margin, mega_routing="ray")
    rays = _rays(40, seed=3)
    # Supports over each ray's fg segment, which ends at the ellipsoid.
    clamped = clamp_rays_to_fg(rays, CENTER.astype(np.float64), RADIUS.astype(np.float64))
    support = ray_support_masks(clamped, CENTROIDS, margin, 0)
    j_support, cells = support, None
    if plan:
        j_support, cells, _ = j_plan(support)
    _, log = _render_pair(hp, rays, j_support, cells)
    # The coarse and the fine fg pass each ran every supported cell once.
    assert len(log) == 2 and log[0] == log[1] == [int(c) for c in support.sum(0) if c]


@pytest.mark.parametrize("mlp", ["fused", "eager"])
@pytest.mark.parametrize("margin", [1.0, 1.15])
def test_render_rays_routed_mixture_matches_jax(margin, mlp):
    """`--mega_routing routed`: fg and bg mixtures routed per point (M = 1
    at margin 1, else 4 of K = 3: no truncation)."""
    hp = mixture_hparams(margin, mega_routing="routed")
    _, log = _render_pair(hp, _rays(40, seed=5), mlp=mlp)
    # fg coarse and fine: each point once per nonzero weight.
    assert len(log) == 2 and sum(log[0]) >= 40 * 16 and sum(log[1]) >= 40 * 24


@pytest.fixture(scope="module")
def three_states():
    return container_data(mixture_hparams(), k=3, bg=False).fg_states


@pytest.mark.parametrize("margin", [1.0, 1.15])
@pytest.mark.parametrize("routing", ["dense", "routed", "ray", "auto"])
@pytest.mark.parametrize("k", [3, 33])
def test_routing_gates_match_jax(three_states, k, routing, margin):
    """A joint mixture (both packages' factories) and a container of K
    submodules (the port's loader) route as the JAX bundle does."""
    hp = mixture_hparams(margin, mega_routing=routing)
    cents = np.resize(CENTROIDS, (k, 3)).astype(np.float32)
    data = container_data(hp, k=3, bg=False)
    data.centroids = cents
    data.fg_states = [three_states[i % 3] for i in range(k)]
    cb, _ = container_to_bundles(data, hp)
    hp._mega_centroid_metadata = {"centroids": cents, "cluster_2d": False}
    jb = j_make_bundle(hp, 5, 16, 3)
    tb = _make_bundle(hp, 5, 16, 3)
    for b in (tb, cb):
        b.boundary_margin = margin
    jb.boundary_margin = margin
    for b in (tb, cb):
        assert b.use_routed == jb.use_routed == (routing == "routed" or
                                                 (routing == "auto" and k > 32))
        assert b.use_ray_routed == jb.use_ray_routed == (routing == "ray")
        assert b.eval_submodule_cost == jb.eval_submodule_cost


# ------------------------------------------------------ the Runner's views

@pytest.fixture(scope="module")
def k25_scene(tmp_path_factory):
    """A 16x16 synthetic scene, a K = 25 joint mixture's centroids (the 5 x 5
    grid of `tests/test_mega_routing.py`) and JAX-initialised weights."""
    from mega_nerf_tpu.data.torch_io import save_pt
    from tests.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("k25")
    ds = make_synthetic_dataset(root / "ds", n_train=4, n_val=1, hw=(16, 16))
    g = np.linspace(-1.1, 1.1, 5)
    cents = np.array([[0.0, y, z] for y in g for z in g], np.float32)
    save_pt({"centroids": cents, "cluster_2d": False, "grid_dim": [5, 5],
             "min_position": np.full(3, -1.5, np.float32),
             "max_position": np.full(3, 1.5, np.float32)}, root / "params.pt")
    return ds, root / "params.pt"


def _k25_args(ds, params, exp, routing):
    return ["--dataset_path", str(ds), "--exp_name", str(exp), "--dataset_type", "memory",
            "--near", "0.5", "--far", "3.5", "--coarse_samples", "16", "--fine_samples", "16",
            "--pos_xyz_dim", "4", "--pos_dir_dim", "2", "--layers", "3", "--skip_layers", "1",
            "--layer_dim", "16", "--appearance_dim", "0", "--no_bg_nerf",
            "--compute_dtype", "float32", "--train_mega_nerf", str(params),
            "--mega_routing", routing, "--ray_routing_gate", "1.0", "--val_scale_factor", "1"]


@pytest.mark.parametrize("routing", ["ray", "routed"])
def test_runner_render_image_routed_matches_jax(k25_scene, tmp_path, monkeypatch, routing):
    from mega_nerf_tpu.opts import get_opts_base as j_opts
    from mega_nerf_tpu.opts import parse_opts as j_parse
    from mega_nerf_tpu_torch.eval import get_eval_opts

    ds, params = k25_scene
    args = _k25_args(ds, params, tmp_path / "exp", routing)
    parser = j_opts()
    parser.add_argument("--exp_name", type=str)
    parser.add_argument("--dataset_path", type=str)
    j_runner = JRunner(j_parse(parser, args), set_experiment_path=False)
    state = j_runner.make_eval_state()
    plans = []
    real_plan = j_models.ray_route_plan
    monkeypatch.setattr(j_models, "ray_route_plan",
                        lambda *a, **kw: plans.append(real_plan(*a, **kw)) or plans[-1])
    meta = j_runner.val_items[0]
    want = j_runner.render_image(meta, state)

    t_runner = TRunner(get_eval_opts(args + ["--device", "cpu"]), set_experiment_path=False)
    assert t_runner.fg.use_ray_routed == (routing == "ray")
    assert t_runner.fg.use_routed == (routing == "routed")
    for sub, sd in zip(t_runner.fg.module, mixture_states_from_flax(
            t_runner.fg.config, jax.device_get(state.fg_params), 25)):
        sub.load_state_dict(sd)
    got = t_runner.render_image(meta)
    stats = t_runner.view_stats
    if routing == "ray":
        # The image-level plan (the first) sets the JAX Runner's gate.
        _, cells, cap = plans[0]
        n = meta.W * meta.H
        assert stats["ray_routed"] and getattr(j_runner, "_eval_render_fn_ray_cache", None)
        assert stats["ray_eff"] == max(1, -(-len(cells) * int(cap) // n))
        assert not stats["cull"]
    else:
        assert not plans and not stats["ray_routed"] and stats["routed"] and not stats["cull"]
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["rgb_fine"], want["rgb_fine"], atol=1e-4)
    np.testing.assert_allclose(got["depth_fine"], want["depth_fine"], rtol=5e-4, atol=1e-5)


def test_ray_routing_gate_closes_like_jax(k25_scene, tmp_path, monkeypatch):
    """At the default gate (0.45) this view's plan costs more than 0.45 K in
    both packages: the port renders dense and unculled, as the JAX Runner."""
    from mega_nerf_tpu_torch.eval import get_eval_opts

    ds, params = k25_scene
    args = [a for a in _k25_args(ds, params, tmp_path / "exp", "ray")]
    gate = args.index("--ray_routing_gate")
    del args[gate:gate + 2]
    runner = TRunner(get_eval_opts(args + ["--device", "cpu"]), set_experiment_path=False)
    runner.render_image(runner.val_items[0])
    stats = runner.view_stats
    assert not stats["ray_routed"] and not stats["cull"]
    assert stats["ray_eff"] / 25 > 0.45
    assert stats["active_per_chunk"] == [25] * stats["chunks"]
