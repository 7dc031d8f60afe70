"""The wide training route (`fused_train_wide.py` around `csrc/train_wide.cu`
and the wide eval route's layer GEMM), checked without a GPU. All inputs
come from numpy seeds or the JAX package's seeded Flax params, carried
over by `state_from_flax_params`.

- the plain wide route (through autograd) against the JAX package's
  `pallas_train.fused_nerf_train_apply` in interpret mode and against the
  port's eager module, widths 576 and 640, 3 layers with a skip, fg and
  bg, with and without dirs and appearance, sigma noise on: values rtol
  1e-5, gradients (every weight and, through the appearance table, d_app)
  atol 2e-4 (`test_fused_train_plain_matches_pallas`' limits);
- the plan: every packed gradient element written by exactly one dW job,
  the dX jobs' column ranges, every gradient tensor freed after its last
  reader;
- `render_rays(train=True)` at width 640 in bf16 through the gate and the
  wide route (the logged route names it) against the JAX renderer's
  fused-Pallas training path in interpret mode;
- two Adam steps at width 576 against the JAX `make_train_step`.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.parallel.train_step import make_optimizer as j_make_optimizer
from mega_nerf_tpu.parallel.train_step import make_train_state as j_make_state
from mega_nerf_tpu.parallel.train_step import make_train_step as j_make_step
from mega_nerf_tpu.render import RenderSettings as JSettings
from mega_nerf_tpu.render import render_rays as j_render_rays
from mega_nerf_tpu.render.pallas_train import fused_nerf_train_apply as j_train_apply
from mega_nerf_tpu_torch.models import (
    NeRF,
    NeRFConfig,
    flax_params_from_state,
    nerf_config_from_hparams,
    state_from_flax_params,
)
from mega_nerf_tpu_torch.parallel.train_step import TrainStep
from mega_nerf_tpu_torch.render import fused_mlp, fused_train, rendering
from mega_nerf_tpu_torch.render import fused_train_wide as ftw
from mega_nerf_tpu_torch.render.fused_wide import segment_columns
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays
from tests.test_models import tiny_hparams
from tests.test_torch_train_loop import (
    CENTER,
    RADIUS,
    _bundles,
    _grads,
    _rays,
    _torch_moments,
)


def _setup(width, kw, bg, count=6, n=192, seed=0):
    hp = tiny_hparams(layer_dim=width, bg_layer_dim=width, skip_layers=[2], **kw)
    jb = (j_make_bg_nerf if bg else j_make_nerf)(hp, count)
    params = jax.device_get(jb.init(jax.random.key(seed)))
    cfg = nerf_config_from_hparams(hp, count, width, 4 if bg else 3)
    module = NeRF(cfg)
    module.load_state_dict(state_from_flax_params(cfg, params))
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, cfg.xyz_dim)).astype(np.float32)
    dirs = rng.normal(size=(n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    idx = rng.integers(0, count, n).astype(np.int32)
    noise = rng.uniform(size=n).astype(np.float32)
    probe = rng.normal(size=(n, 4)).astype(np.float32)
    return jb, params, module, cfg, xyz, dirs, idx, noise, probe


def _port_grads(module, cfg, xyz, dirs, idx, noise, probe, wide):
    module.zero_grad(set_to_none=True)
    use_dirs, use_app = cfg.pos_dir_dim > 0, cfg.appearance_dim > 0
    x = torch.from_numpy(xyz)
    d = torch.from_numpy(dirs) if use_dirs else None
    nz = torch.from_numpy(noise)
    i = torch.from_numpy(idx).long()
    if wide:
        app = module.appearance(i).float() if use_app else None
        out = fused_train.fused_nerf_train_apply(module, x, d, app, nz)
    else:
        out = module(x, d, i if use_app else None, nz)
    loss = (out * torch.from_numpy(probe)).sum()
    loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in module.named_parameters()}
    return loss.item(), flax_params_from_state(cfg, grads)


VARIANTS = {
    "dirs_app": {"pos_dir_dim": 2, "appearance_dim": 8},
    "no_app": {"pos_dir_dim": 2, "appearance_dim": 0},
    "no_dirs_app": {"pos_dir_dim": 0, "appearance_dim": 5},
    "no_dirs_no_app": {"pos_dir_dim": 0, "appearance_dim": 0},
}


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("width,variant", [(576, "dirs_app"), (576, "no_dirs_app"),
                                           (640, "no_app"), (640, "no_dirs_no_app")])
def test_wide_train_plain_matches_pallas_and_eager(width, variant, bg):
    """Three routes on the same Flax weights and numpy inputs (f32 compute,
    192 points, sigma noise): the JAX Pallas training kernel in interpret
    mode, the port's wide route on CPU tensors (its plain versions, each
    called once per pass) and the port's eager module."""
    jb, params, module, cfg, xyz, dirs, idx, noise, probe = _setup(
        width, VARIANTS[variant], bg)
    use_dirs, use_app = cfg.pos_dir_dim > 0, cfg.appearance_dim > 0
    jcfg = jb.config

    def j_loss(p):
        app = None
        if use_app:
            table = jnp.asarray(p["appearance"]["embedding"])
            one_hot = jax.nn.one_hot(jnp.asarray(idx), table.shape[0], dtype=jcfg.dtype)
            app = jnp.dot(one_hot, table.astype(jcfg.dtype),
                          preferred_element_type=jnp.float32)
        out = j_train_apply(
            jcfg, p, jnp.asarray(xyz), jnp.asarray(dirs) if use_dirs else None,
            app, jnp.asarray(noise)[:, None], block=64, interpret=True, dir_pack=False)
        return jnp.sum(out * probe)

    want_v, want_g = jax.value_and_grad(j_loss)(params)
    plains = (ftw.train_wide_heads_fwd_plain, ftw.train_wide_heads_bwd_plain,
              ftw.train_wide_dx_plain, ftw.train_wide_dw_plain)
    calls = [f.calls for f in plains]
    launches = ftw.wide_train_kernel_launches()
    got_v, got_g = _port_grads(module, cfg, xyz, dirs, idx, noise, probe, True)
    plan = ftw.train_wide_plan(cfg)
    n_dx = sum(kind == "dx" for kind, _ in plan.steps)
    assert [f.calls - c for f, c in zip(plains, calls)] == [1, 1, n_dx,
                                                           len(plan.steps) - n_dx]
    assert ftw.wide_train_kernel_launches() == launches
    eager_v, eager_g = _port_grads(module, cfg, xyz, dirs, idx, noise, probe, False)
    np.testing.assert_allclose(got_v, float(want_v), rtol=1e-5)
    np.testing.assert_allclose(got_v, eager_v, rtol=1e-5)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want_g))
    flat_e = dict(jax.tree_util.tree_leaves_with_path(eager_g))
    got = jax.tree_util.tree_leaves_with_path(got_g)
    assert len(got) == len(flat_w)
    for path, leaf in got:
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(leaf, np.asarray(flat_w[path]), atol=2e-4,
                                   err_msg=f"vs pallas {name}")
        np.testing.assert_allclose(leaf, flat_e[path], atol=2e-4,
                                   err_msg=f"vs eager {name}")


def _config(width, xyz_dim, pos_dir_dim, appearance_dim, layers=8, skip=(4,)):
    return NeRFConfig(pos_xyz_dim=12 if xyz_dim == 3 else 10, pos_dir_dim=pos_dir_dim,
                      layers=layers, skip_layers=skip, layer_dim=width,
                      appearance_dim=appearance_dim, xyz_dim=xyz_dim,
                      compute_dtype="bfloat16")


@pytest.mark.parametrize("pos_dir_dim,appearance_dim", [(4, 48), (4, 0), (0, 48),
                                                        (0, 0), (4, 5)])
@pytest.mark.parametrize("xyz_dim", [3, 4])
@pytest.mark.parametrize("width", [576, 640, 1024])
def test_wide_train_plan_covers_every_gradient_once(width, xyz_dim, pos_dir_dim,
                                                    appearance_dim):
    """The dW jobs write each element of the flat gradient buffer (the
    `packed_shapes` layout) exactly once: the kernel allocates it
    uninitialised. The dX jobs: every trunk layer but the first hands its
    gradient down through the h columns of its matrix (after the encoding
    at a skip layer), masked by the layer below's saved output; with the
    branch dir_a gives d_final (its first D columns) and d_app (its
    appearance columns, f32), and trunk_final the last layer's d_pre with
    the sigma term. Every gradient tensor is produced before it is read and
    freed after its last reader; every saved tensor is as wide as its A
    segment of the packed matrices."""
    cfg = _config(width, xyz_dim, pos_dir_dim, appearance_dim)
    assert fused_mlp.supports_fused_kernel(cfg, train=True)[0]
    assert fused_mlp.is_wide(cfg)
    module = NeRF(cfg)
    packed = fused_mlp.pack_params(module)
    plan = ftw.check_plan(packed)
    d, n_layers = width, cfg.layers
    ep, dp, ap = packed.ep, packed.dp, packed.ap

    count = np.zeros(plan.total, np.int64)
    for kind, jobs in plan.steps:
        if kind != "dw":
            continue
        assert len(jobs) <= ftw.DW_MAX_JOBS
        assert len(ftw.dw_tiles(jobs)) <= ftw.DW_MAX_TILES
        for j in jobs:
            assert j.d_col % 8 == 0
            rows = j.out_off + np.arange(j.n)[:, None] * j.out_stride
            count[(rows + np.arange(j.k)[None]).ravel()] += 1
            if j.bias_off >= 0:
                count[j.bias_off:j.bias_off + j.n] += 1
    assert (count == 1).all()
    assert plan.total == fused_train._offsets(fused_train.packed_shapes(packed))[-1]

    dx = [job for kind, job in plan.steps if kind == "dx"]
    want = [ftw.DxJob(f"g_pre{i}", i, ep if i in cfg.skip_layers else 0, d,
                      ftw.DX_MASK, f"g_pre{i - 1}", f"h{i - 1}")
            for i in reversed(range(1, n_layers))]
    if packed.has_branch:
        a = n_layers + 1
        head = [ftw.DxJob("g_a", a, 0, d, ftw.DX_NONE, "g_final", None),
                ftw.DxJob("g_final", n_layers, 0, d, ftw.DX_MASK_SIGMA,
                          f"g_pre{n_layers - 1}", f"h{n_layers - 1}")]
        if appearance_dim:
            head.insert(0, ftw.DxJob("g_a", a, d + dp, appearance_dim, ftw.DX_F32,
                                     "d_app", None))
        want = head + want
        assert plan.first == "g_a"
        # The transposed dir_a matrix's rows are its packed columns.
        assert packed.mats[a].shape[1] == d + dp + ap
    else:
        assert plan.first == f"g_pre{n_layers - 1}"
    assert dx == want

    live = {"g_heads", plan.first}
    for (kind, job), frees in zip(plan.steps, plan.frees):
        reads = ([job.g] + (["g_heads"] if job.mode == ftw.DX_MASK_SIGMA else [])
                 if kind == "dx" else [j.d for j in job])
        assert set(reads) <= live
        if kind == "dx" and job.out != "d_app":
            live.add(job.out)
        live -= set(frees)
    assert not live

    widths = dict(plan.saved)
    for i, (name, _, pieces) in enumerate(fused_mlp.mat_layout(cfg)):
        cols = [dst for _, dst, _ in pieces]
        if i == 0:
            segs = ["enc"]
        elif i in cfg.skip_layers:
            segs = ["enc", f"h{i - 1}"]
        elif i < n_layers:
            segs = [f"h{i - 1}"]
        elif i == n_layers:
            segs = [f"h{n_layers - 1}"]
        else:
            segs = ["final"] + (["dir"] if dp else []) + (["app"] if ap else [])
        assert segment_columns([widths[s] for s in segs]) == cols, name
        assert sum(widths[s] for s in segs) == packed.mats[i].shape[1], name


@pytest.mark.parametrize("m,tiles", [(1, 1), (4097, 40), (524_288, 32), (524_288, 6),
                                     (20_011, 24)])
def test_dw_splits_cover_the_points_in_order(m, tiles):
    """A dW launch's split of its points (the persistent walk, `dw_walk`),
    its `tiles` walked as as many items: on the card's 132 CTAs, whole
    clusters, no more workers than stages, each item's 64-point stages
    covered once and in order by units of whole stages, the last ending at
    m, every worker's share within one stage of the mean."""
    stages = -(-m // ftw.DW_STAGE)
    assert (stages - 1) * ftw.DW_STAGE < m <= stages * ftw.DW_STAGE
    grid = ftw.dw_grid(tiles, stages, 132)
    workers = grid // ftw.DW_CLUSTER
    assert grid % ftw.DW_CLUSTER == 0
    assert 1 <= workers <= min(132 // ftw.DW_CLUSTER, tiles * stages)
    walk = ftw.dw_walk(tiles, stages, workers)
    spans = {}
    for c in range(workers):
        units = ftw.dw_units(walk, c)
        assert sum(s1 - s0 for _, s0, s1, _ in units) == walk.share(c)
        for p, s0, s1, _ in units:
            spans.setdefault(p, []).append((s0, s1))
    assert sorted(spans) == list(range(tiles))
    for p, got in spans.items():
        got.sort()
        assert got[0][0] == 0 and got[-1][1] == stages
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    shares = [walk.share(c) for c in range(workers)]
    assert max(shares) - min(shares) <= 1


def test_dw_plan_matches_the_dw_kernel_constants():
    """`train_wide.cu`'s dW constants are the wrapper's: the tile, the
    64-point stage, the ring, the partial's layout, the limits, the share
    modes, the cluster and the shared memory (ring, barriers, the worker's
    units, the fixup's slot list), within a CTA's 227 KB."""
    from tests.test_torch_eval_wide import cu_constants

    c = cu_constants("train_wide")
    assert (c["DW_TN"], c["DW_TK"], c["SP"], c["DW_STAGES"], c["DW_TILE_ELEMS"]) == (
        ftw.DW_TILE_N, ftw.DW_TILE_K, ftw.DW_STAGE, ftw.DW_STAGES, ftw.DW_TILE_ELEMS)
    assert c["DW_STAGE_BYTES"] == 2 * ftw.DW_STAGE * (ftw.DW_TILE_N + ftw.DW_TILE_K)
    assert (c["DW_MAX_JOBS"], c["DW_MAX_MAPS"], c["DW_MAX_TILES"], c["DW_MAX_WORKERS"],
            c["DW_MAX_UNITS"]) == (ftw.DW_MAX_JOBS, ftw.DW_MAX_MAPS, ftw.DW_MAX_TILES,
                                   ftw.DW_MAX_WORKERS, ftw.DW_MAX_UNITS)
    assert (c["SHARE_NONE"], c["SHARE_X"], c["SHARE_A"]) == (
        ftw.DW_SHARE_NONE, ftw.DW_SHARE_X, ftw.DW_SHARE_A)
    assert c["DW_SMEM_BYTES"] == ftw.DW_SMEM_BYTES <= 232_448
    assert c["DW_CLUSTER"] == ftw.DW_CLUSTER == 2


# The point counts of a 1024-ray step's passes (fg fine, fg coarse and bg
# fine, bg coarse) and two ragged ones.
DW_POINTS = (1024 * 512, 1024 * 256, 1024 * 128, 100_003, 37)


@pytest.mark.parametrize("workers", [132, 66, 7, 1])
@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("width,pos_dir_dim,appearance_dim", [
    (1024, 4, 48), (1024, 0, 0), (640, 4, 48), (640, 0, 0)])
def test_dw_walk_covers_every_tile_stage_once(width, pos_dir_dim, appearance_dim, bg,
                                              workers):
    """Every dW launch of the plans at 640 and 1024 (fg and bg, with and
    without the branch), as the kernel walks it (`dw_items`, `dw_units`):
    every job's k is a multiple of 4 (the kernel's sums store four
    columns at a time); the items pair the tiles into whole clusters (each
    tile in one item, at most one lone tile; a shared item's two tiles
    read the same boxes of what they share); at each of a step's pass
    sizes and at ragged M, on `workers` clusters, every (item, 64-point
    stage) is walked exactly once, every worker's share is within one
    stage of the mean, the partial slots are distinct and within the
    scratch, and each item's fixup sums its slots in the order of their
    points."""
    cfg = _config(width, 4 if bg else 3, pos_dir_dim, appearance_dim)
    plan = ftw.train_wide_plan(cfg)
    for kind, jobs in plan.steps:
        if kind != "dw":
            continue
        assert all(j.k % 4 == 0 for j in jobs)
        tiles = ftw.dw_tiles(jobs)
        items = ftw.dw_items(jobs)
        used = [t for a, b, _ in items for t in (a, b) if t >= 0]
        assert sorted(used) == list(range(len(tiles)))
        assert sum(b < 0 for _, b, _ in items) == len(tiles) % 2
        for a, b, share in items:
            if b < 0:
                assert share == ftw.DW_SHARE_NONE
            elif share == ftw.DW_SHARE_X:  # one k-tile, neighbouring n-tiles
                assert tiles[a][0::2] == tiles[b][0::2]
                assert tiles[b][1] - tiles[a][1] == ftw.DW_TILE_N
            elif share == ftw.DW_SHARE_A:  # one n-tile, neighbouring k-tiles
                assert tiles[a][:2] == tiles[b][:2]
                assert tiles[b][2] - tiles[a][2] == ftw.DW_TILE_K
        for m in DW_POINTS:
            stages = -(-m // ftw.DW_STAGE)
            walk = ftw.dw_walk(len(items), stages, workers)
            seen = np.zeros((len(items), stages), np.int32)
            by_item = {}
            mean = len(items) * stages / workers
            for c in range(workers):
                units = ftw.dw_units(walk, c)
                assert len(units) <= ftw.DW_MAX_UNITS
                assert abs(sum(s1 - s0 for _, s0, s1, _ in units) - mean) < 1
                for p, s0, s1, slot in units:
                    seen[p, s0:s1] += 1
                    by_item.setdefault(p, []).append((s0, slot))
            assert (seen == 1).all()
            slots = [slot for units in by_item.values() for _, slot in units]
            assert len(set(slots)) == len(slots)
            assert max(slots) < workers + len(items)  # the wrapper's scratch
            for p, units in by_item.items():
                assert ftw.dw_fixup_order(walk, p) == [slot for _, slot in sorted(units)]


def test_dx_plan_matches_the_dx_kernel_constants():
    """`train_wide_dx` passes the wide GEMM plan, and `train_wide.cu`'s dX
    constants are that plan: the same tile, 3-stage ring, output tile (the
    mask tile's buffer too) and shared memory as `eval_wide.cu`, within a
    CTA's 227 KB; the epilogue modes are the wrapper's."""
    from mega_nerf_tpu_torch.render import fused_wide
    from tests.test_torch_eval_wide import cu_constants

    c = cu_constants("train_wide")
    assert fused_wide.wide_plan_ints() == [c["TILE_M"], c["TILE_N"], c["TILE_K"],
                                           c["STAGES"], c["OUT_BYTES"],
                                           c["DX_SMEM_BYTES"]]
    assert c["DX_SMEM_BYTES"] == cu_constants("eval_wide")["SMEM_BYTES"] <= 232_448
    assert c["SIGMA_ROWS"] + 4 * 64 <= c["PARAM_BYTES"]  # w_sigma pairs, g_sigma words
    assert c["SIGMA_ROWS"] == 2 * 256
    assert (c["MODE_F32"], c["MODE_NONE"], c["MODE_MASK"], c["MODE_MASK_SIGMA"]) == (
        ftw.DX_F32, ftw.DX_NONE, ftw.DX_MASK, ftw.DX_MASK_SIGMA)
    assert c["HEADS_ROW"] == ftw.HEADS_GRAD_WIDTH
    src = (Path(ftw.__file__).parent / "csrc" / "train_wide.cu").read_text()
    assert fused_wide.DX_CLUSTER == 1 and "__cluster_dims__" not in src


@pytest.mark.parametrize("width,appearance_dim", [(576, 48), (640, 5), (1024, 48)])
def test_dx_jobs_walk_every_tile_once(width, appearance_dim):
    """Each dX job of a plan, on a step's ragged pass size, is walked by the
    persistent kernel (no clusters) tile by tile exactly once at the card's
    132 CTAs and at 7 and 1: every bf16 output is a multiple of 8 columns
    wide (its rows leave by TMA), d_app's f32 columns any width."""
    from mega_nerf_tpu_torch.render import fused_wide

    cfg = _config(width, 3, 4, appearance_dim)
    plan = ftw.check_plan(fused_mlp.pack_params(NeRF(cfg)))
    m = 100_003
    for kind, job in plan.steps:
        if kind != "dx":
            continue
        assert job.mode == ftw.DX_F32 or job.k % 8 == 0
        for grid in (132, 7, 1):
            walk = fused_wide.tile_walk(m, job.k, grid, fused_wide.DX_CLUSTER)
            tiles = [t for cta in walk for t in cta]
            assert len(tiles) == len(set(tiles)) == -(-m // 128) * -(-job.k // 256)


def test_render_rays_train_through_the_wide_route_matches_jax(capsys, monkeypatch):
    """`render_rays(train=True)` with 640-wide fg and bg models in bf16 (the
    wide route's domain, through the real gate) against the JAX renderer's
    fused-Pallas training path (interpret mode) on the same Flax weights and
    rays, no jitter or noise. The route line names the wide kernel's plain
    version. Tolerances: loss rtol 1e-4 and every gradient a relative norm
    1e-2 (measured 1.2e-6 and 2.1e-3): both compute in bf16 with f32 sums
    taken in another order, which can flip one bf16 rounding of an
    activation."""
    monkeypatch.setattr(rendering, "_LOGGED_MLP_PATHS", set())
    hp = tiny_hparams(layer_dim=640, bg_layer_dim=640, skip_layers=[2],
                      appearance_dim=4, compute_dtype="bfloat16")
    (jfg, pfg, tfg), (jbg, pbg, tbg) = _bundles(hp, 5)
    rays = _rays(24, seed=3)
    idx = np.arange(24, dtype=np.int32) % 5
    target = np.random.default_rng(4).uniform(size=(24, 3)).astype(np.float32)
    jset = JSettings(coarse_samples=16, fine_samples=16, use_pallas=True,
                     perturb=0.0, sigma_noise=False)

    def j_loss(fp, bp):
        res, _ = j_render_rays(jfg, jbg, fp, bp, jnp.asarray(rays), jnp.asarray(idx),
                               jset, jnp.asarray(CENTER), jnp.asarray(RADIUS),
                               train=True, key=None)
        return jnp.mean((res["rgb_fine"] - target) ** 2)

    want_v, (gf, gb) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(pfg, pbg)
    capsys.readouterr()
    tset = RenderSettings(coarse_samples=16, fine_samples=16, perturb=0.0,
                          sigma_noise=False)
    calls = ftw.fused_nerf_train_wide_fwd_plain.calls
    launches = ftw.wide_train_kernel_launches()
    res, _ = render_rays(tfg, tbg, torch.from_numpy(rays), torch.from_numpy(idx).long(),
                         tset, torch.from_numpy(CENTER), torch.from_numpy(RADIUS),
                         train=True)
    loss = torch.mean((res["rgb_fine"] - torch.from_numpy(target)) ** 2)
    loss.backward()
    logged = capsys.readouterr().out
    assert logged.count("fused train (wide kernel's plain version)") == 4
    assert "eager" not in logged
    assert ftw.fused_nerf_train_wide_fwd_plain.calls == calls
    assert ftw.wide_train_kernel_launches() == launches
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-4)
    for side, bundle, want in (("fg", tfg, gf), ("bg", tbg, gb)):
        got = dict(jax.tree_util.tree_leaves_with_path(_grads(bundle.module,
                                                              bundle.config)))
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            w = np.asarray(leaf, np.float64)
            diff = np.linalg.norm(np.asarray(got[path], np.float64) - w)
            assert diff <= 1e-2 * max(np.linalg.norm(w), 1e-12), \
                f"{side} {jax.tree_util.keystr(path)}"


ADAM_NOISE_G = 1e-6  # 100 x Adam's eps: below it a gradient's float noise moves the update


def _leaves(tree):
    return {path: np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(jax.device_get(tree))}


def _load_jax_state(bundle, params, adam, opt):
    """JAX's parameters and Adam moments into the port's module and optimizer."""
    bundle.module.load_state_dict(state_from_flax_params(bundle.config,
                                                         jax.device_get(params)))
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        state = state_from_flax_params(bundle.config, jax.device_get(tree))
        for name, p in bundle.module.named_parameters():
            opt.state[p][key].copy_(state[name])


def test_two_train_steps_through_the_wide_route_match_jax():
    """Two `TrainStep`s at width 576 (f32 compute, no jitter or noise, lr
    1e-3) against the JAX `make_train_step` (XLA) from the same parameters
    and batches. The port's gate takes f32 at 576 through the wide route
    (the f32 wide kernels on the card), here its plain versions in f32.

    Adam divides each gradient element g by |g| + eps (1e-8), so where |g|
    is within a few hundred eps the float noise of two summation orders
    moves the update by up to ~lr. Those elements (0 < |g| < 1e-6 in both
    routes, g taken from the first moments; 9-14% of them here) are left out
    of the parameter check. Every other parameter moves by ~lr and agrees
    to 1e-5 (measured 3e-7), so a missing or sign-flipped update fails.
    The left-out updates differ, so step 2 starts from JAX's parameters and
    moments loaded into the port (its own step count and decayed lr). Loss
    atol 1e-5; first moments atol 1e-7 (measured 8e-9); second moments rtol
    2e-2 (measured 7e-3, at gradients near eps)."""
    assert rendering.mlp_route(nerf_config_from_hparams(
        tiny_hparams(layer_dim=576, compute_dtype="float32"), 5, 576, 3), "cuda", True)[0]
    hp = tiny_hparams(layer_dim=576, bg_layer_dim=576, skip_layers=[2],
                      appearance_dim=4, compute_dtype="float32")
    (jfg, _, tfg), (jbg, _, tbg) = _bundles(hp, 5)
    lr = 1e-3
    jset = JSettings(coarse_samples=16, fine_samples=16, use_pallas=False,
                     perturb=0.0, sigma_noise=False)
    opt = j_make_optimizer(lr, 0.1, 50)
    state = j_make_state(jfg, jbg, opt, jax.random.key(0))
    for b, p in ((tfg, state.fg_params), (tbg, state.bg_params)):
        b.module.load_state_dict(state_from_flax_params(b.config, jax.device_get(p)))
    j_step = jax.jit(j_make_step(jfg, jbg, jset, opt, jnp.asarray(CENTER),
                                 jnp.asarray(RADIUS)))
    tset = RenderSettings(coarse_samples=16, fine_samples=16, perturb=0.0,
                          sigma_noise=False)
    step = TrainStep(tfg, tbg, tset, lr, 0.1, 50, torch.from_numpy(CENTER),
                     torch.from_numpy(RADIUS))
    rng = np.random.default_rng(9)
    calls = ftw.fused_nerf_train_wide_fwd_plain.calls, ftw.train_wide_dw_plain.calls
    for i in range(2):
        sides = (("fg", tfg, step.fg_opt, lambda s: (s.fg_params, s.fg_opt[0])),
                 ("bg", tbg, step.bg_opt, lambda s: (s.bg_params, s.bg_opt[0])))
        before = {}
        for side, bundle, t_opt, of in sides:
            params, adam = of(state)
            before[side] = (_leaves(params), _leaves(adam.mu))
            if i:
                _load_jax_state(bundle, params, adam, t_opt)
        b = {"rays": _rays(16, seed=10 + i),
             "rgbs": rng.uniform(size=(16, 3)).astype(np.float32),
             "img_indices": (np.arange(16) % 5).astype(np.int32)}
        state, jm = j_step(state, {k: jnp.asarray(v) for k, v in b.items()})
        tm = step({"rays": torch.from_numpy(b["rays"]), "rgbs": torch.from_numpy(b["rgbs"]),
                   "img_indices": torch.from_numpy(b["img_indices"]).long()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5)
        for side, bundle, t_opt, of in sides:
            params, adam = of(state)
            want_p, want_mu, want_nu = _leaves(params), _leaves(adam.mu), _leaves(adam.nu)
            got_p = _leaves(flax_params_from_state(bundle.config, bundle.module.state_dict()))
            got_mu, got_nu = (_leaves(_torch_moments(t_opt, bundle.module, bundle.config, k))
                              for k in ("exp_avg", "exp_avg_sq"))
            p0, mu0 = before[side]
            held = total = moved = 0
            for path, w in want_p.items():
                name = f"step {i} {side} {jax.tree_util.keystr(path)}"
                g_j, g_p = ((mu[path] - 0.9 * mu0[path]) / 0.1 for mu in (want_mu, got_mu))
                noise = np.maximum(np.abs(g_j), np.abs(g_p)) < ADAM_NOISE_G
                keep = ~noise | ((g_j == 0) & (g_p == 0))
                held, total = held + keep.sum(), total + keep.size
                moved += (np.abs(w - p0[path])[keep] > 10 * 1e-5).sum()
                np.testing.assert_allclose(got_p[path][keep], w[keep], atol=1e-5,
                                           err_msg=f"{name} params")
                np.testing.assert_allclose(got_mu[path], want_mu[path], atol=1e-7,
                                           err_msg=f"{name} first moment")
                np.testing.assert_allclose(got_nu[path], want_nu[path], rtol=2e-2,
                                           atol=1e-14, err_msg=f"{name} second moment")
            # Most parameters are held, and most held ones moved by ten times
            # the tolerance: the check sees the update.
            assert held >= 0.75 * total and moved >= 0.5 * held, (side, i, held, moved)
    # Two steps of fg + bg, coarse and fine: 8 passes of the wide route.
    assert ftw.fused_nerf_train_wide_fwd_plain.calls == calls[0]
    assert ftw.train_wide_dw_plain.calls > calls[1]
