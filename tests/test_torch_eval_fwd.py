"""The eval kernel's host side (`fused_mlp.py` around `csrc/eval_fwd.cu`),
checked without a GPU: the persistent walk over point tiles, the plan
check of the packed weights, the kernel sources the build and
`chip_smoke.py` name, and the wrapper's CPU path against the JAX package's
Pallas eval kernel (interpret mode) on the same seeded inputs."""

import importlib.util
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.render.pallas_mlp import fused_nerf_eval as j_fused
from mega_nerf_tpu.render.pallas_mlp import pack_params as j_pack
from mega_nerf_tpu_torch.models import (
    NeRF,
    make_bg_nerf,
    make_nerf,
    nerf_config_from_hparams,
    state_from_flax_params,
)
from mega_nerf_tpu_torch.render import _build, fused_mlp

ROOT = Path(__file__).resolve().parents[1]


def _hparams(width, **kw):
    base = dict(pos_xyz_dim=12, pos_dir_dim=4, layers=8, skip_layers=[4],
                layer_dim=width, bg_layer_dim=width, appearance_dim=48,
                affine_appearance=False, use_cascade=False, sh_deg=None,
                shifted_softplus=True, compute_dtype="bfloat16")
    base.update(kw)
    return Namespace(**base)


def _kernel_walk(m, tm, grid):
    """numpy mirror of eval_fwd_kernel's loop: CTA b takes tile t = b, then
    t += gridDim.x while t < ceil(M / TM) -> (CTA, tile) pairs in issue
    order."""
    ntiles = -(-m // tm)
    steps = -(-ntiles // grid)
    b = np.repeat(np.arange(grid), steps)
    t = b + grid * np.tile(np.arange(steps), grid)
    keep = t < ntiles
    return b[keep], t[keep]


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("m", [1, 127, 128, 129, 1_000_003, 8_388_608])
def test_eval_walk_covers_every_tile_once(m, grid):
    """At both tiles of the plan, every tile of M points is walked by
    exactly one CTA, each CTA walks its tiles in increasing order, walks
    differ in length by at most one, and the tiles' rows cover [0, M)
    once. The wrapper's grid (`eval_grid`, with `grid` CTAs resident) has
    at least one CTA and no CTA without a tile."""
    for tm in (128, 64):
        ntiles = -(-m // tm)
        b, t = _kernel_walk(m, tm, grid)
        assert np.array_equal(np.sort(t), np.arange(ntiles))
        lengths = np.bincount(b, minlength=grid)
        for cta in range(grid):
            assert (np.diff(t[b == cta]) == grid).all()
        assert lengths.max() - lengths.min() <= 1
        rows = np.minimum((t + 1) * tm, m) - t * tm
        assert (rows > 0).all() and rows.sum() == m
        g = fused_mlp.eval_grid(m, tm, grid)
        assert 1 <= g <= min(grid, ntiles)
        assert np.bincount(_kernel_walk(m, tm, g)[0], minlength=g).min() > 0


@pytest.mark.parametrize("width", range(16, 513, 16))
def test_eval_plan_accepts_packed_weights(width):
    """`pack_params` output matches the plan the eval kernel follows at
    every admitted width, fg and bg, with and without appearance and dirs;
    the plan's tile is 128 points to width 256, else 64."""
    for kw in ({}, {"appearance_dim": 0, "pos_dir_dim": 0}):
        for make in (make_nerf, make_bg_nerf):
            bundle = make(_hparams(width, **kw), 3)
            packed = fused_mlp.pack_params(bundle.module)
            plan = fused_mlp.eval_plan(packed)
            assert plan.mats == [tuple(w.shape) for w in packed.mats]
            assert plan.tm == (128 if width <= 256 else 64)


@pytest.mark.parametrize("which", [0, 4, -1])
def test_eval_plan_rejects_a_mismatched_matrix(which):
    """A packed matrix of another shape than the plan's (here one column
    narrower: the first layer, the skip layer, dir_a) is refused before any
    launch."""
    bundle = make_nerf(_hparams(64), 3)
    packed = fused_mlp.pack_params(bundle.module)
    packed.mats[which] = packed.mats[which][:, :-16].contiguous()
    with pytest.raises(ValueError, match="do not match the plan"):
        fused_mlp.eval_plan(packed)


def test_build_sources_are_the_kernel_files():
    """`_build.SOURCES` names exactly the `.cu` files under `render/csrc/`,
    the eval kernels (narrow and wide) among them, and every source
    `chip_smoke.py` lists exists (a stale name would fail only on the
    card)."""
    on_disk = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert set(_build.SOURCES) == on_disk
    assert len(_build.SOURCES) == len(on_disk)
    assert {"eval_fwd", "eval_wide"} <= on_disk
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sources = {name: src for name, src, _ in smoke.KERNELS}
    assert sources["fused_nerf_eval"] == "mega_nerf_tpu_torch/render/csrc/eval_fwd.cu"
    for name in ("eval_wide_encode", "eval_wide_layer", "eval_wide_heads"):
        assert sources[name] == "mega_nerf_tpu_torch/render/csrc/eval_wide.cu"
    for src in sources.values():
        assert (ROOT / src).is_file(), src
        assert Path(src).stem in _build.SOURCES


def test_eval_wrapper_rejects_other_devices():
    """Only CPU tensors (the plain version) and CUDA tensors (the kernel)
    are taken."""
    bundle = make_nerf(_hparams(16, appearance_dim=0), 3)
    packed = fused_mlp.pack_params(bundle.module)
    xyz = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp.fused_nerf_eval(packed, xyz)


@pytest.mark.parametrize("width,bg,kw", [
    (16, False, {}),
    (16, True, {}),
    (48, False, {"layers": 6, "skip_layers": [3], "pos_dir_dim": 0}),
])
def test_eval_wrapper_on_cpu_matches_pallas_interpret(width, bg, kw):
    """The wrapper on CPU tensors (its plain version) against the JAX
    package's Pallas eval kernel in interpret mode, at the narrow widths the
    new kernel's plan admits: the same Flax weights and numpy inputs, f32
    compute, 5e-5 absolute (as the JAX package's own Pallas-vs-Flax test);
    200 points, not a multiple of the JAX block."""
    hp = _hparams(width, compute_dtype="float32", appearance_dim=8, **kw)
    count = 5
    jb = (j_make_bg_nerf if bg else j_make_nerf)(hp, count)
    params = jax.device_get(jb.init(jax.random.key(3)))
    cfg = nerf_config_from_hparams(hp, count, width, 4 if bg else 3)
    module = NeRF(cfg)
    module.load_state_dict(state_from_flax_params(cfg, params))
    rng = np.random.default_rng(4)
    n, block = 200, 128
    xyz = rng.normal(size=(n, cfg.xyz_dim)).astype(np.float32)
    dirs = rng.normal(size=(n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    app = np.asarray(params["appearance"]["embedding"])[rng.integers(0, count, n)]
    use_dirs = cfg.pos_dir_dim > 0
    m_pad = -(-n // block) * block
    pad = lambda a: jnp.asarray(  # noqa: E731
        np.concatenate([a, np.repeat(a[-1:], m_pad - n, 0)]))
    want = j_fused(j_pack(jb.config, params), pad(xyz),
                   pad(dirs) if use_dirs else None, pad(app), block=block,
                   interpret=True)[:n]
    packed = fused_mlp.pack_params(module)
    calls = fused_mlp.fused_nerf_eval_plain.calls
    got = fused_mlp.fused_nerf_eval(
        packed, torch.from_numpy(xyz), torch.from_numpy(dirs) if use_dirs else None,
        torch.from_numpy(app))
    assert fused_mlp.fused_nerf_eval_plain.calls == calls + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_eval_plan_is_the_training_forward_plan():
    """The eval kernel follows the training forward's tile and shared
    memory unchanged (the same layer chain)."""
    from mega_nerf_tpu_torch.render import fused_train

    bundle = make_nerf(_hparams(256), 3)
    packed = fused_mlp.pack_params(bundle.module)
    assert fused_mlp.eval_plan(packed) is fused_train.train_fwd_plan(packed.config)
