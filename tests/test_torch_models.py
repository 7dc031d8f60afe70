"""Parity of the port's NeRF module and fused eval MLP with the JAX package.

Weights are the JAX package's Flax params, carried over with
`state_from_flax_params`. float32 compute agrees to atol 5e-5, as the JAX
package's own Pallas-vs-Flax test (`tests/test_pallas_mlp.py`).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.models.torch_interop import torch_state_from_flax_params
from mega_nerf_tpu.render.pallas_mlp import fused_nerf_eval as j_fused
from mega_nerf_tpu.render.pallas_mlp import pack_params as j_pack
from mega_nerf_tpu_torch.models import (
    NeRF,
    flax_params_from_state,
    make_bg_nerf,
    make_nerf,
    nerf_config_from_hparams,
    state_from_flax_params,
)
from mega_nerf_tpu_torch.render import fused_mlp
from tests.test_models import tiny_hparams

PAPER = {"pos_xyz_dim": 12, "pos_dir_dim": 4, "layers": 8, "skip_layers": [4],
         "layer_dim": 256, "bg_layer_dim": 256, "appearance_dim": 48}

CASES = {
    "tiny": ({"appearance_dim": 4}, 6, False),
    "tiny_bg": ({"appearance_dim": 4}, 6, True),
    "tiny_no_app": ({"appearance_dim": 0}, 1, False),
    "tiny_no_dirs": ({"appearance_dim": 0, "pos_dir_dim": 0}, 1, False),
    "tiny_ref_packed_dirs": ({"appearance_dim": 0, "ref_packed_dirs": True}, 1, False),
    "paper_fg": (PAPER, 16, False),
    "paper_bg": (PAPER, 16, True),
}


def _setup(case, seed=0, compute_dtype="float32"):
    kw, count, bg = CASES[case]
    hp = tiny_hparams(**kw, compute_dtype=compute_dtype)
    jb = (j_make_bg_nerf if bg else j_make_nerf)(hp, count)
    params = jax.device_get(jb.init(jax.random.key(seed)))
    cfg = nerf_config_from_hparams(
        hp, count, hp.bg_layer_dim if bg else hp.layer_dim, 4 if bg else 3)
    module = NeRF(cfg)
    module.load_state_dict(state_from_flax_params(cfg, params))
    module.eval()
    return jb, params, module, cfg


def _inputs(cfg, n, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, cfg.xyz_dim)).astype(np.float32)
    dirs = rng.normal(size=(n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    idx = rng.integers(0, cfg.appearance_count, n).astype(np.int32)
    return xyz, dirs, idx


@pytest.mark.parametrize("case", sorted(CASES))
def test_nerf_module_matches_flax(case):
    jb, params, module, cfg = _setup(case)
    xyz, dirs, idx = _inputs(cfg, 256, 1)
    use_dirs, use_app = cfg.pos_dir_dim > 0, cfg.appearance_dim > 0
    want = jb.apply(params, "fine", jnp.asarray(xyz),
                    jnp.asarray(dirs) if use_dirs else None,
                    jnp.asarray(idx) if use_app else None)
    with torch.no_grad():
        got = module(torch.from_numpy(xyz),
                     torch.from_numpy(dirs) if use_dirs else None,
                     torch.from_numpy(idx) if use_app else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def _fused_pair(case, compute_dtype, n=300):
    """(port plain fused, JAX interpret-mode Pallas kernel) on one input;
    n is not a multiple of the JAX block, so both pad/mask a ragged tail."""
    jb, params, module, cfg = _setup(case, seed=2, compute_dtype=compute_dtype)
    xyz, dirs, idx = _inputs(cfg, n, 3)
    use_dirs, use_app = cfg.pos_dir_dim > 0, cfg.appearance_dim > 0
    app = np.asarray(params["appearance"]["embedding"])[idx] if use_app else None
    m_pad = -(-n // 128) * 128
    pad = lambda a: None if a is None else jnp.asarray(  # noqa: E731
        np.concatenate([a, np.repeat(a[-1:], m_pad - n, 0)]))
    want = j_fused(j_pack(jb.config, params), pad(xyz),
                   pad(dirs) if use_dirs else None, pad(app), block=128,
                   interpret=True)[:n]
    packed = fused_mlp.pack_params(module)
    app_t = None if app is None else torch.from_numpy(app).to(cfg.dtype)
    got = fused_mlp.fused_nerf_eval_plain(
        packed, torch.from_numpy(xyz),
        torch.from_numpy(dirs) if use_dirs else None, app_t)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("case", ["tiny", "tiny_no_dirs", "paper_fg", "paper_bg"])
def test_plain_fused_matches_pallas_f32(case):
    got, want = _fused_pair(case, "float32")
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("case", ["paper_fg", "paper_bg"])
def test_plain_fused_matches_pallas_bf16(case):
    """bf16 compute: both round at the same points; a float32 sum taken in
    another order can flip one bf16 rounding of an activation, so the
    tolerance is the kernel comparison's (1e-2 absolute)."""
    got, want = _fused_pair(case, "bfloat16")
    np.testing.assert_allclose(got, want, atol=1e-2)
    assert np.abs(got - want).mean() < 1e-3


def test_weight_round_trip_and_reference_naming():
    _, params, module, cfg = _setup("paper_fg")
    state = state_from_flax_params(cfg, params)
    assert set(state) == set(module.state_dict())
    ref_names = torch_state_from_flax_params(_jcfg("paper_fg"), params)
    assert set(ref_names) == set(state)
    for k, v in ref_names.items():
        np.testing.assert_array_equal(state[k].numpy(), v)
    back = flax_params_from_state(cfg, module.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf))


def _jcfg(case):
    kw, count, bg = CASES[case]
    hp = tiny_hparams(**kw)
    return (j_make_bg_nerf if bg else j_make_nerf)(hp, count).config


def test_wrapper_runs_plain_on_cpu():
    _, _, module, cfg = _setup("tiny_no_app")
    packed = fused_mlp.pack_params(module)
    xyz, dirs, _ = _inputs(cfg, 10, 4)
    launches = fused_mlp.fused_nerf_eval.launches
    calls = fused_mlp.fused_nerf_eval_plain.calls
    out = fused_mlp.fused_nerf_eval(packed, torch.from_numpy(xyz),
                                    torch.from_numpy(dirs))
    assert out.shape == (10, 4)
    assert fused_mlp.fused_nerf_eval.launches == launches
    assert fused_mlp.fused_nerf_eval_plain.calls == calls + 1


@pytest.mark.parametrize("kw,why", [
    ({"sh_deg": 1, "pos_dir_dim": 0}, "SH output head"),
    ({"affine_appearance": True, "appearance_dim": 4}, "affine appearance"),
])
def test_unported_heads_raise(kw, why):
    """The SH and affine heads, once refused at model build, now build; the
    fused kernels do not cover them (eval or training), so the renderer
    runs them on the eager module, as the JAX package runs them on XLA."""
    from mega_nerf_tpu_torch.render import rendering
    from mega_nerf_tpu_torch.render.rendering import RenderSettings

    cfg = nerf_config_from_hparams(tiny_hparams(**kw), 3, 16, 3)
    module = NeRF(cfg)
    for train in (False, True):
        assert fused_mlp.supports_fused_kernel(cfg, train) == (False, why)
    hp = tiny_hparams(**kw)
    bundle = make_nerf(hp, 3)
    ok, reason = rendering.fused_gate(bundle, RenderSettings.from_hparams(hp), False, "cpu")
    assert not ok and reason == why
    xyz = torch.zeros((5, 3))
    idx = torch.zeros(5, dtype=torch.long)
    with torch.no_grad():
        out = module(xyz, None if cfg.pos_dir_dim == 0 else torch.ones((5, 3)), idx)
    assert out.shape == (5, cfg.rgb_dim + 1)


CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.parametrize("family", sorted(p.name for p in CONFIGS.iterdir()))
def test_every_config_builds(family):
    """`NeRFConfig`, `NeRF`, `make_nerf` and `make_bg_nerf` build every file
    of a config family (on the meta device: shapes only, no storage)."""
    from mega_nerf_tpu_torch.eval import get_eval_opts
    from mega_nerf_tpu_torch.models import Cascade

    files = sorted((CONFIGS / family).glob("*.yaml"))
    assert files
    for path in files:
        hp = get_eval_opts(["--config_file", str(path), "--exp_name", "x",
                            "--dataset_path", "x"])
        with torch.device("meta"):
            bundles = [make_nerf(hp, 4)] + ([make_bg_nerf(hp, 4)] if hp.bg_nerf else [])
            NeRF(nerf_config_from_hparams(hp, 4, hp.layer_dim, 3))
        for b in bundles:
            assert b.cascade == bool(hp.use_cascade)
            assert isinstance(b.module, Cascade if b.cascade else NeRF)
            assert b.level("fine").rgb.out_features == b.config.rgb_dim


def test_flops_per_point_at_paper_width():
    """The bound's operation count: ~1.21 MFLOP (fg) and ~1.24 (bg)."""
    fg = nerf_config_from_hparams(tiny_hparams(**PAPER), 16, 256, 3)
    bg = nerf_config_from_hparams(tiny_hparams(**PAPER), 16, 256, 4)
    assert fused_mlp.flops_per_point(fg) == 2 * 605_696
    assert fused_mlp.flops_per_point(bg) == 2 * 618_496
