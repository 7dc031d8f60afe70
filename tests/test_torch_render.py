"""Parity of the port's eval `render_rays` with the JAX package's.

Both render the same rays through the same fg+bg weights (tiny widths,
float32), hierarchically (coarse + fine, bg flipped). The JAX side runs its
XLA MLP path (`use_pallas=False`) with the pairwise merge compositor that
its non-TPU eval path uses. Tolerances: rgb atol 1e-4, depth rtol 5e-4
(the bg's metric depth reaches 1e8 at inverse depth 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.render import RenderSettings as JSettings
from mega_nerf_tpu.render import render_rays as j_render_rays
from mega_nerf_tpu_torch.models import make_bg_nerf, make_nerf, state_from_flax_params
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays
from tests.test_models import tiny_hparams

CENTER = np.array([0.05, -0.1, 0.0], np.float32)
RADIUS = np.array([1.4, 1.1, 1.2], np.float32)


def _bundles(hp, count):
    out = []
    for j_make, t_make, seed in ((j_make_nerf, make_nerf, 0),
                                 (j_make_bg_nerf, make_bg_nerf, 1)):
        jb = j_make(hp, count)
        params = jax.device_get(jb.init(jax.random.key(seed)))
        tb = t_make(hp, count)
        tb.module.load_state_dict(state_from_flax_params(tb.config, params))
        tb.module.eval()
        out.append((jb, params, tb))
    return out


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-0.3, 0.3, size=(n, 3)) * 0.5).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    near = np.full((n, 1), 0.05, np.float32)
    # Half the rays end inside the ellipsoid (no bg), half run to 1e5.
    far = np.where(np.arange(n)[:, None] % 2 == 0, 1e5, 0.8).astype(np.float32)
    return np.concatenate([o, d, near, far], -1)


@pytest.mark.parametrize("mlp", ["fused", "eager"])
@pytest.mark.parametrize("ref_bg_sampling", [False, True])
@pytest.mark.parametrize("fine", [24, 0])
def test_render_rays_matches_jax(mlp, ref_bg_sampling, fine):
    hp = tiny_hparams(appearance_dim=4, compute_dtype="float32")
    (jfg, pfg, tfg), (jbg, pbg, tbg) = _bundles(hp, 5)
    rays = _rays(48, seed=3)
    idx = np.arange(48, dtype=np.int32) % 5
    coarse = 16
    jset = JSettings(coarse_samples=coarse, fine_samples=fine, use_pallas=False,
                     eval_compositor="merge", ref_bg_sampling=ref_bg_sampling,
                     get_depth=True, get_bg_fg_rgb=True)
    want, _ = j_render_rays(jfg, jbg, pfg, pbg, jnp.asarray(rays),
                            jnp.asarray(idx), jset, jnp.asarray(CENTER),
                            jnp.asarray(RADIUS), train=False)
    tset = RenderSettings(coarse_samples=coarse, fine_samples=fine,
                          use_fused_kernel=(mlp == "fused"),
                          ref_bg_sampling=ref_bg_sampling,
                          get_depth=True, get_bg_fg_rgb=True)
    with torch.no_grad():
        got, _ = render_rays(tfg, tbg, torch.from_numpy(rays),
                             torch.from_numpy(idx).long(), tset,
                             torch.from_numpy(CENTER), torch.from_numpy(RADIUS))
    typ = "fine" if fine else "coarse"
    for key in (f"rgb_{typ}", f"fg_rgb_{typ}", f"bg_rgb_{typ}"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)
    for key in (f"depth_{typ}", f"fg_depth_{typ}"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=5e-4, atol=1e-5, err_msg=key)
    assert set(got) == set(want)
