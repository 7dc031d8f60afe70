"""Parity of the port's training pieces with the JAX package, on the CPU.

- `sample_pdf` random mode fed JAX's own sorted uniforms (same key, same
  exponential-spacings form): to 1e-6 (absolute and relative);
- values and gradients of `composite_weights` and
  `composite_weights_merge` (both flips) against `jax.grad` of the JAX
  forms (the merge's log-domain one included): 1e-5;
- the eager `NeRF` with sigma noise against the Flax apply: 5e-5;
- the fused training apply (plain version, through autograd) against
  `pallas_train.fused_nerf_train_apply` in interpret mode and against the
  port's own eager autograd: values rtol 1e-5, gradients atol 2e-4, 5e-4 at
  the width-32 paper-architecture case (`tests/test_pallas_train.py`'s
  tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.ops.compositing import composite_weights as j_cw
from mega_nerf_tpu.ops.compositing import composite_weights_merge as j_cwm
from mega_nerf_tpu.ops.sampling import sample_pdf as j_sample_pdf
from mega_nerf_tpu.render.pallas_train import fused_nerf_train_apply as j_train_apply
from mega_nerf_tpu_torch.models import (
    NeRF,
    flax_params_from_state,
    nerf_config_from_hparams,
    state_from_flax_params,
)
from mega_nerf_tpu_torch.ops.compositing import (
    composite_weights,
    composite_weights_merge,
)
from mega_nerf_tpu_torch.ops.sampling import sample_pdf, sorted_uniforms
from mega_nerf_tpu_torch.render import fused_train
from tests.test_models import tiny_hparams


def test_sample_pdf_random_mode_matches_jax():
    rng = np.random.default_rng(0)
    n, s, fs = 32, 17, 24
    bins = np.sort(rng.uniform(0.5, 3.0, (n, s + 1)), -1).astype(np.float32)
    weights = rng.uniform(0, 1, (n, s)).astype(np.float32)
    key = jax.random.key(5)
    want = j_sample_pdf(jnp.asarray(bins), jnp.asarray(weights), fs, det=False,
                        key=key, grouped=False)
    # ops/sampling.py's draw: sorted uniforms via exponential spacings.
    e = -jnp.log1p(-jax.random.uniform(key, (n, fs + 1), dtype=jnp.float32))
    c = jnp.cumsum(e, axis=-1)
    u = np.asarray(c[:, :-1] / c[:, -1:])
    got = sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), fs,
                     det=False, u=torch.from_numpy(u.copy()))
    # 1e-6 absolute plus 1e-6 relative: depths reach 3, where one f32 ulp
    # is 2.4e-7, and XLA's cumsum of the pdf rounds in another order.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert (np.diff(got.numpy(), axis=-1) >= 0).all()


def test_sorted_uniforms_ascend_in_unit_interval():
    u = sorted_uniforms(64, 33, torch.Generator().manual_seed(0))
    assert u.shape == (64, 33)
    assert (u > 0).all() and (u < 1).all()
    assert (torch.diff(u, dim=-1) >= 0).all()
    # order statistics of 33 uniforms: E[u_k] = k / 34
    np.testing.assert_allclose(u.mean(0).numpy(), np.arange(1, 34) / 34, atol=0.08)


def _composite_inputs(n=24, sa=12, sb=9, seed=0):
    rng = np.random.default_rng(seed)
    za = np.sort(rng.uniform(0.5, 3.0, (n, sa)), -1).astype(np.float32)
    zb = np.sort(rng.uniform(0.5, 3.0, (n, sb)), -1).astype(np.float32)
    zb[:, 2] = za[:, 3]  # a tie across the lists
    zb = np.sort(zb, -1)  # the merge takes each list sorted
    sig_a = rng.uniform(0, 3, (n, sa)).astype(np.float32)
    sig_b = rng.uniform(0, 3, (n, sb)).astype(np.float32)
    last = np.where(np.arange(n)[:, None] % 2 == 0, 1e10, 0.7).astype(np.float32)
    probe = rng.normal(size=(n, sa + sb)).astype(np.float32)
    probe_l = rng.normal(size=(n,)).astype(np.float32)
    return za, zb, sig_a, sig_b, last, probe, probe_l


@pytest.mark.parametrize("flip", [False, True])
def test_composite_weights_grads_match_jax(flip):
    za, _, sig, _, last, probe, probe_l = _composite_inputs()
    if flip:
        za = za[:, ::-1].copy()
    probe = probe[:, :za.shape[1]]

    def j_loss(s):
        cw = j_cw(s, jnp.asarray(za), jnp.asarray(last), flip=flip)
        return jnp.sum(cw.weights * probe) + jnp.sum(cw.bg_lambda * probe_l)

    want_v, want_g = jax.value_and_grad(j_loss)(jnp.asarray(sig))
    s_t = torch.from_numpy(sig).requires_grad_()
    cw = composite_weights(s_t, torch.from_numpy(za), torch.from_numpy(last), flip=flip)
    loss = (cw.weights * torch.from_numpy(probe)).sum() \
        + (cw.bg_lambda * torch.from_numpy(probe_l)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(want_g), atol=1e-5)


@pytest.mark.parametrize("flip", [False, True])
def test_composite_weights_merge_grads_match_jax(flip):
    za, zb, sig_a, sig_b, last, probe, probe_l = _composite_inputs(seed=1)
    if flip:
        za, zb = za[:, ::-1].copy(), zb[:, ::-1].copy()

    def j_loss(sa, sb):
        cw = j_cwm(jnp.asarray(za), sa, jnp.asarray(zb), sb, jnp.asarray(last),
                   flip=flip)
        return jnp.sum(cw.weights * probe) + jnp.sum(cw.bg_lambda * probe_l)

    want_v, (ga, gb) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(sig_a), jnp.asarray(sig_b))
    ta = torch.from_numpy(sig_a).requires_grad_()
    tb = torch.from_numpy(sig_b).requires_grad_()
    cw = composite_weights_merge(torch.from_numpy(za), ta, torch.from_numpy(zb),
                                 tb, torch.from_numpy(last), flip=flip)
    loss = (cw.weights * torch.from_numpy(probe)).sum() \
        + (cw.bg_lambda * torch.from_numpy(probe_l)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), atol=1e-5)


def _setup(hp_kw, bg=False, count=6, n=192, seed=0):
    hp = tiny_hparams(**hp_kw)
    jb = (j_make_bg_nerf if bg else j_make_nerf)(hp, count)
    params = jax.device_get(jb.init(jax.random.key(seed)))
    cfg = nerf_config_from_hparams(
        hp, count, hp.bg_layer_dim if bg else hp.layer_dim, 4 if bg else 3)
    module = NeRF(cfg)
    module.load_state_dict(state_from_flax_params(cfg, params))
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, cfg.xyz_dim)).astype(np.float32)
    dirs = rng.normal(size=(n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    idx = rng.integers(0, count, n).astype(np.int32)
    noise = np.asarray(jax.random.uniform(jax.random.key(7), (n,)))
    probe = rng.normal(size=(n, 4)).astype(np.float32)
    return jb, params, module, cfg, xyz, dirs, idx, noise, probe


def test_nerf_module_sigma_noise_matches_flax():
    jb, params, module, cfg, xyz, dirs, idx, noise, _ = _setup({"appearance_dim": 4})
    want = jb.apply(params, "fine", jnp.asarray(xyz), jnp.asarray(dirs),
                    jnp.asarray(idx), jnp.asarray(noise)[:, None])
    with torch.no_grad():
        got = module(torch.from_numpy(xyz), torch.from_numpy(dirs),
                     torch.from_numpy(idx), torch.from_numpy(noise))
        plain = module(torch.from_numpy(xyz), torch.from_numpy(dirs),
                       torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    assert not np.allclose(got[:, 3].numpy(), plain[:, 3].numpy())


def _port_grads(module, cfg, xyz, dirs, idx, noise, probe, fused):
    module.zero_grad(set_to_none=True)
    use_dirs, use_app = cfg.pos_dir_dim > 0, cfg.appearance_dim > 0
    x = torch.from_numpy(xyz)
    d = torch.from_numpy(dirs) if use_dirs else None
    nz = None if noise is None else torch.from_numpy(noise)
    i = torch.from_numpy(idx).long()
    if fused:
        app = module.appearance(i).float() if use_app else None
        out = fused_train.fused_nerf_train_apply(module, x, d, app, nz)
    else:
        out = module(x, d, i if use_app else None, nz)
    loss = (out * torch.from_numpy(probe)).sum()
    loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in module.named_parameters()}
    return loss.item(), flax_params_from_state(cfg, grads)


CASES = {
    "full": ({"appearance_dim": 4}, True, 2e-4),
    "no_noise": ({"appearance_dim": 4}, False, 2e-4),
    "no_app": ({"appearance_dim": 0}, True, 2e-4),
    "no_dirs_no_app": ({"appearance_dim": 0, "pos_dir_dim": 0}, True, 2e-4),
    "paper_arch_w32": ({"pos_xyz_dim": 12, "pos_dir_dim": 4, "layers": 8,
                        "skip_layers": [4], "layer_dim": 32, "bg_layer_dim": 32,
                        "appearance_dim": 8}, True, 5e-4),
}


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_train_plain_matches_pallas(case, bg):
    kw, with_noise, atol = CASES[case]
    jb, params, module, cfg, xyz, dirs, idx, noise, probe = _setup(kw, bg=bg)
    noise = noise if with_noise else None
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
            app, None if noise is None else jnp.asarray(noise)[:, None],
            block=64, interpret=True, dir_pack=False)
        return jnp.sum(out * probe)

    want_v, want_g = jax.value_and_grad(j_loss)(params)
    calls = (fused_train.train_bwd_data_plain.calls,
             fused_train.weight_grad_plain.calls)
    got_v, got_g = _port_grads(module, cfg, xyz, dirs, idx, noise, probe, True)
    assert (fused_train.train_bwd_data_plain.calls,
            fused_train.weight_grad_plain.calls) == (calls[0] + 1, calls[1] + 1)
    eager_v, eager_g = _port_grads(module, cfg, xyz, dirs, idx, noise, probe, False)
    np.testing.assert_allclose(got_v, float(want_v), rtol=1e-5)
    np.testing.assert_allclose(got_v, eager_v, rtol=1e-5)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want_g))
    flat_e = dict(jax.tree_util.tree_leaves_with_path(eager_g))
    got = jax.tree_util.tree_leaves_with_path(got_g)
    assert len(got) == len(flat_w)
    for path, leaf in got:
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(leaf, np.asarray(flat_w[path]), atol=atol,
                                   err_msg=f"vs pallas {name}")
        np.testing.assert_allclose(leaf, flat_e[path], atol=atol,
                                   err_msg=f"vs eager {name}")


def test_train_layouts_cover_packed_matrices():
    """The weight-gradient jobs write every packed gradient element once:
    the kernel allocates its output uninitialised."""
    _, _, module, cfg, *_ = _setup({"pos_xyz_dim": 12, "pos_dir_dim": 4,
                                    "layers": 8, "skip_layers": [4],
                                    "layer_dim": 64, "appearance_dim": 48}, bg=True)
    from mega_nerf_tpu_torch.render import fused_mlp

    packed = fused_mlp.pack_params(module)
    total = fused_train._offsets(fused_train.packed_shapes(packed))[-1]
    hits = np.zeros(total, np.int32)
    for d_col, n, x_col, k, out_off, stride, bias_off in fused_train.weight_grad_jobs(packed):
        for r in range(n):
            hits[out_off + r * stride:out_off + r * stride + k] += 1
        if bias_off >= 0:
            hits[bias_off:bias_off + n] += 1
    assert (hits == 1).all()
    lay, gl = fused_train.act_layout(packed), fused_train.grad_layout(packed)
    assert lay["width"] % 8 == 0 and gl["width"] % 8 == 0
    assert all(v % 8 == 0 for v in lay.values())


def _plan_packed(width):
    from mega_nerf_tpu_torch.render import fused_mlp

    if width == 48:
        kw = {"pos_xyz_dim": 12, "pos_dir_dim": 0, "layers": 6, "skip_layers": [3],
              "appearance_dim": 0}
    else:
        kw = {"pos_xyz_dim": 12, "pos_dir_dim": 4, "layers": 8, "skip_layers": [4],
              "appearance_dim": 48}
    hp = tiny_hparams(layer_dim=width, bg_layer_dim=width, **kw)
    module = NeRF(nerf_config_from_hparams(hp, 6, width, 3))
    return fused_mlp.pack_params(module)


@pytest.mark.parametrize("width,m", [(256, 524_288), (256, 9_000), (16, 1_000),
                                     (48, 50_003)])
def test_weight_grad_plan_covers_every_output_once(width, m):
    """The weight-gradient kernel's plan, mirrored in numpy: every (job,
    n-tile, k-tile) is one tile; the splits partition [0, M) in whole
    stages; the tiles pair into clusters that share what they say they
    share; each tile's last CTA, whichever finishes last, sums the f32
    partials in split order and writes each live weight and bias once. The
    kernel allocates its output uninitialised. Paper width (the fg-fine
    shape, plan only, and a small M), widths 16 and 48; no M is a multiple
    of the 64-point stage. Numbers: the f32 sums match `weight_grad_plain`
    to 1e-5 relative (another summation order), and two completion orders
    give the same bits."""
    ft = fused_train
    packed = _plan_packed(width)
    plan = ft.weight_grad_plan(packed, m)
    want_tiles = [(j, n0, k0) for j, job in enumerate(plan.jobs)
                  for n0 in range(0, job[1], ft.WG_TILE_N)
                  for k0 in range(0, job[3], ft.WG_TILE_K)]
    work = [t for t in plan.tiles if t != ft.WG_IDLE]
    assert sorted(work) == sorted(want_tiles)
    assert len(plan.tiles) - len(work) <= 1
    assert len(plan.share) * 2 == len(plan.tiles)
    for c, share in enumerate(plan.share):  # what a cluster's CTAs load once
        (j0, n0, k0), (j1, n1, k1) = plan.tiles[2 * c:2 * c + 2]
        if share == ft.WG_SHARE_X:
            assert (j0, k0) == (j1, k1) and n1 == n0 + ft.WG_TILE_N
        elif share == ft.WG_SHARE_A:
            assert (j0, n0) == (j1, n1) and k1 == k0 + ft.WG_TILE_K
        else:
            assert share == ft.WG_SHARE_NONE
    assert plan.split_len % ft.WG_STAGE == 0
    ranges = [(s * plan.split_len, min(m, (s + 1) * plan.split_len))
              for s in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == m
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(plan.splits - 1))
    assert len(plan.tiles) * plan.splits <= max(ft.WG_WAVES * 132, len(plan.tiles))
    if m > 100_000:
        return

    rng = np.random.default_rng(width)
    aw, gw = ft.act_layout(packed)["width"], ft.grad_layout(packed)["width"]
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    act_t, grad_t = bf(rng.normal(size=(m, aw)).astype(np.float32)), \
        bf(rng.normal(size=(m, gw)).astype(np.float32))
    rows = -(-m // ft.WG_STAGE) * ft.WG_STAGE + ft.WG_TILE_K
    act = np.zeros((rows, aw + ft.WG_TILE_K), np.float32)  # TMA's zero fill
    grad = np.zeros((rows, gw + ft.WG_TILE_N), np.float32)
    act[:m, :aw], grad[:m, :gw] = act_t.float().numpy(), grad_t.float().numpy()
    total = ft._offsets(ft.packed_shapes(packed))[-1]

    def run(order_seed):
        out = np.full(total, np.nan, np.float32)
        hits = np.zeros(total, np.int32)
        order = np.random.default_rng(order_seed).permutation(plan.splits)
        for j, n0, k0 in work:
            d_col, n, x_col, k, out_off, stride, bias_off = plan.jobs[j]
            parts = []
            for s in order:  # the CTAs of this tile finish in any order
                mb = s * plan.split_len
                me = mb + -(-(min(m, mb + plan.split_len) - mb) // ft.WG_STAGE) * ft.WG_STAGE
                d = grad[mb:me, d_col + n0:d_col + n0 + ft.WG_TILE_N]
                x = act[mb:me, x_col + k0:x_col + k0 + ft.WG_TILE_K]
                parts.append((s, d.T @ x, d.sum(0)))
            parts.sort(key=lambda p: p[0])  # the last CTA sums in split order
            dw = np.zeros_like(parts[0][1])
            db = np.zeros_like(parts[0][2])
            for _, pw, pb in parts:
                dw += pw
                db += pb
            nr, nc = min(ft.WG_TILE_N, n - n0), min(ft.WG_TILE_K, k - k0)
            for r in range(nr):
                o = out_off + (n0 + r) * stride + k0
                out[o:o + nc] = dw[r, :nc]
                hits[o:o + nc] += 1
            if bias_off >= 0 and k0 == 0:
                out[bias_off + n0:bias_off + n0 + nr] = db[:nr]
                hits[bias_off + n0:bias_off + n0 + nr] += 1
        return out, hits

    out, hits = run(0)
    assert (hits == 1).all()
    out2, _ = run(1)
    assert np.array_equal(out, out2)
    want = ft.weight_grad_plain(packed, act_t, grad_t).numpy()
    offs = ft._offsets(ft.packed_shapes(packed))
    for i in range(len(offs) - 1):
        a, b = out[offs[i]:offs[i + 1]], want[offs[i]:offs[i + 1]]
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), i
