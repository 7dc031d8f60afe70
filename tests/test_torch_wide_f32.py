"""f32 compute at layer widths 513-1024 (`--compute_dtype float32` through the
wide route: `fused_wide_f32.py` around `csrc/wide_f32.cu` and the f32 weight
gradient of `csrc/train_f32.cu`), checked without a GPU.

The port's wide wrappers on CPU tensors (their plain versions, which the f32
wide kernels are held against on the card) against the JAX package's Pallas
kernels in interpret mode, jitted, on the same Flax weights (carried across
by `state_from_flax_params`) and numpy-seeded points, appearance rows and
sigma noise; widths 576 and 640, 3 layers with the skip at 2, 192 points:

- eval: `fused_wide.fused_nerf_eval_wide` against `pallas_mlp.
  fused_nerf_eval` (`_mlp_kernel`): 5e-5 absolute (PERF.md section 2's
  forward limit);
- training: the forward of `fused_train.fused_nerf_train_apply` with sigma
  noise against `pallas_train.fused_nerf_train_apply` (`_train_fwd_kernel`),
  5e-5 absolute; its backward through autograd (the wide route's heads
  backward, dX and dW steps) against `jax.value_and_grad` through the
  custom VJP (`_train_bwd_kernel`): every parameter's gradient and d_app
  within 2e-4 of the JAX tensor's norm (section 2's gradient limit).

Cases: fg and bg, with and without dirs and appearance, and without the
branch (neither). Also the f32 sub-chunk (4-byte scratch), the weight
gradient's plans (the wide route's dW steps write every packed element
once; the narrow plan's tiles and splits as before), the gate, and one
`render_rays(train=True)` at 640 in f32 through the wide route against the
JAX renderer's fused Pallas path.
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
from mega_nerf_tpu.render.pallas_mlp import fused_nerf_eval as j_eval
from mega_nerf_tpu.render.pallas_mlp import pack_params as j_pack
from mega_nerf_tpu.render.pallas_train import fused_nerf_train_apply as j_train_apply
from mega_nerf_tpu_torch.models import (
    NeRF,
    NeRFConfig,
    flax_params_from_state,
    nerf_config_from_hparams,
    state_from_flax_params,
)
from mega_nerf_tpu_torch.render import (
    fused_f32,
    fused_mlp,
    fused_train,
    fused_wide,
    fused_wide_f32,
    rendering,
)
from mega_nerf_tpu_torch.render import fused_train_wide as ftw
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays
from tests.test_models import tiny_hparams
from tests.test_torch_train_loop import CENTER, RADIUS, _bundles, _grads, _rays

N, BLOCK, COUNT = 192, 64, 5
FWD_ATOL = 5e-5
GRAD_REL = 2e-4

CASES = {  # name: (width, pos_dir_dim, appearance_dim, bg)
    "fg576_dirs_app": (576, 4, 8, False),
    "bg640_dirs": (640, 4, 0, True),
    "fg640_app5": (640, 0, 5, False),  # appearance rows the kernels pad to 16
    "bg576_no_branch": (576, 0, 0, True),
}


def _setup(name):
    width, pos_dir_dim, appearance_dim, bg = CASES[name]
    hp = tiny_hparams(layer_dim=width, bg_layer_dim=width, skip_layers=[2],
                      pos_xyz_dim=6, pos_dir_dim=pos_dir_dim,
                      appearance_dim=appearance_dim, compute_dtype="float32")
    jb = (j_make_bg_nerf if bg else j_make_nerf)(hp, COUNT)
    params = jax.device_get(jax.jit(jb.init)(jax.random.key(7)))
    cfg = nerf_config_from_hparams(hp, COUNT, width, 4 if bg else 3)
    assert cfg.dtype == torch.float32 and jb.config.dtype == jnp.float32
    assert fused_mlp.supports_fused_kernel(cfg)[0] and fused_mlp.is_wide(cfg)
    assert fused_mlp.supports_fused_kernel(cfg, train=True)[0]
    module = NeRF(cfg)
    module.load_state_dict(state_from_flax_params(cfg, params))
    rng = np.random.default_rng(8)
    xyz = rng.normal(size=(N, cfg.xyz_dim)).astype(np.float32)
    dirs = rng.normal(size=(N, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    app = None
    if cfg.appearance_dim:
        app = np.asarray(params["appearance"]["embedding"])[rng.integers(0, COUNT, N)]
    noise = rng.uniform(size=N).astype(np.float32)
    probe = rng.normal(size=(N, 4)).astype(np.float32)
    return jb, params, module, cfg, xyz, dirs if cfg.pos_dir_dim else None, app, noise, probe


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _f32_launches():
    return (fused_wide_f32.wide_f32_kernel_launches(), fused_f32.weight_grad_f32.launches,
            fused_wide.wide_kernel_launches(), ftw.wide_train_kernel_launches())


@pytest.mark.parametrize("name", sorted(CASES))
def test_wide_f32_eval_and_train_match_pallas_interpret(name):
    """One case through both packages, f32 compute: the eval wrapper (one
    plain call, 5e-5 absolute against `_mlp_kernel`), the training forward
    with sigma noise (5e-5 against `_train_fwd_kernel`), and its backward
    (the plan's plain steps, once each) against the custom VJP: every
    parameter gradient and d_app within 2e-4 of the JAX tensor's norm, the
    loss sum(out * probe) within the forward limit carried through the
    probe (5e-5 sum |probe|). No kernel launches on CPU tensors."""
    jb, params, module, cfg, xyz, dirs, app, noise, probe = _setup(name)
    jp = j_pack(jb.config, params)

    def j_all(p, a):
        ev = j_eval(jp, jnp.asarray(xyz), _j(dirs), a, block=BLOCK, interpret=True)

        def j_loss(p_, a_):
            out = j_train_apply(jb.config, p_, jnp.asarray(xyz), _j(dirs), a_,
                                jnp.asarray(noise)[:, None], block=BLOCK, interpret=True,
                                dir_pack=False)
            return jnp.sum(out * probe), out

        return ev, jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(p, a)

    want_eval, ((want_v, want_out), (want_g, want_dapp)) = jax.jit(j_all)(params, _j(app))

    packed = fused_mlp.pack_params(module)
    assert all(w.dtype == torch.float32 for w in packed.mats)
    launches = _f32_launches()
    calls = fused_wide.fused_nerf_eval_wide_plain.calls
    with torch.no_grad():
        got_eval = fused_wide.fused_nerf_eval_wide(packed, _t(xyz), _t(dirs), _t(app))
    assert fused_wide.fused_nerf_eval_wide_plain.calls == calls + 1
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), rtol=0,
                               atol=FWD_ATOL)

    plan = ftw.train_wide_plan(cfg)
    n_dx = sum(kind == "dx" for kind, _ in plan.steps)
    plains = (ftw.train_wide_heads_bwd_plain, ftw.train_wide_dx_plain,
              ftw.train_wide_dw_plain)
    before = [f.calls for f in plains]
    app_t = None if app is None else _t(app).requires_grad_()
    out = fused_train.fused_nerf_train_apply(module, _t(xyz), _t(dirs), app_t, _t(noise))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0,
                               atol=FWD_ATOL)
    loss = (out * _t(probe)).sum()
    loss.backward()
    assert [f.calls - c for f, c in zip(plains, before)] == [1, n_dx,
                                                            len(plan.steps) - n_dx]
    assert _f32_launches() == launches
    assert abs(loss.item() - float(want_v)) <= FWD_ATOL * np.abs(probe).sum()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in module.named_parameters()}
    got_g = dict(jax.tree_util.tree_leaves_with_path(flax_params_from_state(cfg, grads)))
    flat_w = jax.tree_util.tree_leaves_with_path(want_g)
    assert len(flat_w) == len(got_g)
    for path, leaf in flat_w:
        a, b = np.asarray(got_g[path]), np.asarray(leaf)
        assert np.linalg.norm(a - b) <= GRAD_REL * np.linalg.norm(b) + 1e-7, \
            jax.tree_util.keystr(path)
    if app is not None:
        a, b = app_t.grad.numpy(), np.asarray(want_dapp)
        assert np.linalg.norm(b) > 0
        assert np.linalg.norm(a - b) <= GRAD_REL * np.linalg.norm(b), "d_app"


def _config(width, bg, pos_dir_dim=4, appearance_dim=48, dtype="float32"):
    return NeRFConfig(xyz_dim=4 if bg else 3, layer_dim=width, pos_xyz_dim=12,
                      pos_dir_dim=pos_dir_dim, layers=8, skip_layers=(4,),
                      appearance_dim=appearance_dim, compute_dtype=dtype)


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("width", [576, 640, 768, 896, 1024])
def test_wide_f32_sub_chunk_counts_four_byte_scratch(width, bg):
    """In f32 the wide eval's sub-chunk comes from 4-byte scratch (two
    activation buffers, the branch, the encodes, an appearance copy): a
    power of two of whole 128-point tiles within WIDE_SCRATCH_LIMIT that
    doubling would break, half or less the bf16 sub-chunk of the same
    widths; 524,288 points (5.7 GB) at 1024."""
    cfg, bf = _config(width, bg), _config(width, bg, dtype="bfloat16")
    plan = fused_wide.wide_plan(cfg)
    per_point = fused_wide.scratch_bytes_per_point(cfg)
    assert per_point == 2 * fused_wide.scratch_bytes_per_point(bf)
    d, ep, dp, ap = width, 112 if bg else 80, 32, 48
    assert per_point == 4 * (2 * d + d // 2 + ep + dp + ap)
    sub = plan.sub_chunk
    assert sub % plan.tile_m == 0 and sub & (sub - 1) == 0
    assert plan.scratch_bytes == sub * per_point <= fused_wide.WIDE_SCRATCH_LIMIT
    assert 2 * sub * per_point > fused_wide.WIDE_SCRATCH_LIMIT
    assert sub <= fused_wide.wide_plan(bf).sub_chunk // 2 or \
        2 * fused_wide.wide_plan(bf).sub_chunk > fused_wide.WIDE_MAX_SUB_CHUNK
    if width == 1024:
        assert sub == 524_288


@pytest.mark.parametrize("pos_dir_dim,appearance_dim", [(4, 48), (0, 0), (0, 5), (4, 0)])
@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("width", [576, 640, 1024])
def test_wide_f32_weight_grad_writes_every_element_once(width, bg, pos_dir_dim,
                                                        appearance_dim):
    """The f32 weight gradient's tiles over the wide route's dW steps (the
    jobs `fused_wide_f32.wide_f32_dw` hands the kernel pair, `f32_wg_tiles`)
    write every element of the flat packed gradient buffer exactly once:
    each tile's rows and columns inside its job, each bias once (from the
    job's first k tile); every job's operands are the saved or gradient
    tensors the plan names, at column 0 of x, and the ring reads both by
    16-byte copies (`f32_wg_copy`: rows of a multiple of 4 floats, columns
    0 or 8)."""
    cfg = _config(width, bg, pos_dir_dim, appearance_dim)
    packed = fused_mlp.pack_params(NeRF(cfg))
    plan = ftw.check_plan(packed)
    widths = dict(plan.saved)
    grads = {"g_heads": ftw.HEADS_GRAD_WIDTH, "g_a": width // 2}
    count = np.zeros(plan.total, np.int64)
    for kind, jobs in plan.steps:
        if kind != "dw":
            continue
        tiles = fused_f32.f32_wg_tiles([(j.n, j.k) for j in jobs])
        t_ = fused_f32.F32_WG_TILE
        for ji, n0, k0 in tiles:
            j = jobs[ji]
            assert n0 < j.n and k0 < j.k and j.k <= j.out_stride
            if j.x in widths:
                assert j.k <= widths[j.x]
            d_width = grads.get(j.d, width)
            assert j.d_col + j.n <= d_width
            assert fused_f32.f32_wg_copy(0, d_width, j.d_col) == 16
            assert fused_f32.f32_wg_copy(0, widths[j.x], 0) == 16
            rows = j.out_off + np.arange(n0, min(j.n, n0 + t_))[:, None] * j.out_stride
            count[(rows + np.arange(k0, min(j.k, k0 + t_))[None]).ravel()] += 1
            if j.bias_off >= 0 and k0 == 0:
                count[j.bias_off + n0:j.bias_off + min(j.n, n0 + t_)] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("m", [1, 4_097, 524_288])
@pytest.mark.parametrize("width", [64, 256, 512])
def test_narrow_f32_weight_grad_plan_is_unchanged(width, m):
    """The narrow f32 route's weight-gradient plan, built from the shared
    `f32_wg_tiles` and `f32_wg_split`, keeps its rule: the tiles of
    `fused_train.weight_grad_jobs` in (job, n0, k0) order and about
    F32_WG_CTAS CTAs of at least F32_WG_MIN_SPLIT points, in whole ring
    stages of F32_WG_CHUNK = 64 points."""
    cfg = _config(width, False)
    packed = fused_mlp.pack_params(NeRF(cfg))
    plan = fused_f32.f32_wg_plan(packed, m)
    jobs = fused_train.weight_grad_jobs(packed)
    t_ = fused_f32.F32_WG_TILE
    tiles = [(j, n0, k0) for j, job in enumerate(jobs)
             for n0 in range(0, job[1], t_) for k0 in range(0, job[3], t_)]
    splits = max(1, min(-(-fused_f32.F32_WG_CTAS // len(tiles)),
                        -(-m // fused_f32.F32_WG_MIN_SPLIT)))
    split_len = -(-max(-(-m // splits), 1) // fused_f32.F32_WG_CHUNK) * fused_f32.F32_WG_CHUNK
    assert plan.jobs == jobs and plan.tiles == tiles
    assert (plan.splits, plan.split_len) == (max(1, -(-m // split_len)), split_len)
    assert fused_f32.F32_WG_CHUNK == 64 and split_len % 64 == 0


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("width,admitted", [(576, True), (1024, True), (1088, False),
                                            (2048, False)])
def test_wide_f32_gate_and_route(width, admitted, train):
    """f32 past 512: the gate admits multiples of 64 to 1024 in eval and
    training (the JAX f32 gate's limit) and names the limit past it; on the
    card the renderer's route takes the wide kernels there."""
    cfg = _config(width, False)
    ok, why = fused_mlp.supports_fused_kernel(cfg, train)
    assert ok == admitted
    assert (why == "") == admitted
    if not admitted:
        assert "float32" in why and "<= 1024" in why
    assert rendering.mlp_route(cfg, "cuda", train) == (ok, why)


def test_render_rays_train_f32_through_the_wide_route_matches_jax(capsys, monkeypatch):
    """`render_rays(train=True)` with 640-wide fg and bg models in f32 (the
    f32 wide route through the real gate) against the JAX renderer's
    fused-Pallas training path (interpret mode) on the same Flax weights and
    rays, no jitter or noise. The route line names the wide kernel's plain
    version for every pass. Both compute in true f32, the sums in another
    order: loss rtol 1e-5, every gradient within 2e-4 of its norm."""
    monkeypatch.setattr(rendering, "_LOGGED_MLP_PATHS", set())
    hp = tiny_hparams(layer_dim=640, bg_layer_dim=640, skip_layers=[2],
                      appearance_dim=4, compute_dtype="float32")
    (jfg, pfg, tfg), (jbg, pbg, tbg) = _bundles(hp, 5)
    rays = _rays(16, seed=5)
    idx = np.arange(16, dtype=np.int32) % 5
    target = np.random.default_rng(6).uniform(size=(16, 3)).astype(np.float32)
    jset = JSettings(coarse_samples=8, fine_samples=8, use_pallas=True,
                     perturb=0.0, sigma_noise=False)

    def j_loss(fp, bp):
        res, _ = j_render_rays(jfg, jbg, fp, bp, jnp.asarray(rays), jnp.asarray(idx),
                               jset, jnp.asarray(CENTER), jnp.asarray(RADIUS),
                               train=True, key=None)
        return jnp.mean((res["rgb_fine"] - target) ** 2)

    want_v, (gf, gb) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(pfg, pbg)
    capsys.readouterr()
    tset = RenderSettings(coarse_samples=8, fine_samples=8, perturb=0.0,
                          sigma_noise=False)
    launches = _f32_launches()
    calls = ftw.train_wide_dw_plain.calls
    res, _ = render_rays(tfg, tbg, torch.from_numpy(rays), torch.from_numpy(idx).long(),
                         tset, torch.from_numpy(CENTER), torch.from_numpy(RADIUS),
                         train=True)
    loss = torch.mean((res["rgb_fine"] - torch.from_numpy(target)) ** 2)
    loss.backward()
    logged = capsys.readouterr().out
    assert logged.count("fused train (wide kernel's plain version)") == 4
    assert "eager" not in logged
    assert ftw.train_wide_dw_plain.calls > calls
    assert _f32_launches() == launches
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    for side, bundle, want in (("fg", tfg, gf), ("bg", tbg, gb)):
        got = dict(jax.tree_util.tree_leaves_with_path(_grads(bundle.module,
                                                              bundle.config)))
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            w = np.asarray(leaf, np.float64)
            diff = np.linalg.norm(np.asarray(got[path], np.float64) - w)
            assert diff <= GRAD_REL * max(np.linalg.norm(w), 1e-12), \
                f"{side} {jax.tree_util.keystr(path)}"


# ------------------------------------------------ the GEMM's 3xTF32 arithmetic


def _tf32_read(x):
    """What the tensor cores read of an f32 operand: its top 19 bits (sign,
    exponent, 10 mantissa bits), the rest truncated."""
    return (np.asarray(x, np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def _to_f32_toward_zero(x):
    """f64 -> f32 dropping the bits below the f32 result's last place (the
    tensor cores' f32 adds)."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(y, np.float32(0)), y)


def _gemm_3xtf32(xs, ws, chain_steps):
    """The f32 wide GEMM's sums on the CPU, in its order: the segments
    (M, K_s) and their weight columns (N, K_s) each zero-padded to whole
    k-stages of fused_wide_f32.GEMM_K columns (TMA's zero fill) and
    concatenated; hi is an operand as the tensor cores read it (truncated to
    TF32), lo the rest x - hi read the same way; per 8-column k-step the
    products lo*hi, hi*lo and hi*hi, each summed exactly and added into the
    running chain with the bits below the chain's last place dropped; a
    chain of `chain_steps` k-steps runs from zero, then is added into the f32
    totals (round to nearest)."""
    def padded(parts):
        k = fused_wide_f32.GEMM_K
        return np.concatenate([np.pad(p, ((0, 0), (0, -p.shape[1] % k))) for p in parts], 1)

    x, w = padded(xs), padded(ws)
    xh, wh = _tf32_read(x), _tf32_read(w)
    xl, wl = _tf32_read(x - xh), _tf32_read(w - wh)
    acc = np.zeros((x.shape[0], w.shape[0]), np.float32)
    for c0 in range(0, x.shape[1], 8 * chain_steps):
        ch = np.zeros_like(acc)
        for k0 in range(c0, min(c0 + 8 * chain_steps, x.shape[1]), 8):
            ks = slice(k0, k0 + 8)
            for a, b in ((xl, wh), (xh, wl), (xh, wh)):
                ch = _to_f32_toward_zero(ch.astype(np.float64)
                                         + a[:, ks].astype(np.float64) @ b[:, ks].T)
        acc = acc + ch
    return acc


@pytest.mark.parametrize("form", ["layer", "masked dx"])
@pytest.mark.parametrize("widths", [(1024,), (80, 1024), (1024, 27, 48)],
                         ids=["k1024", "skip", "three segments"])
def test_gemm_3xtf32_holds_f32_accuracy_and_one_pass_tf32_does_not(widths, form):
    """The GEMM's arithmetic (`_gemm_3xtf32`: the kernel's split, 8-column
    k-steps, chains of GEMM_CHAIN k-stages, f32 totals) on seeded rows at
    K = 1024, a skip layer's [enc | h] and the dir_a layer's three segments
    [final | dir | app] (zero columns past each segment's width): within
    1e-5 of the f64 products (relative, Frobenius), the card's limit
    against f64 (chip_smoke.py GEMM_F64_TOL); one-pass TF32 products (each
    operand read once, summed exactly) miss it. The layer form reads ReLU
    activations; the dX form signed, ReLU-masked gradient rows."""
    rng = np.random.default_rng(sum(widths) + len(form))
    m, n = 48, 24
    if form == "layer":
        xs = [np.maximum(rng.normal(size=(m, k)), 0).astype(np.float32) for k in widths]
    else:
        xs = [(rng.normal(size=(m, k)) * (rng.random((m, k)) > 0.5)).astype(np.float32)
              for k in widths]
    ws = [(rng.normal(size=(n, k)) / np.sqrt(sum(widths))).astype(np.float32) for k in widths]
    want = sum(x.astype(np.float64) @ w.T.astype(np.float64) for x, w in zip(xs, ws))
    steps = fused_wide_f32.GEMM_CHAIN * fused_wide_f32.GEMM_K // 8
    got = _gemm_3xtf32(xs, ws, steps)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel
    one_pass = sum(_tf32_read(x).astype(np.float64) @ _tf32_read(w).T.astype(np.float64)
                   for x, w in zip(xs, ws))
    rel_one = np.linalg.norm(one_pass - want) / np.linalg.norm(want)
    assert rel_one > 1e-5 > rel, (rel_one, rel)


def test_gemm_split_is_exact_and_its_rest_loses_under_2_pow_20():
    """hi + lo = x exactly for the kernel's split (hi = x as the tensor cores
    read it, lo = x - hi, tf32_rest in wide_f32.cu), |lo| < 2^-10 |x|, and
    lo as the tensor cores read it loses < 2^-20 |x|: seeded normals over 60
    binades, signed."""
    rng = np.random.default_rng(25)
    x = (rng.normal(size=20_000) * 2.0 ** rng.integers(-30, 30, 20_000)).astype(np.float32)
    hi = _tf32_read(x)
    lo = x - hi
    np.testing.assert_array_equal(hi.astype(np.float64) + lo, x.astype(np.float64))
    assert (np.abs(lo) < 2.0 ** -10 * np.abs(x)).all()
    assert (np.abs(lo - _tf32_read(lo)) < 2.0 ** -20 * np.abs(x)).all()


@pytest.mark.parametrize("grid", [1, 7, 132, 10_000])
@pytest.mark.parametrize("m,n", [(1, 5), (37, 576), (1_000, 1_024), (524_288, 1_024),
                                 (20_011, 48), (786_432, 512)])
def test_gemm_persistent_walk_covers_every_tile_once(m, n, grid):
    """`gemm_walk` (the kernel's walk: CTA b takes tiles b, b + grid, ...)
    gives every 128 x 128 output tile to exactly one CTA, the column tiles
    of one point tile on neighbouring CTAs; `gemm_grid` never launches more
    CTAs than tiles or than the card holds."""
    tm, tn = fused_wide_f32.GEMM_TILE_M, fused_wide_f32.GEMM_TILE_N
    ntm, ntn = -(-m // tm), -(-n // tn)
    walk = fused_wide_f32.gemm_walk(m, n, grid)
    tiles = [t for cta in walk for t in cta]
    assert len(tiles) == len(set(tiles)) == ntm * ntn == fused_wide_f32.gemm_tiles(m, n)
    assert set(tiles) == {(i * tm, j * tn) for i in range(ntm) for j in range(ntn)}
    if grid >= ntn:
        assert [walk[b][0] for b in range(ntn)] == [(0, j * tn) for j in range(ntn)]
    launched = fused_wide_f32.gemm_grid(m, n, grid)
    assert 1 <= launched <= min(grid, ntm * ntn)


@pytest.mark.parametrize("n,cols,want", [(1024, 1024, (1024, 1024)), (1024, 1104, (1024, 1104)),
                                         (512, 1102, (512, 1104)), (5, 512, (5, 512)),
                                         (1024, 75, (1024, 76))])
def test_gemm_wlo_scratch_holds_the_used_rows_at_a_16_byte_pitch(n, cols, want):
    """The scratch for W's TF32 rests (`gemm_wlo_shape`): the n rows the
    GEMM reads, each W's columns padded to 16 bytes (TMA's row pitch)."""
    assert fused_wide_f32.gemm_wlo_shape(n, cols) == want


def test_gemm_plan_fits_one_cta_an_sm():
    """The plan the kernel checks: 128 x 128 tiles, 32-column k-stages (128
    bytes of f32, the swizzle's row), 4 stages of three 16 KB boxes (A, W,
    W's rests), chains of 2 k-stages; its shared memory fits the 232,448
    bytes a CTA may take on an H100."""
    plan = fused_wide_f32.gemm_plan_ints()
    assert plan == [128, 128, 32, 4, 2, fused_wide_f32.GEMM_SMEM]
    assert fused_wide_f32.GEMM_K * 4 == 128
    assert fused_wide_f32.GEMM_SMEM == 4 * 3 * 16_384 + 64 + 1024 <= 232_448


@pytest.mark.parametrize("source,itemsize", [("eval_wide", 2), ("wide_f32", 4)])
def test_encode_launcher_matches_the_host_plan(source, itemsize):
    """What each encode launcher checks against the host's plan: its CTA
    (`ENCODE_THREADS` = ENCODE_WARPS warps), its shared-memory ceiling, and
    its own `encode_smem` (the C expression, evaluated) against
    `fused_wide.encode_smem` at the rows' element size, over tiles 32-128,
    xyz_dim 1-4 and the frequencies' padded widths, with dirs and without."""
    import re
    from pathlib import Path

    from tests.test_torch_eval_wide import cu_constants

    c = cu_constants(source)
    assert c["ENCODE_THREADS"] == 32 * fused_wide.ENCODE_WARPS
    assert c["ENCODE_MAX_SMEM"] == fused_wide.ENCODE_MAX_SMEM
    src = (Path(fused_wide.__file__).parent / "csrc" / f"{source}.cu").read_text()
    body = re.search(r"int encode_smem\(int tile, int d, int ep, int dp\) \{\s*return ([^;]+);",
                     src).group(1)
    expr = re.sub(r"\((\w+) \? (.+) : 0\)", r"((\2) if \1 else 0)", body)
    for tile in (32, 64, 128):
        for d in (1, 2, 3, 4):
            for ep in (16, 80, 112, 400):
                for dp in (0, 32, 48):
                    env = dict(tile=tile, d=d, ep=ep, dp=dp)
                    assert eval(expr, {}, env) == fused_wide.encode_smem(  # noqa: S307
                        tile, d, ep, dp, itemsize), (env, expr)


def _gemm_operands(case):
    """Operands of one GEMM call on CPU tensors, `case` breaking one rule."""
    from mega_nerf_tpu_torch.render.fused_train_wide import DX_MASK, DX_MASK_SIGMA

    m, n = 40, 24
    big = torch.zeros((m, 1032))
    xs = [torch.zeros((m, 80)), big[:, :1024]]
    w = torch.zeros((n, 1104))
    kw = dict(xs=xs, w=w, n=n, mode=fused_wide_f32.EPI_LAYER_RELU,
              out=torch.zeros((m, n)), cols=[0, 80], bias=torch.zeros(n))
    if case == "bf16 segment":
        kw["xs"] = [xs[0].bfloat16(), xs[1]]
    elif case == "segment base off 16 B":
        kw["xs"] = [xs[0], big[:, 1:1025]]
    elif case == "row pitch off 16 B":
        kw["xs"] = [torch.zeros((m, 82))[:, :80], xs[1]]
    elif case == "segment past W":
        kw["cols"] = [0, 96]
    elif case == "column off 16 B":
        kw["cols"] = [2, 80]
    elif case == "weights off 16 B":
        kw["w"] = torch.zeros((n, 1105))[:, 1:]
    elif case == "too few weight rows":
        kw["n"], kw["out"], kw["bias"] = n + 1, torch.zeros((m, n + 1)), torch.zeros(n + 1)
    elif case == "four segments":
        kw["xs"], kw["cols"] = [xs[0]] * 4, [0, 80, 160, 240]
    elif case == "no bias":
        kw["bias"] = None
    elif case == "no mask":
        kw["mode"] = DX_MASK
    elif case == "sigma without g_heads":
        kw.update(mode=DX_MASK_SIGMA, mask=torch.zeros((m, n)), w_sigma=torch.zeros(n))
    elif case == "strided out":
        kw["out"] = torch.zeros((m, 2 * n))[:, :n]
    elif case == "unknown epilogue":
        kw["mode"] = 6
    return kw


@pytest.mark.parametrize("case", [
    "bf16 segment", "segment base off 16 B", "row pitch off 16 B", "segment past W",
    "column off 16 B", "weights off 16 B", "too few weight rows", "four segments",
    "no bias", "no mask", "sigma without g_heads", "strided out", "unknown epilogue"])
def test_gemm_refuses_what_tma_and_its_epilogues_cannot_take(case):
    """`check_gemm_operands` (run by `wide_f32_gemm` before any launch)
    takes f32 segments and weights with 16-byte aligned bases and row
    pitches inside W's columns, and refuses each broken rule with a
    ValueError; the wrapper itself refuses CPU tensors (no plain fallback:
    `wide_f32_layer` / `wide_f32_dx` pick the plain version by device)."""
    fused_wide_f32.check_gemm_operands(**_gemm_operands("good"))
    with pytest.raises(ValueError):
        fused_wide_f32.check_gemm_operands(**_gemm_operands(case))
    launches = fused_wide_f32.wide_f32_gemm.launches
    with pytest.raises(ValueError):
        fused_wide_f32.wide_f32_gemm(**_gemm_operands("good"))
    assert fused_wide_f32.wide_f32_gemm.launches == launches
