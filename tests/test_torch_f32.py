"""The f32-compute kernels' host side, on the CPU (`--compute_dtype float32`).

The port's wrappers on CPU tensors (their plain versions, which the f32
kernels of `csrc/eval_f32.cu` and `csrc/train_f32.cu` are held against on
the card) against the JAX package's Pallas kernels in interpret mode, on the
same Flax weights (carried across by `state_from_flax_params`) and the same
numpy-seeded points, appearance rows and sigma noise:

- eval: `fused_mlp.fused_nerf_eval` against `pallas_mlp.fused_nerf_eval`
  (`_mlp_kernel`): 5e-5 absolute, the forward limit of PERF.md section 2;
- training forward: `fused_train.fused_nerf_train_fwd` with noise against
  the output of `pallas_train.fused_nerf_train_apply` (`_train_fwd_kernel`):
  5e-5 absolute;
- backward: `fused_train.fused_nerf_train_apply` through autograd
  (`train_bwd_data`, `weight_grad`) against `jax.value_and_grad` through
  the custom VJP (`_train_bwd_kernel`): every parameter's gradient and d_app
  within 2e-4 of the JAX tensor's norm (PERF.md section 2's gradient limit).

Cases: widths 48 (no dirs), 64 (the bg model, xyz_dim 4) and 128 (no
appearance), a skip layer in each; 200 points, not a multiple of the JAX
block of 256.
Also the f32 plans (every width to 512 fits a CTA's 227 KB, 513 and 528
are refused), the forward's launch tables and W-rests cache, and the 3xTF32
arithmetic of the forward and of the weight gradient in numpy against f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
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
from mega_nerf_tpu_torch.render import fused_f32, fused_mlp, fused_train
from tests.test_models import tiny_hparams

N, BLOCK, COUNT = 200, 256, 5
FWD_ATOL = 5e-5
GRAD_REL = 2e-4

CASES = {  # name: (hparams, bg)
    "w48_no_dirs": (dict(layer_dim=48, layers=4, skip_layers=[2], pos_xyz_dim=10,
                         pos_dir_dim=0, appearance_dim=8), False),
    "w64_bg": (dict(layer_dim=64, layers=4, skip_layers=[2], pos_xyz_dim=6,
                    pos_dir_dim=4, appearance_dim=8), True),
    "w128_no_app": (dict(layer_dim=128, layers=3, skip_layers=[1], pos_xyz_dim=4,
                         pos_dir_dim=4, appearance_dim=0), False),
}


def _setup(name):
    kw, bg = CASES[name]
    hp = tiny_hparams(compute_dtype="float32", bg_layer_dim=kw["layer_dim"], **kw)
    jb = (j_make_bg_nerf if bg else j_make_nerf)(hp, COUNT)
    params = jax.device_get(jax.jit(jb.init)(jax.random.key(3)))
    cfg = nerf_config_from_hparams(hp, COUNT, kw["layer_dim"], 4 if bg else 3)
    assert cfg.dtype == torch.float32 and jb.config.dtype == jnp.float32
    module = NeRF(cfg)
    module.load_state_dict(state_from_flax_params(cfg, params))
    rng = np.random.default_rng(4)
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


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_eval_wrapper_matches_pallas_interpret(name):
    """The eval wrapper on CPU f32 tensors (its plain version, one call)
    against `_mlp_kernel` in interpret mode: 5e-5 absolute."""
    jb, params, module, cfg, xyz, dirs, app, _, _ = _setup(name)
    m_pad = -(-N // BLOCK) * BLOCK
    pad = lambda a: None if a is None else jnp.asarray(  # noqa: E731
        np.concatenate([a, np.repeat(a[-1:], m_pad - N, 0)]))
    jp = j_pack(jb.config, params)
    want = jax.jit(lambda x, d, a: j_eval(jp, x, d, a, block=BLOCK, interpret=True))(
        pad(xyz), pad(dirs), pad(app))[:N]
    packed = fused_mlp.pack_params(module)
    assert all(w.dtype == torch.float32 for w in packed.mats)
    calls = fused_mlp.fused_nerf_eval_plain.calls
    launches = [f.launches for f in fused_f32.F32_KERNELS]
    got = fused_mlp.fused_nerf_eval(packed, _t(xyz), _t(dirs), _t(app))
    assert fused_mlp.fused_nerf_eval_plain.calls == calls + 1
    assert [f.launches for f in fused_f32.F32_KERNELS] == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_train_wrappers_match_pallas_interpret(name):
    """The training forward with sigma noise against the custom VJP's
    output (5e-5 absolute), then the backward through the port's autograd
    Function (the backward-data and weight-gradient wrappers' plain
    versions, one call each) against `jax.value_and_grad` through
    `_train_bwd_kernel`: every parameter gradient and d_app within 2e-4 of
    the JAX tensor's norm; the loss sum(out * probe) within the forward
    limit carried through the probe (5e-5 sum |probe|)."""
    jb, params, module, cfg, xyz, dirs, app, noise, probe = _setup(name)

    def j_loss(p, a):
        out = j_train_apply(jb.config, p, jnp.asarray(xyz), _j(dirs), a,
                            jnp.asarray(noise)[:, None], block=BLOCK, interpret=True,
                            dir_pack=False)
        return jnp.sum(out * probe), out

    (want_v, want_out), (want_g, want_dapp) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(params, _j(app))

    packed = fused_mlp.pack_params(module)
    with torch.no_grad():
        out, act = fused_train.fused_nerf_train_fwd(packed, _t(xyz), _t(dirs), _t(app),
                                                    _t(noise))
    assert act.dtype == torch.float32
    assert act.shape == (N, fused_train.act_layout(packed)["width"])
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0, atol=FWD_ATOL)

    calls = (fused_train.train_bwd_data_plain.calls, fused_train.weight_grad_plain.calls)
    app_t = None if app is None else _t(app).requires_grad_()
    got = fused_train.fused_nerf_train_apply(module, _t(xyz), _t(dirs), app_t, _t(noise))
    loss = (got * _t(probe)).sum()
    loss.backward()
    assert (fused_train.train_bwd_data_plain.calls,
            fused_train.weight_grad_plain.calls) == (calls[0] + 1, calls[1] + 1)
    assert abs(loss.item() - float(want_v)) <= FWD_ATOL * np.abs(probe).sum()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in module.named_parameters()}
    got_g = dict(jax.tree_util.tree_leaves_with_path(flax_params_from_state(cfg, grads)))
    flat_w = jax.tree_util.tree_leaves_with_path(want_g)
    assert len(flat_w) == len(got_g)
    for path, leaf in flat_w:
        name_ = jax.tree_util.keystr(path)
        a, b = np.asarray(got_g[path]), np.asarray(leaf)
        assert np.linalg.norm(a - b) <= GRAD_REL * np.linalg.norm(b) + 1e-7, name_
    if app is not None:
        a, b = app_t.grad.numpy(), np.asarray(want_dapp)
        assert np.linalg.norm(b) > 0
        assert np.linalg.norm(a - b) <= GRAD_REL * np.linalg.norm(b), "d_app"


def _cfg(width, bg, **kw):
    return NeRFConfig(xyz_dim=4 if bg else 3, layer_dim=width, pos_xyz_dim=12,
                      pos_dir_dim=4, layers=8, skip_layers=(4,), appearance_dim=48,
                      compute_dtype="float32", **kw)


@pytest.mark.parametrize("bg", [False, True])
def test_f32_plans_fit_every_width_to_512(bg):
    """The f32 backward-data plan (the forward's CTA, f32_forward.cuh) at
    every width 16 .. 512 (in steps of 16) within 232,448 B with the 1024 B
    of alignment slack: 64 points with one gradient tile written in place
    (x == y) to width 256, 32 points with two tiles past it; the ring at
    offset 0 (1024-aligned for TMA's 128-byte swizzle and wgmma's
    descriptors) in 32 KB stages (a box of 128 transposed-W rows x 32
    columns and its rests), at least 2 everywhere: 4 at the paper width
    (256, where the branch rows and d_a share the gradient tile), 3 at 512;
    tiles of `width + 4` floats a point (4 mod 8), then the heads' four
    derivatives a point, the full and empty barriers on 8 B past them."""
    for width in range(16, 513, 16):
        cfg = _cfg(width, bg)
        plan = fused_f32.f32_bwd_plan(cfg)
        o, tm = plan.offsets, plan.tm
        assert plan.smem_bytes <= fused_f32.F32_SMEM_LIMIT == 232_448
        assert tm == (64 if width <= 256 else 32)
        assert (o["x"] == o["y"]) == (width <= 256)
        assert o["ring"] == 0 and fused_f32.F32_FWD_STAGE == 32 * 1024
        assert o["x"] == plan.stages * fused_f32.F32_FWD_STAGE and plan.stages >= 2
        if width in (256, 512):
            assert plan.stages == (4 if width == 256 else 3), (width, plan.stages)
        tile = 4 * tm * (width + 4)
        assert (width + 4) % 8 == 4
        assert o["heads"] - o["y"] == tile and (o["y"] == o["x"] or o["y"] - o["x"] == tile)
        assert o["bar"] == o["heads"] + 16 * tm and o["bar"] % 8 == 0
        assert all(v % 16 == 0 for v in o.values())
        assert list(o) == ["ring", "x", "y", "heads", "bar"]
        assert plan.smem_bytes == o["bar"] + 2 * 8 * plan.stages + 1024


@pytest.mark.parametrize("bg", [False, True])
def test_f32_fwd_plan_fits_every_width_to_512(bg):
    """The f32 forward's plan (f32_forward.cuh) at every width 16 .. 512 (in
    steps of 16): within 232,448 B with the 1024 B of alignment slack; 64
    points written in place (x == y) to width 256, 32 points with two
    activation tiles past it; the ring at offset 0 (1024-aligned, as TMA's
    128-byte swizzle and wgmma's descriptors need) in stages of 32 KB (a
    W box of 128 rows x 32 columns and its rests), each a multiple of 1024
    B; 4 stages at the paper width fg and bg, at least 2 everywhere; the
    tiles of `width + 4` columns a point (4 mod 8: the fragment reads hit
    32 banks) on 16 B; dir enc and app in the encode's room, then sigma a
    point, the full and empty barriers on 8 B past all of it."""
    for width in range(16, 513, 16):
        cfg = _cfg(width, bg)
        plan = fused_f32.f32_fwd_plan(cfg)
        o, tm = plan.offsets, plan.tm
        assert plan.smem_bytes <= fused_f32.F32_SMEM_LIMIT == 232_448
        assert tm == (64 if width <= 256 else 32)
        assert (o["x"] == o["y"]) == (width <= 256)
        assert o["ring"] == 0 and fused_f32.F32_FWD_STAGE == 32 * 1024
        assert o["x"] == plan.stages * fused_f32.F32_FWD_STAGE and plan.stages >= 2
        if width == 256:
            assert plan.stages == 4
        act = 4 * tm * (width + 4)
        assert (width + 4) % 8 == 4
        assert o["enc"] - o["y"] == act and (o["y"] == o["x"] or o["y"] - o["x"] == act)
        ep, dp, ap = (fused_mlp._round_up(v, 16) for v in (cfg.enc_in, cfg.dir_in,
                                                             cfg.appearance_dim))
        assert o["dir"] == o["enc"] and o["app"] - o["dir"] == 4 * tm * (dp + 4)
        room = max(4 * tm * (ep + 4), 4 * tm * (dp + 4 + ap + 4))
        assert o["sig"] >= o["enc"] + room and o["bar"] >= o["sig"] + 4 * tm
        assert o["bar"] % 8 == 0
        assert all(v % 16 == 0 for v in o.values())
        assert plan.smem_bytes == o["bar"] + 2 * 8 * plan.stages + 1024


def test_f32_forward_reads_the_packed_matrices_and_cached_rests(monkeypatch):
    """The f32 forward wrappers hand the kernels the packed (N, Ktot)
    matrices themselves (K-major, as TF32 wgmma reads B; no transposed
    copy) and, beside them, their TF32 rests (`w_rests`: x - trunc(x), the
    split's lo, exactly `_tf32_trunc`'s complement), made once per set of
    weights: a second launch reuses the same rests tensors, and after an
    in-place weight update the next launch gets rests made from the new
    weights. The plan's ints and the (N, Ktot) shapes go with them. A
    stand-in library records the tables (no card here)."""
    cfg = _cfg(64, False)
    packed = fused_mlp.pack_tensors(cfg, {k: v for k, v in NeRF(cfg).named_parameters()})
    seen = []

    class Lib:
        def eval_f32_launch(self, ptrs, dims, plan, shapes, rests, stream):
            seen.append((list(ptrs), list(plan), list(shapes), list(rests)))
            return 0

        def train_f32_fwd_launch(self, ptrs, dims, plan, shapes, rests, extra, cols, stream):
            return self.eval_f32_launch(ptrs, dims, plan, shapes, rests, stream)

    monkeypatch.setattr(fused_f32, "_eval_lib", Lib)
    monkeypatch.setattr(fused_f32, "_train_lib", Lib)
    monkeypatch.setattr(fused_f32, "_stream", lambda t: None)
    m = 100
    xyz, dirs = torch.zeros((m, 3)), torch.zeros((m, 3))
    app = torch.zeros((m, cfg.appearance_dim))
    launches = [f.launches for f in fused_f32.F32_KERNELS]
    fused_f32.fused_nerf_eval_f32(packed, xyz, dirs, app)
    first = fused_f32.w_rests(packed)
    fused_f32.fused_nerf_train_fwd_f32(packed, xyz, dirs, app, None)
    assert fused_f32.w_rests(packed) is first
    with torch.no_grad():
        for w in packed.mats:
            w.mul_(1.0 + 2.0 ** -15)
    fused_f32.fused_nerf_eval_f32(packed, xyz, dirs, app)
    fresh = fused_f32.w_rests(packed)
    assert [f.launches for f in fused_f32.F32_KERNELS] == [launches[0] + 2,
                                                           launches[1] + 1, *launches[2:]]
    plan = fused_f32.f32_fwd_plan(cfg)
    for ptrs, ints, shapes, _ in seen:
        assert ptrs[8::2][:len(packed.mats)] == [w.data_ptr() for w in packed.mats]
        assert ints == fused_f32._fwd_plan_ints(plan)
        assert shapes == [v for w in packed.mats for v in w.shape]
    assert seen[0][3] == seen[1][3] == [r.data_ptr() for r in first]
    assert seen[2][3] == [r.data_ptr() for r in fresh]
    for w, old, new in zip(packed.mats, first, fresh):
        want = w.numpy() - _tf32_trunc(w.numpy())
        np.testing.assert_array_equal(new.numpy(), want)
        assert new.shape == w.shape and new.is_contiguous()
        assert not np.array_equal(old.numpy(), new.numpy())
    assert not hasattr(fused_f32, "transposed")


def test_f32_backward_reads_the_transposed_matrices_and_cached_rests(monkeypatch):
    """The f32 backward-data wrapper hands the kernel the transposed (Ktot,
    N) matrices (`fused_train.transposed_weights`: K-major for the
    backward's reduction over N, as TF32 wgmma reads B; dir_a's columns
    padded to branch_k) and, beside them, their TF32 rests (`t_rests`: x -
    trunc(x), exactly `_tf32_trunc`'s complement), made once per set of
    weights: a second launch reuses the same tensors, and after an in-place
    weight update the next launch gets both made from the new weights. The
    plan's ints and the (Ktot, N) shapes go with them. A stand-in library
    records the tables (no card here)."""
    cfg = _cfg(64, False)
    packed = fused_mlp.pack_tensors(cfg, {k: v for k, v in NeRF(cfg).named_parameters()})
    seen = []

    class Lib:
        def train_f32_bwd_launch(self, ptrs, dims, plan, shapes, rests, stream):
            seen.append((list(ptrs), list(plan), list(shapes), list(rests)))
            return 0

    monkeypatch.setattr(fused_f32, "_train_lib", Lib)
    monkeypatch.setattr(fused_f32, "_stream", lambda t: None)
    m = 100
    act = torch.zeros((m, fused_train.act_layout(packed)["width"]))
    g = torch.zeros((m, 4))
    launches = [f.launches for f in fused_f32.F32_KERNELS]
    fused_f32.train_bwd_data_f32(packed, act, g, None)
    first = fused_f32.t_rests(packed)
    fused_f32.train_bwd_data_f32(packed, act, g, None)
    assert fused_f32.t_rests(packed) is first
    with torch.no_grad():
        for w in packed.mats:
            w.mul_(1.0 + 2.0 ** -15)
    fused_f32.train_bwd_data_f32(packed, act, g, None)
    fresh = fused_f32.t_rests(packed)
    assert [f.launches for f in fused_f32.F32_KERNELS] == [*launches[:2], launches[2] + 3,
                                                           launches[3]]
    plan = fused_f32.f32_bwd_plan(cfg)
    for (ptrs, ints, shapes, rests), (wts, los) in zip(seen, (first, first, fresh)):
        assert ptrs[9:] == [w.data_ptr() for w in wts]
        assert rests == [r.data_ptr() for r in los]
        assert ints == fused_f32._bwd_plan_ints(plan)
        assert shapes == [v for w in wts for v in w.shape]
    for old, new in zip(first[0] + first[1], fresh[0] + fresh[1]):
        assert not np.array_equal(old.numpy(), new.numpy())
    for w, want, lo in zip(fresh[0], fused_train.transposed_weights(packed), fresh[1]):
        np.testing.assert_array_equal(w.numpy(), want.numpy())
        np.testing.assert_array_equal(lo.numpy(), w.numpy() - _tf32_trunc(w.numpy()))
        assert w.is_contiguous() and lo.is_contiguous() and lo.shape == w.shape
    kb = fused_train.branch_k(cfg)
    assert [tuple(w.shape) for w in fresh[0]] == [(w.shape[1], w.shape[0]) for w in
                                                  packed.mats[:-1]] + [
        (packed.mats[-1].shape[1], kb)]


@pytest.mark.parametrize("width", [513, 528, 1024])
def test_f32_plans_refuse_past_512(width):
    """Past width 512 the f32 kernels take nothing (513: not a multiple of
    16; 528 and 1024: the wide route, bf16 only)."""
    cfg = _cfg(width, False)
    for plan in (lambda: fused_f32.f32_fwd_plan(cfg), lambda: fused_f32.f32_bwd_plan(cfg)):
        with pytest.raises(NotImplementedError):
            plan()


@pytest.mark.parametrize("m", [1, 4_097, 524_288, 8_388_608])
def test_f32_weight_grad_plan_covers_the_points_once(m):
    """The f32 weight gradient's plan at the paper width: every output of
    every job in exactly one tile, the point ranges partition [0, M) in
    whole ring stages of F32_WG_CHUNK = 64 points (the last may end early),
    about F32_WG_CTAS CTAs or fewer."""
    cfg = _cfg(256, False)
    packed = fused_mlp.pack_tensors(cfg, {k: v for k, v in NeRF(cfg).named_parameters()})
    plan = fused_f32.f32_wg_plan(packed, m)
    hits = {}
    for j, n0, k0 in plan.tiles:
        d_col, n, x_col, k, *_ = plan.jobs[j]
        for i in range(n0, min(n, n0 + fused_f32.F32_WG_TILE)):
            hits[(j, i, k0)] = hits.get((j, i, k0), 0) + 1
    want = {(j, i, k0) for j, (_, n, _, k, *_) in enumerate(plan.jobs)
            for i in range(n) for k0 in range(0, k, fused_f32.F32_WG_TILE)}
    assert set(hits) == want and set(hits.values()) == {1}
    assert fused_f32.F32_WG_CHUNK == 64
    assert plan.split_len % fused_f32.F32_WG_CHUNK == 0
    assert (plan.splits - 1) * plan.split_len < m <= plan.splits * plan.split_len
    assert len(plan.tiles) * plan.splits <= max(fused_f32.F32_WG_CTAS + len(plan.tiles),
                                                len(plan.tiles))


def _tf32_rna(x):
    """The weight-gradient kernel's hi (train_f32.cu split_tf32): f32 -> the
    nearest TF32 value (10 mantissa bits), ties away from zero, by an
    integer add and mask on the bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(x):
    """What the tensor cores read of an f32 operand: its top 19 bits (the
    kernel's lo is passed unrounded)."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_split_rounds_to_nearest_ties_away():
    """hi = the kernel's integer rounding equals cvt.rna.tf32.f32's rule,
    written here independently in f64 (the 11 leading bits of |x|, rounded
    half up in magnitude), on seeded normals over 60 binades and on the ties
    1 + 2^-11, 1 + 3 2^-11, (1 + 2^-11) 2^-12 and their negatives (each
    rounded up in magnitude); hi + (x - hi) is x exactly
    and |x - hi| <= 2^-11 |x|; reading x - hi as TF32 loses < 2^-10 of it."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=20_000) * 2.0 ** rng.integers(-30, 30, 20_000)).astype(np.float32)
    ties = np.array([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, (1 + 2.0 ** -11) * 2.0 ** -12],
                    np.float32)
    x = np.concatenate([x, ties, -ties])
    mant, exp = np.frexp(np.abs(x.astype(np.float64)))  # |x| = mant 2^exp, mant in [0.5, 1)
    want = np.sign(x) * np.floor(mant * 2.0 ** 11 + 0.5) * 2.0 ** (exp - 11)
    hi = _tf32_rna(x)
    np.testing.assert_array_equal(hi.astype(np.float64), want)
    np.testing.assert_array_equal(hi[-6:], np.array(
        [1 + 2.0 ** -10, 1 + 2.0 ** -9, (1 + 2.0 ** -10) * 2.0 ** -12,
         -(1 + 2.0 ** -10), -(1 + 2.0 ** -9), -(1 + 2.0 ** -10) * 2.0 ** -12], np.float32))
    lo = x - hi
    np.testing.assert_array_equal(hi.astype(np.float64) + lo, x.astype(np.float64))
    assert (np.abs(lo) <= 2.0 ** -11 * np.abs(x)).all()
    # The tensor cores' truncation of lo loses less than 2^-10 of lo, 2^-21 of x.
    assert (np.abs(lo - _tf32_trunc(lo)) <= 2.0 ** -10 * np.abs(lo)).all()


def _wg_sums_3xtf32(d, x, split_len, stage):
    """The f32 weight gradient's arithmetic on the CPU: per point range of
    `split_len`, per stage of `stage` points a chain from zero taking each
    8-point k-step's lo*hi, hi*lo and hi*hi products (each k-step's 8
    products summed in f64 and rounded to f32 once, the tensor cores' sums
    being wider than f32; the chain's adds in f32), each chain added into
    the f32 totals; the ranges' totals added in range order."""
    dh, xh = _tf32_rna(d), _tf32_rna(x)
    dl, xl = _tf32_trunc(d - dh), _tf32_trunc(x - xh)
    out = None
    for r0 in range(0, d.shape[0], split_len):
        acc = np.zeros((d.shape[1], x.shape[1]), np.float32)
        for s0 in range(r0, min(r0 + split_len, d.shape[0]), stage):
            ch = np.zeros_like(acc)
            for k0 in range(s0, min(s0 + stage, d.shape[0]), 8):
                ks = slice(k0, k0 + 8)
                for a, b in ((dl, xh), (dh, xl), (dh, xh)):
                    ch = ch + (a[ks].T.astype(np.float64) @ b[ks]).astype(np.float32)
            acc = acc + ch
        out = acc if out is None else out + acc
    return out


def test_3xtf32_weight_grad_holds_f32_accuracy_and_one_pass_tf32_does_not():
    """The kernel's 3xTF32 products in its order (`_wg_sums_3xtf32`: two
    point ranges, 64-point stages, 8-point k-steps) on ReLU-masked gradient
    rows d and ReLU activation rows x, seeded: dW = d^T x within 1e-5 of
    the f64 sums (relative, Frobenius), as the card's 1e-5 limit against
    f64 asks; one-pass TF32 products (hi*hi only, summed in f64) miss that
    bound."""
    rng = np.random.default_rng(12)
    m, n, k = 8_192, 16, 24
    d = (rng.normal(size=(m, n)) * (rng.normal(size=(m, n)) > 0)).astype(np.float32)
    x = np.maximum(rng.normal(size=(m, k)), 0).astype(np.float32)
    want = d.T.astype(np.float64) @ x.astype(np.float64)
    got = _wg_sums_3xtf32(d, x, 4_096, fused_f32.F32_WG_CHUNK)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel
    one_pass = _tf32_rna(d).T.astype(np.float64) @ _tf32_rna(x).astype(np.float64)
    rel_one = np.linalg.norm(one_pass - want) / np.linalg.norm(want)
    assert rel_one > 1e-5 > rel, (rel_one, rel)


@pytest.mark.parametrize("ptr,ld,col,want", [
    (0, 2592, 0, 16), (4096, 2440, 2432, 16), (0, 2440, 2433, 4), (0, 150, 0, 4),
    (4, 2592, 0, 4), (8, 16, 8, 4), (0, 16, 8, 16), (2, 16, 0, None)])
def test_f32_weight_grad_copy_width_rule(ptr, ld, col, want):
    """The ring's copy width for an operand (`f32_wg_copy`): 16 B where the
    rows start on 16 B (address, row width in floats a multiple of 4, the
    job's first column a multiple of 4), else 4 B; an address off 4 B (no
    f32 row) raises at plan time."""
    if want is None:
        with pytest.raises(ValueError):
            fused_f32.f32_wg_copy(ptr, ld, col)
    else:
        assert fused_f32.f32_wg_copy(ptr, ld, col) == want


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("width", [64, 256, 512])
def test_f32_weight_grad_plan_copy_widths(width, bg):
    """The job table the wrapper builds for the narrow plan on its gradient
    and saved rows (`f32_wg_job_rows`): every job reads both by 16-byte
    copies but the rgb head's, whose gradient column (heads + 1) is off
    16 B and takes 4-byte copies; a view whose rows start 4 B into a row
    takes 4-byte copies."""
    cfg = _cfg(width, bg)
    packed = fused_mlp.pack_tensors(cfg, {k: v for k, v in NeRF(cfg).named_parameters()})
    plan = fused_f32.f32_wg_plan(packed, 1_000)
    heads = fused_train.grad_layout(packed)["heads"]
    m = 40
    act = torch.zeros((m, fused_train.act_layout(packed)["width"]))
    grad = torch.zeros((m, fused_train.grad_layout(packed)["width"]))
    rows = fused_f32.f32_wg_job_rows([fused_f32.WgJob(grad, act, *job) for job in plan.jobs])
    both = fused_f32.WG_COPY_D16 | fused_f32.WG_COPY_X16
    assert [r[-1] for r in rows] == [fused_f32.WG_COPY_X16 if job[0] == heads + 1 else both
                                     for job in plan.jobs]
    assert sum(job[0] == heads + 1 for job in plan.jobs) == 1
    view = fused_f32.WgJob(grad[:, 1:], act, 0, 3, 0, 8, 0, 8, -1)
    assert fused_f32.f32_wg_job_rows([view])[0][-1] == fused_f32.WG_COPY_X16


CHAIN = 4  # k-stages of 32 columns a chain of the f32 forward (f32_forward.cuh)
BWD_CHAIN = 2  # and of the backward-data kernel (train_f32.cu BWD_CHAIN_STAGES)


def _fwd_layer_3xtf32(x, w, b, relu, chain=CHAIN):
    """The f32 forward's layer in its own order (f32_forward.cuh): x (m, K)
    f32 points, w (N, K) f32 packed rows; K in k-stages of 32 columns
    (zeros past K), 8-column k-steps; per k-step the three products A_lo
    W_hi, A_hi W_lo, A_hi W_hi of the split hi = x (read truncated to TF32),
    lo = x - trunc(x) (read truncated too), each k-step's 8 products summed
    in f64 and rounded to f32 once (the tensor cores' sums are wider than
    f32), added into a chain in f32; a chain from zero every `chain`
    k-stages (f32_forward.cuh's CHAIN_STAGES), added into the f32 totals,
    which start from the bias; then ReLU."""
    k = x.shape[1]
    pad = -k % 32
    x = np.pad(x, ((0, 0), (0, pad)))
    w = np.pad(w, ((0, 0), (0, pad)))
    xh, wh = _tf32_trunc(x), _tf32_trunc(w)
    xl, wl = _tf32_trunc(x - xh), _tf32_trunc(w - wh)
    acc = np.broadcast_to(b, (x.shape[0], w.shape[0])).astype(np.float32)
    for c0 in range(0, x.shape[1], 32 * chain):
        ch = np.zeros_like(acc)
        for k0 in range(c0, min(c0 + 32 * chain, x.shape[1]), 8):
            ks = slice(k0, k0 + 8)
            for a, bb in ((xl, wh), (xh, wl), (xh, wh)):
                ch = ch + (a[:, ks].astype(np.float64) @ bb[:, ks].T).astype(np.float32)
        acc = acc + ch
    return np.maximum(acc, 0) if relu else acc


def test_3xtf32_forward_chain_holds_f32_accuracy_and_one_pass_tf32_does_not():
    """The f32 forward's arithmetic (`_fwd_layer_3xtf32`: split, k-stages,
    chains of CHAIN k-stages into f32 totals) over a deep chain of random ReLU
    layers at the paper width (256 points, an 80-wide encode-like input,
    then 8 layers of 256 x 256, He-scaled weights, small biases), seeded:
    every layer's output within 1e-5 of the f64 chain (relative,
    Frobenius), as the card's FWD_F64_TOL asks; the same chain with one-pass
    TF32 products (trunc(x) trunc(w), summed in f64) misses that bound by
    the last layer."""
    rng = np.random.default_rng(13)
    m, widths = 256, [80] + [256] * 8
    x = rng.uniform(-1, 1, size=(m, widths[0])).astype(np.float32)
    x64, x1 = x.astype(np.float64), x
    worst, worst_one = 0.0, 0.0
    for k, n in zip(widths[:-1], widths[1:]):
        w = (rng.normal(size=(n, k)) * np.sqrt(2.0 / k)).astype(np.float32)
        b = (0.1 * rng.normal(size=n)).astype(np.float32)
        x = _fwd_layer_3xtf32(x, w, b, True)
        x64 = np.maximum(x64 @ w.T.astype(np.float64) + b, 0)
        x1 = np.maximum((_tf32_trunc(x1).astype(np.float64) @ _tf32_trunc(w).T)
                        .astype(np.float32) + b, 0)
        rel = np.linalg.norm(x - x64) / np.linalg.norm(x64)
        worst = max(worst, rel)
        worst_one = max(worst_one, np.linalg.norm(x1 - x64) / np.linalg.norm(x64))
        assert rel <= 1e-5, rel
    assert worst_one > 1e-5 > worst, (worst_one, worst)


def test_3xtf32_backward_chain_holds_f32_accuracy_and_one_pass_tf32_does_not():
    """The f32 backward-data kernel's arithmetic: its products are the
    forward's (`_fwd_layer_3xtf32` over the transposed matrix: split,
    k-stages of 32 along the reduction over N, chains of BWD_CHAIN k-stages
    from zero into f32 totals), each output then masked by the given rows
    (h > 0). Over a deep chain of 8 random masked 256 x 256 layers at 256 points
    (He-scaled weights, half the mask zeros, seeded), every layer's
    gradient stays within 1e-5 of the f64 chain (relative, Frobenius), as
    the card's BWD_F64_TOL asks; the same chain with one-pass TF32 products
    (trunc(d) trunc(w), summed in f64) misses that bound by the last
    layer."""
    rng = np.random.default_rng(17)
    m, n = 256, 256
    d = rng.normal(size=(m, n)).astype(np.float32)
    d64, d1 = d.astype(np.float64), d
    worst, worst_one = 0.0, 0.0
    for _ in range(8):
        w = (rng.normal(size=(n, n)) * np.sqrt(2.0 / n)).astype(np.float32)  # W (N, K)
        mask = rng.uniform(size=(m, n)) > 0.5
        d = _fwd_layer_3xtf32(d, np.ascontiguousarray(w.T), np.zeros(n, np.float32),
                              False, BWD_CHAIN) * mask
        d64 = (d64 @ w.astype(np.float64)) * mask
        d1 = (_tf32_trunc(d1).astype(np.float64) @ _tf32_trunc(w)).astype(np.float32) * mask
        rel = np.linalg.norm(d - d64) / np.linalg.norm(d64)
        worst = max(worst, rel)
        worst_one = max(worst_one, np.linalg.norm(d1 - d64) / np.linalg.norm(d64))
        assert d.dtype == np.float32 and rel <= 1e-5, rel
    assert worst_one > 1e-5 > worst, (worst_one, worst)
