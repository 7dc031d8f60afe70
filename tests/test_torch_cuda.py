"""The port's CUDA kernels on the card: each against its plain version.

Marked `cuda`; each test skips where no CUDA device is present (decided in
the fixture, never at import). The file imports no jax, so it runs on a GPU
machine without the JAX package's test configuration:
`python -m pytest tests/test_torch_cuda.py --noconftest -q`.
"""

from argparse import Namespace

import pytest
import torch

from mega_nerf_tpu_torch.models import init_weights, make_bg_nerf, make_nerf
from mega_nerf_tpu_torch.render import fused_mlp

pytestmark = pytest.mark.cuda


def tiny_hparams(**kw):
    base = dict(pos_xyz_dim=4, pos_dir_dim=2, layers=3, skip_layers=[1],
                layer_dim=16, bg_layer_dim=16, appearance_dim=0,
                affine_appearance=False, use_cascade=False, sh_deg=None,
                shifted_softplus=True)
    base.update(kw)
    return Namespace(**base)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


NARROW = {"layers": 6, "skip_layers": [3], "pos_dir_dim": 0}  # the 48-wide model


@pytest.mark.parametrize("m", [1000, 37, 0])
@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("kw", [
    {"appearance_dim": 48},
    {"appearance_dim": 0},
    {"appearance_dim": 0, "pos_dir_dim": 0},
    {"appearance_dim": 48, "layer_dim": 16},
    {"appearance_dim": 0, "layer_dim": 16},
    {"appearance_dim": 48, "layer_dim": 48, **NARROW},
    {"appearance_dim": 0, "layer_dim": 48, **NARROW},
    {"appearance_dim": 48, "layer_dim": 256},
    {"appearance_dim": 0, "layer_dim": 256},
    {"appearance_dim": 48, "layer_dim": 512},
    {"appearance_dim": 0, "layer_dim": 512},
])
def test_fused_eval_kernel_matches_plain(cuda_device, bg, kw, m):
    """bf16 compute; tolerance rgb 1e-2, sigma 1e-2 (1 + |sigma|): the sums
    run in another order, which can flip one bf16 rounding. Widths 16, 48
    (6 layers, no dirs), 64, 256 and 512 (every tile of the plan: 128
    points, or 64 with the output columns split); M = 1,000 (not a
    multiple of the tile), 37 (under one tile) and 0 (empty output, no
    launch)."""
    hp = tiny_hparams(pos_xyz_dim=12, pos_dir_dim=kw.get("pos_dir_dim", 4),
                      layers=kw.get("layers", 8),
                      skip_layers=kw.get("skip_layers", [4]),
                      layer_dim=kw.get("layer_dim", 64),
                      bg_layer_dim=kw.get("layer_dim", 64),
                      appearance_dim=kw["appearance_dim"],
                      compute_dtype="bfloat16")
    bundle = (make_bg_nerf if bg else make_nerf)(hp, 7)
    init_weights(bundle.module, torch.Generator().manual_seed(0))
    bundle.module.to(cuda_device)
    cfg = bundle.config
    packed = fused_mlp.pack_params(bundle.module)
    gen = torch.Generator().manual_seed(1)
    xyz = torch.rand((m, cfg.xyz_dim), generator=gen).to(cuda_device)
    dirs = torch.nn.functional.normalize(
        torch.randn((m, 3), generator=gen), dim=-1).to(cuda_device)
    app = None
    if cfg.appearance_dim:
        idx = torch.randint(0, 7, (m,), generator=gen).to(cuda_device)
        app = bundle.module.appearance(idx).contiguous()
    dirs = dirs if cfg.pos_dir_dim else None
    launches = fused_mlp.fused_nerf_eval.launches
    with torch.no_grad():
        got = fused_mlp.fused_nerf_eval(packed, xyz, dirs, app)
        want = fused_mlp.fused_nerf_eval_plain(packed, xyz, dirs, app)
    torch.cuda.synchronize()
    assert fused_mlp.fused_nerf_eval.launches == launches + (m > 0)
    assert got.shape == (m, 4)
    if m == 0:
        return
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert err[:, :3].max().item() <= 1e-2
    assert (err[:, 3] / (1 + want[:, 3].abs())).max().item() <= 1e-2


def _train_case(cuda_device, bg, kw, m, dtype="bfloat16"):
    from mega_nerf_tpu_torch.render import fused_train

    hp = tiny_hparams(pos_xyz_dim=12, pos_dir_dim=kw.get("pos_dir_dim", 4),
                      layers=kw.get("layers", 8),
                      skip_layers=kw.get("skip_layers", [4]),
                      layer_dim=kw.get("layer_dim", 64),
                      bg_layer_dim=kw.get("layer_dim", 64),
                      appearance_dim=kw["appearance_dim"],
                      compute_dtype=dtype)
    bundle = (make_bg_nerf if bg else make_nerf)(hp, 7)
    gen = torch.Generator().manual_seed(3)
    init_weights(bundle.module, gen)
    with torch.no_grad():  # small random biases so no layer starts dead
        for name, p in bundle.module.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    bundle.module.to(cuda_device)
    cfg = bundle.config
    packed = fused_mlp.pack_params(bundle.module)
    xyz = torch.rand((m, cfg.xyz_dim), generator=gen).to(cuda_device)
    dirs = torch.nn.functional.normalize(
        torch.randn((m, 3), generator=gen), dim=-1).to(cuda_device)
    dirs = dirs if cfg.pos_dir_dim else None
    app = None
    if cfg.appearance_dim:
        idx = torch.randint(0, 7, (m,), generator=gen).to(cuda_device)
        app = bundle.module.appearance(idx).float().contiguous()
    noise = torch.rand((m,), generator=gen).to(cfg.dtype).float().to(cuda_device)
    g = torch.randn((m, 4), generator=gen).to(cuda_device)
    return fused_train, packed, xyz, dirs, app, noise, g


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-12)).item()


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("kw", [
    {"appearance_dim": 48},
    {"appearance_dim": 0},
    {"appearance_dim": 0, "pos_dir_dim": 0},
    {"appearance_dim": 48, "layer_dim": 256},
    {"appearance_dim": 48, "layer_dim": 512},
    {"appearance_dim": 0, "pos_dir_dim": 0, "layer_dim": 48},
    {"appearance_dim": 48, "layer_dim": 16},
])
def test_fused_train_kernels_match_plain(cuda_device, bg, kw):
    """Each training kernel against its plain version on the same inputs.
    Forward: rgb 1e-2, sigma 1e-2 (1 + |sigma|), saved rows 1e-2 relative.
    Backward-data (from the kernel forward's rows) and weight-gradient (from
    the kernel's gradient rows): relative norm 1e-2 per layer's rows, per
    gradient tensor and d_app (bf16 operands, another summation order).
    20,011 points, not a multiple of the 64- or 128-point tiles: enough
    points that a single flipped bf16 rounding moves no tensor's relative
    norm far. Widths 64, 256 and 512 (every tile the forward's plan picks:
    128 points, or 64 points with the output columns split) and 48 (not a
    multiple of the 64-column blocks) and 16 (a branch of 16 columns, KB
    = 16, narrower than every box)."""
    ft, packed, xyz, dirs, app, noise, g = _train_case(cuda_device, bg, kw, 20_011)
    launches = (ft.fused_nerf_train_fwd.launches, ft.train_bwd_data.launches,
                ft.weight_grad.launches)
    out, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
    want, p_act = ft.fused_nerf_train_fwd_plain(packed, xyz, dirs, app, noise)
    grad, d_app = ft.train_bwd_data(packed, act, g, noise)
    p_grad, p_d_app = ft.train_bwd_data_plain(packed, act, g, noise)
    flat = ft.weight_grad(packed, act, grad)
    p_flat = ft.weight_grad_plain(packed, act, grad)
    torch.cuda.synchronize()
    assert (ft.fused_nerf_train_fwd.launches, ft.train_bwd_data.launches,
            ft.weight_grad.launches) == tuple(n + 1 for n in launches)
    err = (out - want).abs()
    assert err[:, :3].max().item() <= 1e-2
    assert (err[:, 3] / (1 + want[:, 3].abs())).max().item() <= 1e-2
    assert act.shape == p_act.shape and _rel(act, p_act) <= 1e-2
    d = packed.config.layer_dim
    for i in range(packed.config.layers):
        seg = slice(i * d, (i + 1) * d)
        assert _rel(grad[:, seg], p_grad[:, seg]) <= 1e-2, i
    assert _rel(grad, p_grad) <= 1e-2
    if p_d_app is not None:
        assert _rel(d_app, p_d_app) <= 1e-2
    offs = ft._offsets(ft.packed_shapes(packed))
    for i in range(len(offs) - 1):
        assert _rel(flat[offs[i]:offs[i + 1]], p_flat[offs[i]:offs[i + 1]]) <= 1e-2, i


def test_train_step_skips_bg_without_bg_rays_on_card(cuda_device):
    """The bg step is skipped (params unchanged) exactly when the batch has
    no bg ray; the skip decision is read asynchronously on the card."""
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render.rendering import RenderSettings

    hp = tiny_hparams(layer_dim=64, bg_layer_dim=64, appearance_dim=8,
                      compute_dtype="bfloat16")
    fg, bg = make_nerf(hp, 3), make_bg_nerf(hp, 3)
    gen = torch.Generator().manual_seed(4)
    for b in (fg, bg):
        init_weights(b.module, gen)
        b.module.to(cuda_device)
    center = torch.zeros(3, device=cuda_device)
    radius = torch.full((3,), 1.0, device=cuda_device)
    step = TrainStep(fg, bg, RenderSettings(coarse_samples=16, fine_samples=16),
                     1e-3, 0.1, 10, center, radius)
    n = 64
    o = torch.zeros((n, 3))
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen), dim=-1)
    for far, moves in ((0.5, False), (100.0, True)):
        rays = torch.cat([o, d, torch.full((n, 1), 0.05), torch.full((n, 1), far)], -1)
        batch = {"rays": rays.to(cuda_device),
                 "rgbs": torch.rand((n, 3), generator=gen).to(cuda_device),
                 "img_indices": torch.zeros(n, dtype=torch.long, device=cuda_device)}
        before = [q.detach().clone() for q in bg.module.parameters()]
        fg_before = [q.detach().clone() for q in fg.module.parameters()]
        step(batch, torch.Generator(device=cuda_device).manual_seed(1))
        torch.cuda.synchronize()
        changed = any(not torch.equal(a, q) for a, q in zip(before, bg.module.parameters()))
        assert changed == moves, far
        assert any(not torch.equal(a, q) for a, q in zip(fg_before, fg.module.parameters()))


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("width,m", [(512, 20_011), (256, 131_101), (64, 20_011),
                                     (16, 1_000)])
def test_weight_grad_kernel_matches_plain_and_repeats(cuda_device, bg, width, m):
    """The weight-gradient kernel (TMA + wgmma, split-K over points with a
    fixed-order reduction) against `weight_grad_plain` on the kernels' own
    rows: relative norm 1e-2 per gradient tensor (bf16 operands, another
    summation order), at the paper width on 131,101 points and at narrow
    widths; two launches on the same inputs give the same bits."""
    ft, packed, xyz, dirs, app, noise, g = _train_case(
        cuda_device, bg, {"appearance_dim": 48, "layer_dim": width}, m)
    with torch.no_grad():
        _, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
        grad, _ = ft.train_bwd_data(packed, act, g, noise)
        launches = ft.weight_grad.launches
        flat = ft.weight_grad(packed, act, grad)
        again = ft.weight_grad(packed, act, grad)
        want = ft.weight_grad_plain(packed, act, grad)
    torch.cuda.synchronize()
    assert ft.weight_grad.launches == launches + 2
    assert torch.equal(flat, again)
    offs = ft._offsets(ft.packed_shapes(packed))
    for i in range(len(offs) - 1):
        assert _rel(flat[offs[i]:offs[i + 1]], want[offs[i]:offs[i + 1]]) <= 1e-2, i


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("width", [16, 48, 256, 512])
def test_train_bwd_data_kernel_repeats_bitwise(cuda_device, bg, width):
    """The backward-data kernel (wgmma chain over a resident gradient tile,
    TMA weight ring and mask tiles) writes every gradient-row column and
    d_app with the same bits on two launches over the same rows: it has no
    atomics and no run-to-run order. Its rows and d_app stay finite."""
    ft, packed, xyz, dirs, app, noise, g = _train_case(
        cuda_device, bg, {"appearance_dim": 48, "layer_dim": width}, 20_011)
    with torch.no_grad():
        _, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
        launches = ft.train_bwd_data.launches
        grad, d_app = ft.train_bwd_data(packed, act, g, noise)
        grad2, d_app2 = ft.train_bwd_data(packed, act, g, noise)
    torch.cuda.synchronize()
    assert ft.train_bwd_data.launches == launches + 2
    assert torch.isfinite(grad.float()).all() and torch.isfinite(d_app).all()
    assert torch.equal(grad.view(torch.int16), grad2.view(torch.int16))
    assert torch.equal(d_app, d_app2)


@pytest.mark.parametrize("bg", [False, True])
def test_train_kernel_chain_stress_at_width_16(cuda_device, bg):
    """The chain a training step runs, forward -> backward-data ->
    weight-gradient twice, at width 16 on 1,000 points, 200 times with a
    sync after each: no device error, every output finite and each run's
    the same bits as the first."""
    ft, packed, xyz, dirs, app, noise, g = _train_case(
        cuda_device, bg, {"appearance_dim": 48, "layer_dim": 16}, 1_000)
    first = None
    with torch.no_grad():
        for it in range(200):
            out, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
            grad, d_app = ft.train_bwd_data(packed, act, g, noise)
            flat = ft.weight_grad(packed, act, grad)
            again = ft.weight_grad(packed, act, grad)
            torch.cuda.synchronize()
            now = (out, act, grad, d_app, flat, again)
            if first is None:
                first = now
                assert all(torch.isfinite(t.float()).all() for t in now)
            assert all(torch.equal(a, b) for a, b in zip(first, now)), it


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("kw", [
    {"appearance_dim": 48, "layer_dim": 16},
    {"appearance_dim": 0, "layer_dim": 48, **NARROW},
    {"appearance_dim": 48, "layer_dim": 256},
    {"appearance_dim": 48, "layer_dim": 512},
])
def test_eval_kernel_equals_train_forward_without_noise(cuda_device, bg, kw):
    """The eval kernel and the training forward run the same layer chain
    (the same boxes in the same K order, the same heads): without noise
    their (M, 4) outputs have the same bits, at every tile of the plan."""
    ft, packed, xyz, dirs, app, _, _ = _train_case(cuda_device, bg, kw, 20_011)
    app = None if app is None else app.to(torch.bfloat16).contiguous()
    with torch.no_grad():
        got = fused_mlp.fused_nerf_eval(packed, xyz, dirs, app)
        want, _ = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, None)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("bg", [False, True])
def test_eval_kernel_persistent_walk_repeats_bitwise(cuda_device, bg):
    """A launch at the default grid (one CTA per SM at most) and launches
    at grids of 1 and 7 CTAs, whose walks cross many tile boundaries with
    the ring and barrier phases running on, give the same bits on 131,101
    points at width 64 (the ragged last tile falls to a different CTA in
    each)."""
    ft, packed, xyz, dirs, app, _, _ = _train_case(
        cuda_device, bg, {"appearance_dim": 48, "layer_dim": 64}, 131_101)
    app = app.to(torch.bfloat16).contiguous()
    launches = fused_mlp.fused_nerf_eval.launches
    with torch.no_grad():
        outs = [fused_mlp.fused_nerf_eval(packed, xyz, dirs, app, grid=g)
                for g in (None, 1, 7)]
    torch.cuda.synchronize()
    assert fused_mlp.fused_nerf_eval.launches == launches + 3
    assert fused_mlp.launch_grid(packed, 131_101, xyz.device) > 7
    assert torch.isfinite(outs[0]).all()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


F32_VARIANTS = [  # widths 64 (default), 16, 48, 256 and 512 (64-point tiles), 288 (32)
    {"appearance_dim": 48},
    {"appearance_dim": 0},
    {"appearance_dim": 0, "pos_dir_dim": 0},
    {"appearance_dim": 48, "layer_dim": 16},
    {"appearance_dim": 0, "layer_dim": 48, **NARROW},
    {"appearance_dim": 48, "layer_dim": 256},
    {"appearance_dim": 5, "layer_dim": 288},
    {"appearance_dim": 48, "layer_dim": 512},
]


def _f32_counts():
    from mega_nerf_tpu_torch.render import fused_f32

    return [f.launches for f in fused_f32.F32_KERNELS]


@pytest.mark.parametrize("m", [1000, 37, 0])
@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("kw", F32_VARIANTS)
def test_f32_eval_kernel_matches_plain(cuda_device, bg, kw, m):
    """f32 compute (`eval_f32.cu`) against the plain version, TF32 off:
    rgb 1e-4, sigma 1e-4 (1 + |sigma|) (true f32 on both sides, the sums in
    another order). One f32 launch (none at M = 0), no bf16 launch;
    M = 1,000 and 37 (ragged and under one tile)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, packed, xyz, dirs, app, _, _ = _train_case(cuda_device, bg, kw, m, "float32")
    before, bf16 = _f32_counts(), fused_mlp.fused_nerf_eval.launches
    with torch.no_grad():
        got = fused_mlp.fused_nerf_eval(packed, xyz, dirs, app)
        want = fused_mlp.fused_nerf_eval_plain(packed, xyz, dirs, app)
    torch.cuda.synchronize()
    assert _f32_counts() == [before[0] + (m > 0), *before[1:]]
    assert fused_mlp.fused_nerf_eval.launches == bf16
    assert got.shape == (m, 4)
    if m == 0:
        return
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert err[:, :3].max().item() <= 1e-4
    assert (err[:, 3] / (1 + want[:, 3].abs())).max().item() <= 1e-4


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("kw", F32_VARIANTS)
def test_f32_train_kernels_match_plain(cuda_device, bg, kw):
    """The f32 training kernels (`train_f32.cu`) against their plain
    versions, TF32 off, on 20,011 points (not a multiple of either tile):
    forward rgb 1e-4, sigma 1e-4 (1 + |sigma|), saved rows 1e-4 relative;
    backward-data per layer's gradient rows, all rows and d_app 1e-4
    relative; every weight-gradient tensor 1e-4 relative. Without noise the
    eval kernel's output equals the training forward's bit for bit; two
    weight-gradient launches give the same bits. One launch of each f32
    kernel per call, no bf16 launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ft, packed, xyz, dirs, app, noise, g = _train_case(cuda_device, bg, kw, 20_011,
                                                       "float32")
    before = _f32_counts()
    bf16 = (ft.fused_nerf_train_fwd.launches, ft.train_bwd_data.launches,
            ft.weight_grad.launches, fused_mlp.fused_nerf_eval.launches)
    out, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
    want, p_act = ft.fused_nerf_train_fwd_plain(packed, xyz, dirs, app, noise)
    grad, d_app = ft.train_bwd_data(packed, act, g, noise)
    p_grad, p_d_app = ft.train_bwd_data_plain(packed, act, g, noise)
    flat = ft.weight_grad(packed, act, grad)
    again = ft.weight_grad(packed, act, grad)
    p_flat = ft.weight_grad_plain(packed, act, grad)
    with torch.no_grad():
        clean, _ = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, None)
        ev = fused_mlp.fused_nerf_eval(packed, xyz, dirs, app)
    torch.cuda.synchronize()
    assert _f32_counts() == [before[0] + 1, before[1] + 2, before[2] + 1, before[3] + 2]
    assert (ft.fused_nerf_train_fwd.launches, ft.train_bwd_data.launches,
            ft.weight_grad.launches, fused_mlp.fused_nerf_eval.launches) == bf16
    assert act.dtype == grad.dtype == torch.float32
    err = (out - want).abs()
    assert err[:, :3].max().item() <= 1e-4
    assert (err[:, 3] / (1 + want[:, 3].abs())).max().item() <= 1e-4
    assert act.shape == p_act.shape and _rel(act, p_act) <= 1e-4
    d = packed.config.layer_dim
    for i in range(packed.config.layers):
        seg = slice(i * d, (i + 1) * d)
        assert _rel(grad[:, seg], p_grad[:, seg]) <= 1e-4, i
    assert _rel(grad, p_grad) <= 1e-4
    if p_d_app is not None:
        assert _rel(d_app, p_d_app) <= 1e-4
    offs = ft._offsets(ft.packed_shapes(packed))
    for i in range(len(offs) - 1):
        assert _rel(flat[offs[i]:offs[i + 1]], p_flat[offs[i]:offs[i + 1]]) <= 1e-4, i
    assert torch.equal(flat, again)
    assert torch.isfinite(ev).all() and torch.equal(ev, clean)


FWD_F64_TOL = 1e-5  # the f32 forward (3xTF32) against an f64 forward of its f32 inputs


@pytest.mark.parametrize("width", [256, 512])
@pytest.mark.parametrize("bg", [False, True])
def test_f32_forward_holds_f64_accuracy(cuda_device, bg, width):
    """The f32 forward (3xTF32 on wgmma; 64-point tiles in place at 256,
    32-point tiles with two activation tiles at 512) against an f64 run of
    the plain forward on the same f32 weights, encode and appearance rows
    (`fused_mlp.forward_trace(acc=torch.float64)`), 4,099 points: every
    saved layer (the training forward's rows, no noise), rgb and sigma
    (the eval kernel's output) within FWD_F64_TOL relative, as the plain
    f32 forward (TF32 off) is."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ft, packed, xyz, dirs, app, _, _ = _train_case(
        cuda_device, bg, {"appearance_dim": 48, "layer_dim": width}, 4099, "float32")
    with torch.no_grad():
        out = fused_mlp.fused_nerf_eval(packed, xyz, dirs, app)
        _, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, None)
        ref = fused_mlp.forward_trace(packed, xyz, dirs, app, acc=torch.float64)
    torch.cuda.synchronize()
    lay, d = ft.act_layout(packed), width
    want = {f"h{i}": h for i, h in enumerate(ref.hs)}
    want["final"] = ref.branch_in[:, :d]
    want["branch"] = ref.branch
    got = {f"h{i}": act[:, lay["h0"] + i * d:lay["h0"] + (i + 1) * d]
           for i in range(len(ref.hs))}
    got["final"] = act[:, lay["final"]:lay["final"] + d]
    got["branch"] = act[:, lay["branch"]:lay["width"]]
    final = ref.output(packed.config.shifted_softplus)
    got["rgb"], want["rgb"] = out[:, :3], final[:, :3]
    got["sigma"], want["sigma"] = out[:, 3], final[:, 3]
    errs = {k: (got[k].double() - want[k]).norm().item() / want[k].norm().item()
            for k in want}
    assert all(e <= FWD_F64_TOL for e in errs.values()), errs


def test_f32_forward_follows_in_place_weight_updates(cuda_device):
    """The f32 forward reads W's TF32 rests from `fused_f32.w_rests`, which
    caches them on the packed object by each matrix's storage and version:
    after the packed matrices and biases are updated in place (the version
    moves, so the rests are made anew), the next eval and training-forward
    launches match the plain version on the new weights (1e-4, as
    test_f32_eval_kernel_matches_plain), and the outputs moved."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ft, packed, xyz, dirs, app, noise, _ = _train_case(
        cuda_device, False, {"appearance_dim": 48, "layer_dim": 256}, 5000, "float32")
    with torch.no_grad():
        before = fused_mlp.fused_nerf_eval(packed, xyz, dirs, app)
        for w, b in zip(packed.mats, packed.biases):
            w.mul_(1.25)
            b.add_(0.05)
        got = fused_mlp.fused_nerf_eval(packed, xyz, dirs, app)
        out, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
        want = fused_mlp.fused_nerf_eval_plain(packed, xyz, dirs, app)
        want_t, want_act = ft.fused_nerf_train_fwd_plain(packed, xyz, dirs, app, noise)
    torch.cuda.synchronize()
    assert (got - before).abs().max().item() > 1e-2
    for a, b in ((got, want), (out, want_t)):
        err = (a - b).abs()
        assert err[:, :3].max().item() <= 1e-4
        assert (err[:, 3] / (1 + b[:, 3].abs())).max().item() <= 1e-4
    assert _rel(act, want_act) <= 1e-4


BWD_F64_TOL = 1e-5  # the f32 backward-data (3xTF32) against f64 sums of its f32 rows


def _bwd_segments(ft, packed, grad, d_app):
    """The gradient rows cut into their segments (fused_train.grad_layout:
    d_pre_0 .. d_pre_{L-1}, d_final and d_a with the branch, the heads), and
    d_app where the model has appearance."""
    cfg, gl = packed.config, ft.grad_layout(packed)
    d = cfg.layer_dim
    seg = {f"d_pre{i}": grad[:, i * d:(i + 1) * d] for i in range(cfg.layers)}
    if packed.has_branch:
        seg["d_final"] = grad[:, gl["dfinal"]:gl["dfinal"] + d]
        seg["d_a"] = grad[:, gl["da"]:gl["heads"]]
    seg["heads"] = grad[:, gl["heads"]:]
    if d_app is not None:
        seg["d_app"] = d_app
    return seg


def _bwd_f64_errors(ft, packed, act, g, noise, grad, d_app):
    """Relative errors (Frobenius; 0 where both are 0) of every segment of
    the kernel's gradient rows and of d_app against the plain version's f64
    sums of the same f32 rows, weights and cotangent."""
    want = _bwd_segments(ft, packed, *ft.train_bwd_data_plain(packed, act, g, noise,
                                                              acc=torch.float64))
    got = _bwd_segments(ft, packed, grad, d_app)
    return {k: ((got[k].double() - w).norm() / w.norm().clamp_min(1e-300)).item()
            for k, w in want.items()}


@pytest.mark.parametrize("width", [256, 512])
@pytest.mark.parametrize("bg", [False, True])
def test_f32_backward_holds_f64_accuracy(cuda_device, bg, width):
    """The f32 backward-data kernel (3xTF32 on wgmma over the transposed
    matrices and their rests; 64-point tiles in place at 256, 32-point
    ping-pong tiles at 512) on the f32 forward's saved rows of 4,099 points
    and a seeded cotangent with sigma noise: every gradient-row segment
    (each d_pre, d_final, d_a, the heads) and d_app within BWD_F64_TOL of
    the plain version's f64 sums on the same f32 rows and weights
    (`train_bwd_data_plain(acc=torch.float64)`). One launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ft, packed, xyz, dirs, app, noise, g = _train_case(
        cuda_device, bg, {"appearance_dim": 48, "layer_dim": width}, 4099, "float32")
    from mega_nerf_tpu_torch.render import fused_f32

    with torch.no_grad():
        _, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
        before = fused_f32.train_bwd_data_f32.launches
        grad, d_app = ft.train_bwd_data(packed, act, g, noise)
        torch.cuda.synchronize()
        assert fused_f32.train_bwd_data_f32.launches == before + 1
        errs = _bwd_f64_errors(ft, packed, act, g, noise, grad, d_app)
    assert torch.isfinite(grad).all()
    assert all(e <= BWD_F64_TOL for e in errs.values()), errs


@pytest.mark.parametrize("m", [4_099, 37, 1])
@pytest.mark.parametrize("width", [48, 256, 512])
@pytest.mark.parametrize("bg", [False, True])
def test_f32_backward_takes_ragged_tiles_and_repeats_bitwise(cuda_device, bg, width, m):
    """The f32 backward-data kernel with M not a multiple of its tile
    (4,099), within one tile (37) and one point: two launches give the same
    bits (one fixed order of sums), and every segment and d_app holds
    BWD_F64_TOL against f64 sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ft, packed, xyz, dirs, app, noise, g = _train_case(
        cuda_device, bg, {"appearance_dim": 48, "layer_dim": width}, m, "float32")
    with torch.no_grad():
        _, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
        grad, d_app = ft.train_bwd_data(packed, act, g, noise)
        again, d_app2 = ft.train_bwd_data(packed, act, g, noise)
        torch.cuda.synchronize()
        errs = _bwd_f64_errors(ft, packed, act, g, noise, grad, d_app)
    assert torch.equal(grad, again) and torch.equal(d_app, d_app2)
    assert all(e <= BWD_F64_TOL for e in errs.values()), errs


def test_f32_backward_follows_in_place_weight_updates(cuda_device):
    """The f32 backward-data kernel reads the transposed matrices and their
    rests from `fused_f32.t_rests`, cached on the packed object by each
    matrix's storage and version: after the packed matrices are updated in
    place, the next launch matches the plain version on the new weights
    (1e-4 relative, as test_f32_train_kernels_match_plain) and its output
    moved."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ft, packed, xyz, dirs, app, noise, g = _train_case(
        cuda_device, False, {"appearance_dim": 48, "layer_dim": 256}, 5000, "float32")
    with torch.no_grad():
        _, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
        before, _ = ft.train_bwd_data(packed, act, g, noise)
        for w in packed.mats:
            w.mul_(1.25)
        grad, d_app = ft.train_bwd_data(packed, act, g, noise)
        want, want_app = ft.train_bwd_data_plain(packed, act, g, noise)
    torch.cuda.synchronize()
    assert _rel(grad, before) > 1e-2
    assert _rel(grad, want) <= 1e-4 and _rel(d_app, want_app) <= 1e-4


def test_f32_wrappers_refuse_what_the_kernels_cannot_take(cuda_device):
    """f32 packed weights with bf16 inputs (appearance rows, saved rows)
    raise, and so does a compute dtype no kernel has; nothing launches."""
    ft, packed, xyz, dirs, app, noise, g = _train_case(
        cuda_device, False, {"appearance_dim": 48}, 1000, "float32")
    before = _f32_counts()
    with pytest.raises(ValueError):
        fused_mlp.fused_nerf_eval(packed, xyz, dirs, app.to(torch.bfloat16))
    act = torch.zeros((1000, ft.act_layout(packed)["width"]), dtype=torch.bfloat16,
                      device=cuda_device)
    with pytest.raises(ValueError):
        ft.train_bwd_data(packed, act, g, noise)
    with pytest.raises(ValueError):
        ft.weight_grad(packed, act, act)
    _, fp16, *_ = _train_case(cuda_device, False, {"appearance_dim": 0}, 1000, "float16")
    with pytest.raises(NotImplementedError):
        fused_mlp.fused_nerf_eval(fp16, xyz, dirs)
    assert _f32_counts() == before


@pytest.mark.parametrize("m", [20_011, 33, 1])
def test_f32_weight_grad_takes_ragged_and_unaligned_jobs(cuda_device, m):
    """The f32 weight gradient (3xTF32 on `mma.sync`) on jobs the plans do
    not make, in one launch: 130 x 131 (a row and a column past one tile,
    with bias), 3 x 7 from columns 1 and 5 (4-byte copies of both
    operands), 5 x 13 from views whose rows start 4 B past 16 B (4-byte
    copies), 1 x 24 (16-byte copies, with bias). Each job's dW and db
    within 1e-5 of its f64 sums' norm (3xTF32 keeps ~2^-21 of each
    product); two launches give the same bits; one launch."""
    from mega_nerf_tpu_torch.render import fused_f32

    gen = torch.Generator().manual_seed(3)
    d = torch.randn((m, 160), generator=gen).to(cuda_device)
    x = torch.relu(torch.randn((m, 152), generator=gen)).to(cuda_device)
    dv, xv = d[:, 1:], x[:, 1:]
    specs = [(d, x, 0, 130, 0, 131, True), (d, x, 1, 3, 5, 7, False),
             (dv, xv, 0, 5, 0, 13, False), (d, x, 4, 1, 8, 24, True)]
    jobs, off = [], 0
    for a, b, d_col, n, x_col, k, bias in specs:
        jobs.append(fused_f32.WgJob(a, b, d_col, n, x_col, k, off, k,
                                    off + n * k if bias else -1))
        off += n * k + (n if bias else 0)
    assert [row[-1] for row in fused_f32.f32_wg_job_rows(jobs)] == [
        fused_f32.WG_COPY_D16 | fused_f32.WG_COPY_X16, 0, 0,
        fused_f32.WG_COPY_D16 | fused_f32.WG_COPY_X16]
    before = fused_f32.weight_grad_f32.launches
    out = fused_f32.weight_grad_f32_jobs(jobs, torch.full((off,), float("nan"),
                                                          device=cuda_device))
    again = fused_f32.weight_grad_f32_jobs(jobs, torch.zeros(off, device=cuda_device))
    torch.cuda.synchronize()
    assert fused_f32.weight_grad_f32.launches == before + 2
    assert torch.equal(out, again)
    for j in jobs:
        dd = j.d[:, j.d_col:j.d_col + j.n].double()
        want = [(dd.T @ j.x[:, j.x_col:j.x_col + j.k].double()).reshape(-1)]
        got = [out[j.out_off:j.out_off + j.n * j.k].double()]
        if j.bias_off >= 0:
            want.append(dd.sum(0))
            got.append(out[j.bias_off:j.bias_off + j.n].double())
        want, got = torch.cat(want), torch.cat(got)
        assert (got - want).norm().item() <= 1e-5 * want.norm().item(), j[2:]


def _wide_case(cuda_device, bg, kw, m, seed=5):
    """A seeded model of the wide route (8 layers, skip at 4, small random
    biases; bf16 compute unless kw names another) on the card, its packed
    weights and m seeded points."""
    from mega_nerf_tpu_torch.render import fused_wide

    hp = tiny_hparams(pos_xyz_dim=12, pos_dir_dim=kw.get("pos_dir_dim", 4),
                      layers=8, skip_layers=[4], layer_dim=kw["layer_dim"],
                      bg_layer_dim=kw["layer_dim"],
                      appearance_dim=kw["appearance_dim"],
                      compute_dtype=kw.get("compute_dtype", "bfloat16"))
    bundle = (make_bg_nerf if bg else make_nerf)(hp, 7)
    gen = torch.Generator().manual_seed(seed)
    init_weights(bundle.module, gen)
    with torch.no_grad():
        for name, p in bundle.module.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    bundle.module.to(cuda_device)
    cfg = bundle.config
    packed = fused_mlp.pack_params(bundle.module)
    xyz = torch.rand((m, cfg.xyz_dim), generator=gen).to(cuda_device)
    dirs = torch.nn.functional.normalize(
        torch.randn((m, 3), generator=gen), dim=-1).to(cuda_device)
    dirs = dirs if cfg.pos_dir_dim else None
    app = None
    if cfg.appearance_dim:
        idx = torch.randint(0, 7, (m,), generator=gen).to(cuda_device)
        app = bundle.module.appearance(idx).contiguous()
    return fused_wide, packed, xyz, dirs, app


def _close(got, want):
    return ((got.float() - want.float()).abs() / (1 + want.float().abs())).max().item()


def _bf16_order(t):
    """bf16 bit patterns as integers in value order: +0 and -0 both 0,
    neighbouring values 1 apart."""
    bits = t.contiguous().view(torch.int16).int()
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _assert_encode_agrees(got, want):
    """The encode kernel against its plain version: 1e-2 (1 + |x|), at
    least 99.9% of the bf16 elements bit-equal and the rest one bf16 ulp
    away (the kernel's sines are sinf's own; a result one f32 ulp off
    flips a bf16 rounding only at a tie)."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    assert _close(got, want) <= 1e-2
    g, w = _bf16_order(got), _bf16_order(want)
    assert (g == w).float().mean().item() >= 0.999
    assert (g - w).abs().max().item() <= 1


WIDE_VARIANTS = [
    {"appearance_dim": 48},
    {"appearance_dim": 0},
    {"appearance_dim": 48, "pos_dir_dim": 0},
    {"appearance_dim": 0, "pos_dir_dim": 0},
]


@pytest.mark.parametrize("m", [1000, 37])
@pytest.mark.parametrize("kw", WIDE_VARIANTS)
@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("width", [640, 1024, 2048])
def test_wide_eval_kernels_match_plain(cuda_device, width, bg, kw, m):
    """Each wide kernel against its plain version on the same inputs:
    the encode, every layer of the chain fed the plain chain's input (the
    skip layer's [enc | h], trunk_final, dir_a's [final | dir | app] with and
    without dirs and appearance), the heads; then the whole wide eval.
    Tolerances: layers 1e-2 (1 + |y|) (another summation order can flip
    one bf16 rounding), the encode as `_assert_encode_agrees`, rgb 1e-2
    absolute, sigma 1e-2 (1 + |s|).
    M = 1,000 and 37: not multiples of the 128-point tile."""
    fw, packed, xyz, dirs, app = _wide_case(cuda_device, bg,
                                            {"layer_dim": width, **kw}, m)
    cfg = packed.config
    with torch.no_grad():
        enc, dir_enc = fw.eval_wide_encode(packed, xyz, dirs)
        p_enc, p_dir = fw.eval_wide_encode_plain(packed, xyz, dirs)
        _assert_encode_agrees(enc, p_enc)
        if packed.dp:
            _assert_encode_agrees(dir_enc, p_dir)
        h = p_enc
        for i in range(cfg.layers):
            xs = [p_enc, h] if i in cfg.skip_layers else [h]
            got = fw.eval_wide_layer(xs, packed.mats[i], packed.biases[i], True)
            h = fw.eval_wide_layer_plain(xs, packed.mats[i], packed.biases[i], True)
            assert _close(got, h) <= 1e-2, i
        branch = None
        if packed.has_branch:
            w, b = packed.mats[cfg.layers], packed.biases[cfg.layers]
            got = fw.eval_wide_layer([h], w, b, False)
            final = fw.eval_wide_layer_plain([h], w, b, False)
            assert _close(got, final) <= 1e-2
            xs = [final] + ([p_dir] if packed.dp else []) + ([app] if packed.ap else [])
            w, b = packed.mats[cfg.layers + 1], packed.biases[cfg.layers + 1]
            got = fw.eval_wide_layer(xs, w, b, True)
            branch = fw.eval_wide_layer_plain(xs, w, b, True)
            assert _close(got, branch) <= 1e-2
        heads = fw.eval_wide_heads(packed, h, branch)
        p_heads = fw.eval_wide_heads_plain(packed, h, branch)
        got = fw.fused_nerf_eval_wide(packed, xyz, dirs, app)
        want = fw.fused_nerf_eval_wide_plain(packed, xyz, dirs, app)
    torch.cuda.synchronize()
    for out, ref in ((heads, p_heads), (got, want)):
        assert out.shape == (m, 4) and torch.isfinite(out).all()
        err = (out - ref).abs()
        assert err[:, :3].max().item() <= 1e-2
        assert (err[:, 3] / (1 + ref[:, 3].abs())).max().item() <= 1e-2


def _encode_case(cuda_device, bg, pos_xyz_dim, pos_dir_dim, m, spread=1.0, seed=11,
                 compute_dtype="bfloat16"):
    """A 16-wide model's packed encode (only its encode widths matter) and m
    seeded points: the renderer's ranges (fg xyz in [-1.5, 1.5], bg a unit
    vector and an inverse depth in [0, 1], unit dirs) times `spread`."""
    from mega_nerf_tpu_torch.render import fused_wide

    hp = tiny_hparams(pos_xyz_dim=pos_xyz_dim, pos_dir_dim=pos_dir_dim,
                      compute_dtype=compute_dtype)
    bundle = (make_bg_nerf if bg else make_nerf)(hp, 1)
    packed = fused_mlp.pack_params(bundle.module.to(cuda_device))
    gen = torch.Generator().manual_seed(seed)
    if bg:
        p = torch.nn.functional.normalize(torch.randn((m, 3), generator=gen), dim=-1)
        xyz = torch.cat([p, torch.rand((m, 1), generator=gen)], -1)
    else:
        xyz = 1.5 * (2 * torch.rand((m, 3), generator=gen) - 1)
    dirs = torch.nn.functional.normalize(torch.randn((m, 3), generator=gen), dim=-1)
    return (fused_wide, packed, (spread * xyz).to(cuda_device),
            (spread * dirs).to(cuda_device) if pos_dir_dim else None)


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("m", [1, 37, 129, 1000, 200_003])
@pytest.mark.parametrize("pos_dir_dim", [4, 0])
@pytest.mark.parametrize("pos_xyz_dim", [12, 16, 1, 64])
@pytest.mark.parametrize("bg", [False, True])
def test_wide_encode_kernel_matches_plain(cuda_device, bg, pos_xyz_dim, pos_dir_dim, m,
                                          given):
    """The encode kernel against its plain version (`_assert_encode_agrees`)
    at xyz_dim 3 and 4, 12 / 16 / 1 xyz frequencies (64: the tile halves to
    64 points), with and without dirs; M = 1, 37, one tile + 1 and 1,000,
    and 200,003 (CTAs walk several tiles); outputs allocated by the wrapper
    or given, pre-filled with NaN, so every column, pads included, must be
    written. A second launch gives the same bits."""
    fw, packed, xyz, dirs = _encode_case(cuda_device, bg, pos_xyz_dim, pos_dir_dim, m)
    assert fw.encode_plan(packed.config.xyz_dim, packed.ep, packed.dp)[0] == (
        64 if pos_xyz_dim == 64 else fw.ENCODE_TILE)
    bf = dict(dtype=torch.bfloat16, device=cuda_device)
    outs = {}
    if given:
        outs["enc"] = torch.full((m, packed.ep), float("nan"), **bf)
        if packed.dp:
            outs["dir_enc"] = torch.full((m, packed.dp), float("nan"), **bf)
    launches = fw.eval_wide_encode.launches
    with torch.no_grad():
        enc, dir_enc = fw.eval_wide_encode(packed, xyz, dirs, **outs)
        again = fw.eval_wide_encode(packed, xyz, dirs)
        p_enc, p_dir = fw.eval_wide_encode_plain(packed, xyz, dirs)
    torch.cuda.synchronize()
    assert fw.eval_wide_encode.launches == launches + 2
    if given:
        assert enc.data_ptr() == outs["enc"].data_ptr()
    _assert_encode_agrees(enc, p_enc)
    assert torch.equal(enc.view(torch.int16), again[0].view(torch.int16))
    assert (dir_enc is None) == (p_dir is None) == (pos_dir_dim == 0)
    if p_dir is not None:
        _assert_encode_agrees(dir_enc, p_dir)
        assert torch.equal(dir_enc.view(torch.int16), again[1].view(torch.int16))


@pytest.mark.parametrize("pos_xyz_dim", [12, 16])
@pytest.mark.parametrize("bg", [False, True])
def test_wide_encode_kernel_takes_sinf_past_the_reduction_limit(cuda_device, bg,
                                                                pos_xyz_dim):
    """The renderer's ranges times 6,667 (fg coordinates up to 1e4): x 2^k
    passes sinf's Cody-Waite limit (105,615) from k = 4 on, and those lanes
    take sinf itself; the same agreement as in the renderer's ranges."""
    fw, packed, xyz, dirs = _encode_case(cuda_device, bg, pos_xyz_dim, 4, 1000,
                                         spread=1e4 / 1.5)
    assert xyz.abs().max().item() * 2 ** (pos_xyz_dim - 1) > 105_615
    with torch.no_grad():
        enc, dir_enc = fw.eval_wide_encode(packed, xyz, dirs)
        p_enc, p_dir = fw.eval_wide_encode_plain(packed, xyz, dirs)
    torch.cuda.synchronize()
    _assert_encode_agrees(enc, p_enc)
    _assert_encode_agrees(dir_enc, p_dir)


def test_wide_encode_refuses_misaligned_outputs(cuda_device):
    """A given enc or dir_enc off 16-byte alignment (the kernel stores
    16-byte chunks) raises, without a launch or a plain call."""
    fw, packed, xyz, dirs = _encode_case(cuda_device, False, 12, 4, 64)
    bf = dict(dtype=torch.bfloat16, device=cuda_device)
    enc = torch.empty(64 * packed.ep + 8, **bf)[8:].view(64, packed.ep)
    dir_enc = torch.empty(64 * packed.dp + 8, **bf)[8:].view(64, packed.dp)
    launches, calls = fw.eval_wide_encode.launches, fw.eval_wide_encode_plain.calls
    for given in ({"enc": torch.empty(64 * packed.ep + 1, **bf)[1:].view(64, packed.ep)},
                  {"dir_enc": torch.empty(64 * packed.dp + 1, **bf)[1:].view(64, packed.dp)}):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fw.eval_wide_encode(packed, xyz, dirs, **given)
    fw.eval_wide_encode(packed, xyz, dirs, enc=enc, dir_enc=dir_enc)  # aligned: fine
    torch.cuda.synchronize()
    assert fw.eval_wide_encode.launches == launches + 1
    assert fw.eval_wide_encode_plain.calls == calls


def _f32_encode_case(cuda_device, xyz_dim, pos_xyz_dim, pos_dir_dim, m, spread=1.0):
    """`_encode_case` in f32 compute at xyz_dim 1-4: xyz_dim 1 and 2 take the
    fg model's first coordinates, its packed config and enc width cut to
    them (the encode reads nothing else)."""
    import dataclasses

    fw, packed, xyz, dirs = _encode_case(cuda_device, xyz_dim == 4, pos_xyz_dim, pos_dir_dim,
                                         m, spread, compute_dtype="float32")
    if xyz_dim < 3:
        cfg = dataclasses.replace(packed.config, xyz_dim=xyz_dim)
        packed = dataclasses.replace(
            packed, config=cfg, ep=fused_mlp._round_up(cfg.enc_in, fused_mlp.MMA_K))
        xyz = xyz[:, :xyz_dim].contiguous()
    return fw, packed, xyz, dirs


def _assert_f32_encode_agrees(got, want):
    """The f32 encode kernel against its plain version: the kernel's sines
    are sinf's own (one Cody-Waite reduction each, or sinf past it), the
    plain version's torch.sin on the same f32 arguments; they differ in the
    last bits of a few elements: within 1e-6 (1 + |x|) (a few f32 ulps of a
    sine), at least 99% of the elements bit-equal."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    assert _close(got, want) <= 1e-6
    assert (got == want).float().mean().item() >= 0.99


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("m", [1, 37, 129, 1000, 200_003])
@pytest.mark.parametrize("pos_dir_dim", [4, 0])
@pytest.mark.parametrize("pos_xyz_dim", [12, 64])
@pytest.mark.parametrize("xyz_dim", [1, 2, 3, 4])
def test_wide_f32_encode_kernel_matches_plain(cuda_device, xyz_dim, pos_xyz_dim, pos_dir_dim,
                                              m, given):
    """The f32 encode kernel (`wide_f32.cu`) against its plain version
    (`_assert_f32_encode_agrees`) at xyz_dim 1-4, 12 xyz frequencies (64:
    the tile halves, to 64 points at xyz_dim 2 and 32 at 3 and 4), with and
    without dirs; M = 1, 37, one tile + 1 and 1,000, and 200,003 (CTAs walk
    several tiles); outputs allocated by the wrapper or given, pre-filled
    with NaN, so every column, pads included, must be written. A second
    launch gives the same bits; no bf16 kernel launches."""
    fw, packed, xyz, dirs = _f32_encode_case(cuda_device, xyz_dim, pos_xyz_dim, pos_dir_dim, m)
    from mega_nerf_tpu_torch.render import fused_wide_f32 as fwf

    tile = fw.encode_plan(xyz_dim, packed.ep, packed.dp, 4)[0]
    assert (tile == fw.ENCODE_TILE) == (pos_xyz_dim == 12 or xyz_dim == 1)
    outs = {}
    if given:
        outs["enc"] = torch.full((m, packed.ep), float("nan"), device=cuda_device)
        if packed.dp:
            outs["dir_enc"] = torch.full((m, packed.dp), float("nan"), device=cuda_device)
    launches, bf16 = fwf.wide_f32_encode.launches, fw.eval_wide_encode.launches
    with torch.no_grad():
        enc, dir_enc = fw.eval_wide_encode(packed, xyz, dirs, **outs)
        again = fw.eval_wide_encode(packed, xyz, dirs)
        p_enc, p_dir = fw.eval_wide_encode_plain(packed, xyz, dirs)
    torch.cuda.synchronize()
    assert fwf.wide_f32_encode.launches == launches + 2
    assert fw.eval_wide_encode.launches == bf16
    if given:
        assert enc.data_ptr() == outs["enc"].data_ptr()
    _assert_f32_encode_agrees(enc, p_enc)
    assert torch.equal(enc.view(torch.int32), again[0].view(torch.int32))
    assert (dir_enc is None) == (p_dir is None) == (pos_dir_dim == 0)
    if p_dir is not None:
        _assert_f32_encode_agrees(dir_enc, p_dir)
        assert torch.equal(dir_enc.view(torch.int32), again[1].view(torch.int32))


@pytest.mark.parametrize("pos_xyz_dim", [12, 16])
@pytest.mark.parametrize("xyz_dim", [1, 3, 4])
def test_wide_f32_encode_kernel_takes_sinf_past_the_reduction_limit(cuda_device, xyz_dim,
                                                                    pos_xyz_dim):
    """The renderer's ranges times 6,667 (fg coordinates up to 1e4): x 2^k
    passes sinf's Cody-Waite limit (105,615) from k = 4 on, and those lanes
    take sinf itself; the same agreement as in the renderer's ranges."""
    fw, packed, xyz, dirs = _f32_encode_case(cuda_device, xyz_dim, pos_xyz_dim, 4, 1000,
                                             spread=1e4 / 1.5)
    assert xyz.abs().max().item() * 2 ** (pos_xyz_dim - 1) > 105_615
    with torch.no_grad():
        enc, dir_enc = fw.eval_wide_encode(packed, xyz, dirs)
        p_enc, p_dir = fw.eval_wide_encode_plain(packed, xyz, dirs)
    torch.cuda.synchronize()
    _assert_f32_encode_agrees(enc, p_enc)
    _assert_f32_encode_agrees(dir_enc, p_dir)


def test_wide_f32_encode_refuses_misaligned_outputs(cuda_device):
    """A given f32 enc or dir_enc off 16-byte alignment (the kernel stores
    16-byte chunks) raises, without a launch or a plain call."""
    from mega_nerf_tpu_torch.render import fused_wide_f32 as fwf

    fw, packed, xyz, dirs = _f32_encode_case(cuda_device, 3, 12, 4, 64)
    enc = torch.empty(64 * packed.ep + 4, device=cuda_device)[4:].view(64, packed.ep)
    dir_enc = torch.empty(64 * packed.dp + 4, device=cuda_device)[4:].view(64, packed.dp)
    launches, calls = fwf.wide_f32_encode.launches, fw.eval_wide_encode_plain.calls
    for given in ({"enc": torch.empty(64 * packed.ep + 1, device=cuda_device)[1:].view(
                       64, packed.ep)},
                  {"dir_enc": torch.empty(64 * packed.dp + 1, device=cuda_device)[1:].view(
                       64, packed.dp)}):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fw.eval_wide_encode(packed, xyz, dirs, **given)
    fw.eval_wide_encode(packed, xyz, dirs, enc=enc, dir_enc=dir_enc)  # aligned: fine
    torch.cuda.synchronize()
    assert fwf.wide_f32_encode.launches == launches + 1
    assert fw.eval_wide_encode_plain.calls == calls


@pytest.mark.parametrize("bg", [False, True])
def test_wide_eval_repeats_bitwise_across_sub_chunks(cuda_device, bg, monkeypatch):
    """Two launches give the same bits, and so does the same eval cut into
    sub-chunks of 4,096 points (every kernel's rows are independent), on
    20,011 points at width 1024; M = 0 launches nothing."""
    import dataclasses

    fw, packed, xyz, dirs, app = _wide_case(
        cuda_device, bg, {"layer_dim": 1024, "appearance_dim": 48}, 20_011)
    launches = fw.wide_kernel_launches()
    with torch.no_grad():
        first = fw.fused_nerf_eval_wide(packed, xyz, dirs, app)
        again = fw.fused_nerf_eval_wide(packed, xyz, dirs, app)
        plan = fw.wide_plan(packed.config)
        monkeypatch.setattr(fw, "wide_plan",
                            lambda cfg: dataclasses.replace(plan, sub_chunk=4096))
        cut = fw.fused_nerf_eval_wide(packed, xyz, dirs, app)
        empty = fw.fused_nerf_eval_wide(packed, xyz[:0], dirs[:0], app[:0])
    torch.cuda.synchronize()
    per_pass = 2 + packed.config.layers + 2
    assert fw.wide_kernel_launches() == launches + per_pass * (1 + 1 + 5)
    assert torch.isfinite(first).all() and empty.shape == (0, 4)
    assert torch.equal(first, again)
    assert torch.equal(first, cut)


def test_wide_wrappers_raise_and_never_fall_back(cuda_device):
    """On CUDA tensors of the wrong dtype or layout each wide wrapper
    raises, without a launch and without running a plain version; f32
    compute runs the f32 wide kernels (`wide_f32.cu`), within 1e-4 of the
    plain version (TF32 off), with no bf16 launch; an f32 compute dtype
    over bf16 weights raises."""
    fw, packed, xyz, dirs, app = _wide_case(
        cuda_device, False, {"layer_dim": 640, "appearance_dim": 48}, 256)
    cfg = packed.config
    launches = fw.wide_kernel_launches()
    calls = (fw.fused_nerf_eval_wide_plain.calls, fw.eval_wide_layer_plain.calls,
             fw.eval_wide_encode_plain.calls, fw.eval_wide_heads_plain.calls)
    h = torch.zeros((256, 640), dtype=torch.bfloat16, device=cuda_device)
    w, b = packed.mats[1], packed.biases[1]
    with pytest.raises(ValueError):
        fw.fused_nerf_eval_wide(packed, xyz.double(), dirs, app)
    with pytest.raises(ValueError):
        fw.fused_nerf_eval_wide(packed, xyz, dirs, app.float())
    with pytest.raises(ValueError):
        fw.eval_wide_layer([h.float()], w, b, True)  # f32 segment
    with pytest.raises(ValueError):
        fw.eval_wide_layer([h.T.contiguous().T], w, b, True)  # column-major view
    with pytest.raises(ValueError):
        wide = torch.zeros((256, 641), dtype=torch.bfloat16, device=cuda_device)
        fw.eval_wide_layer([wide[:, 1:]], w, b, True)  # base off 16-byte alignment
    with pytest.raises(ValueError):
        fw.eval_wide_layer([h[:, :320]], w, b, True)  # segments miss the columns
    with pytest.raises(ValueError):
        fw.eval_wide_layer([h], w, b.double(), True)
    with pytest.raises(ValueError):
        fw.eval_wide_heads(packed, h.float(), None)
    with pytest.raises(ValueError):
        fw.eval_wide_encode(packed, xyz[:, :2].contiguous(), dirs)
    f32 = _with_compute_dtype(packed, "float32")
    with pytest.raises(ValueError):
        fw.fused_nerf_eval_wide(f32, xyz, dirs, app.float())  # bf16 weights
    assert cfg.dtype == torch.bfloat16
    assert fw.wide_kernel_launches() == launches
    assert calls == (fw.fused_nerf_eval_wide_plain.calls, fw.eval_wide_layer_plain.calls,
                     fw.eval_wide_encode_plain.calls, fw.eval_wide_heads_plain.calls)
    torch.backends.cuda.matmul.allow_tf32 = False
    _, f32, xyz, dirs, app = _wide_case(
        cuda_device, False, {"layer_dim": 640, "appearance_dim": 48,
                             "compute_dtype": "float32"}, 256)
    f32_launches = _wide_f32_counts()
    with torch.no_grad():
        got = fw.fused_nerf_eval_wide(f32, xyz, dirs, app)
        want = fw.fused_nerf_eval_wide_plain(f32, xyz, dirs, app)
    torch.cuda.synchronize()
    assert fw.wide_kernel_launches() == launches
    assert sum(_wide_f32_counts()) > sum(f32_launches)
    err = (got - want).abs()
    assert err[:, :3].max().item() <= 1e-4
    assert (err[:, 3] / (1 + want[:, 3].abs())).max().item() <= 1e-4


def _with_compute_dtype(packed, compute_dtype):
    import dataclasses

    return dataclasses.replace(
        packed, config=dataclasses.replace(packed.config, compute_dtype=compute_dtype))


def _rel(a, b):
    """||a - b|| / ||b||."""
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def _wide_train_case(cuda_device, bg, width, m, appearance_dim=48, pos_dir_dim=4,
                     compute_dtype="bfloat16"):
    """A seeded wide model on the card with its training inputs: points,
    sigma noise rounded to the compute dtype and an output cotangent."""
    from mega_nerf_tpu_torch.render import fused_train_wide

    _, packed, xyz, dirs, app = _wide_case(
        cuda_device, bg, {"layer_dim": width, "appearance_dim": appearance_dim,
                          "pos_dir_dim": pos_dir_dim, "compute_dtype": compute_dtype}, m)
    gen = torch.Generator().manual_seed(9)
    noise = torch.rand((m,), generator=gen).to(packed.config.dtype).float().to(cuda_device)
    g = torch.randn((m, 4), generator=gen).to(cuda_device)
    app = None if app is None else app.float()
    return fused_train_wide, packed, xyz, dirs, app, noise, g


def _wide_train_walk(ftw, packed, saved, g):
    """`walk_backward` -> (worst relative error per kernel, dW launches
    bitwise equal on a repeat)."""
    worst = {k: 0.0 for k in ftw.TRAIN_WIDE_KERNELS}
    same = True
    for kernel, got, want in ftw.walk_backward(packed, saved, g):
        if kernel == ftw.DW_REPEAT:
            same = same and torch.equal(got, want)
        else:
            worst[kernel] = max(worst[kernel], _rel(got, want))
    return worst, same


WIDE_TRAIN_VARIANTS = [
    {},
    {"appearance_dim": 0, "pos_dir_dim": 0},  # no branch: both heads on h
    {"appearance_dim": 5, "pos_dir_dim": 0},  # appearance rows padded to 16
]


@pytest.mark.parametrize("m", [1000, 37])
@pytest.mark.parametrize("kw", WIDE_TRAIN_VARIANTS)
@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("width", [640, 1024])
def test_wide_train_kernels_match_plain(cuda_device, width, bg, kw, m):
    """The wide training route's four kernels against their plain versions
    on the same inputs (each backward kernel fed the plain chain's tensors),
    then the composed forward and backward against the composed plain
    versions. Tolerances: rgb 1e-2 absolute, sigma and the pre-activations
    1e-2 (1 + |x|), every backward tensor a relative norm 1e-2 (bf16
    operands, another summation order). M = 1,000 and 37: not multiples of
    the 128-point tile or the 64-point stage; with the branch, without it,
    and with appearance rows that are not 16 bytes wide."""
    ftw, packed, xyz, dirs, app, noise, g = _wide_train_case(cuda_device, bg, width, m,
                                                             **kw)
    cfg = packed.config
    launches = ftw.wide_train_kernel_launches()
    with torch.no_grad():
        want, saved = ftw.fused_nerf_train_wide_fwd_plain(packed, xyz, dirs, app, noise)
        out, pre = ftw.train_wide_heads_fwd(packed, saved[f"h{cfg.layers - 1}"],
                                            saved.get("branch"), noise)
        worst, same = _wide_train_walk(ftw, packed, saved, g)
        got, k_saved = ftw.fused_nerf_train_wide_fwd(packed, xyz, dirs, app, noise)
        flat, d_app = ftw.fused_nerf_train_wide_bwd(packed, saved, g)
        p_flat2, p_d_app = ftw.fused_nerf_train_wide_bwd_plain(packed, saved, g)
    torch.cuda.synchronize()
    assert ftw.wide_train_kernel_launches() > launches
    for o, ref in ((out, want), (got, want)):
        assert o.shape == (m, 4) and torch.isfinite(o).all()
        err = (o - ref).abs()
        assert err[:, :3].max().item() <= 1e-2
        assert (err[:, 3] / (1 + ref[:, 3].abs())).max().item() <= 1e-2
    assert _close(pre, saved["pre"]) <= 1e-2
    assert set(k_saved) == set(saved)
    assert max(worst.values()) <= 1e-2, worst
    assert same
    assert torch.isfinite(flat).all()
    from mega_nerf_tpu_torch.render.fused_train import split_grads

    for a, b in zip(split_grads(packed, flat), split_grads(packed, p_flat2)):
        assert _rel(a, b) <= 1e-2
    if cfg.appearance_dim:
        assert d_app.shape == (m, cfg.appearance_dim) and _rel(d_app, p_d_app) <= 1e-2


@pytest.mark.parametrize("bg", [False, True])
def test_wide_train_dw_repeats_bitwise(cuda_device, bg):
    """Two launches of every dW launch of the plan give the same bits
    (splits summed in a fixed order) on 20,011 points at width 1024, and so
    does the whole backward run twice."""
    ftw, packed, xyz, dirs, app, noise, g = _wide_train_case(cuda_device, bg, 1024,
                                                             20_011)
    with torch.no_grad():
        _, saved = ftw.fused_nerf_train_wide_fwd(packed, xyz, dirs, app, noise)
        _, same = _wide_train_walk(ftw, packed, saved, g)
        first, d_app = ftw.fused_nerf_train_wide_bwd(packed, saved, g)
        again, d_app2 = ftw.fused_nerf_train_wide_bwd(packed, saved, g)
    torch.cuda.synchronize()
    assert same
    assert torch.isfinite(first).all()
    assert torch.equal(first, again) and torch.equal(d_app, d_app2)


def test_wide_train_wrappers_raise_and_never_fall_back(cuda_device):
    """On CUDA tensors of the wrong dtype or layout each wide training
    wrapper raises, without a launch and without running a plain version;
    an f32 compute dtype over bf16 weights and rows raises too, and f32
    compute runs the f32 wide kernels, within 1e-4 of the plain versions
    (TF32 off), with no bf16 launch."""
    ftw, packed, xyz, dirs, app, noise, g = _wide_train_case(cuda_device, False, 640, 256)
    from mega_nerf_tpu_torch.render import fused_train as ft

    plain = (ftw.train_wide_heads_fwd_plain, ftw.train_wide_heads_bwd_plain,
             ftw.train_wide_dx_plain, ftw.train_wide_dw_plain,
             ftw.fused_nerf_train_wide_fwd_plain, ftw.fused_nerf_train_wide_bwd_plain)
    calls = [f.calls for f in plain]
    launches = ftw.wide_train_kernel_launches()
    bf = dict(dtype=torch.bfloat16, device=cuda_device)
    h = torch.zeros((256, 640), **bf)
    branch = torch.zeros((256, 320), **bf)
    pre = torch.zeros((256, 4), device=cuda_device)
    wt = ft.transposed_weights(packed)[2]
    rows = torch.zeros((256, ftw.HEADS_GRAD_WIDTH), **bf)
    out = torch.zeros(ftw.check_plan(packed).total, device=cuda_device)
    job = ftw.check_plan(packed).steps[-1][1]
    with pytest.raises(ValueError):
        ftw.train_wide_heads_fwd(packed, h.float(), branch, noise)
    with pytest.raises(ValueError):
        ftw.train_wide_heads_fwd(packed, h, branch, noise.double())
    with pytest.raises(ValueError):
        ftw.train_wide_heads_bwd(packed, g.double(), pre, h, branch)
    with pytest.raises(ValueError):
        ftw.train_wide_heads_bwd(packed, g, pre, h, branch[:, :64].contiguous())
    with pytest.raises(ValueError):
        ftw.train_wide_dx(h.float(), wt, 0, 640, ftw.DX_MASK, h)
    with pytest.raises(ValueError):
        ftw.train_wide_dx(h, wt, 0, 640, ftw.DX_MASK, None)  # no mask
    with pytest.raises(ValueError):
        ftw.train_wide_dx(h, wt, 100, 640, ftw.DX_NONE)  # rows past the matrix
    with pytest.raises(ValueError):
        ftw.train_wide_dx(h, wt, 0, 640, ftw.DX_MASK_SIGMA, h, None, packed.sigma_w)
    with pytest.raises(ValueError):
        ftw.train_wide_dw(job, {"g_pre0": h.float(), "enc": h}, out)
    with pytest.raises(ValueError):
        ftw.train_wide_dw(job, {"g_pre0": h, "enc": h}, out.double())
    with pytest.raises(ValueError):
        ftw.train_wide_dw(job, {"g_pre0": h, "enc": h}, out[:100])  # past the buffer
    f32 = _with_compute_dtype(packed, "float32")
    with pytest.raises(ValueError):
        ftw.fused_nerf_train_wide_fwd(f32, xyz, dirs, app, noise)  # bf16 weights
    with pytest.raises(ValueError):
        ftw.train_wide_heads_bwd(f32, g, pre, h, branch)
    assert rows.shape[1] == 16
    assert ftw.wide_train_kernel_launches() == launches
    assert [f.calls for f in plain] == calls
    torch.backends.cuda.matmul.allow_tf32 = False
    ftw, f32, xyz, dirs, app, noise, g = _wide_train_case(cuda_device, False, 640, 256,
                                                          compute_dtype="float32")
    f32_launches = _wide_f32_counts()
    with torch.no_grad():
        out, saved = ftw.fused_nerf_train_wide_fwd(f32, xyz, dirs, app, noise)
        want, p_saved = ftw.fused_nerf_train_wide_fwd_plain(f32, xyz, dirs, app, noise)
        flat, d_app = ftw.fused_nerf_train_wide_bwd(f32, p_saved, g)
        p_flat, p_d_app = ftw.fused_nerf_train_wide_bwd_plain(f32, p_saved, g)
    torch.cuda.synchronize()
    assert ftw.wide_train_kernel_launches() == launches
    assert sum(_wide_f32_counts()) > sum(f32_launches)
    assert (out - want).abs().max().item() <= 1e-4 * (1 + want.abs().max().item())
    assert _rel(flat, p_flat) <= 1e-4 and _rel(d_app, p_d_app) <= 1e-4


# The persistent GEMMs (eval_wide_layer, train_wide_dx) at many tiles per CTA:
# 100,003 points (782 point tiles, the last one ragged) against the card's
# one CTA per SM, and at forced small counts: 1 and 7 clusters of two CTAs
# (eval_wide_layer), 1 and 7 CTAs (train_wide_dx).
WALK_POINTS = 100_003
WIDE_LAYOUTS = {  # name: (segment widths, output columns, relu) at width d
    "trunk": lambda d: ([d], d, True),
    "final": lambda d: ([d], d, False),  # trunk_final: no ReLU
    "skip": lambda d: ([80, d], d, True),  # [enc | h]
    "dir_a": lambda d: ([d, 32, 48], d // 2, True),  # [final | dir | app]
    "dir_a_no_app": lambda d: ([d, 32], d // 2, True),
    "dir_a_no_dir": lambda d: ([d, 48], d // 2, True),
}


@pytest.mark.parametrize("layout", list(WIDE_LAYOUTS))
@pytest.mark.parametrize("width", [640, 1024, 2048])
def test_wide_layer_persistent_walk_matches_plain(cuda_device, width, layout):
    """`eval_wide_layer` on 100,003 points in every segment layout of the
    chain (one segment, the skip's two, dir_a's three or two), with and
    without the ReLU, at widths 640 (N not a multiple of 256, and 320 for
    dir_a), 1024 and 2048: within 1e-2 (1 + |y|) of its plain version
    (another summation order can flip one bf16 rounding); two launches give
    the same bits, and so do launches on 1 and on 7 clusters of two CTAs,
    each walking many tiles (every tile is computed the same way whatever
    CTA takes it)."""
    from mega_nerf_tpu_torch.render import fused_wide as fw

    widths, n, relu = WIDE_LAYOUTS[layout](width)
    gen = torch.Generator().manual_seed(width + 7 * len(widths) + n)
    m = WALK_POINTS
    xs = [(torch.randn((m, w), generator=gen) * 0.5).to(torch.bfloat16).to(cuda_device)
          for w in widths]
    cols = fw.segment_columns(widths)
    ktot = cols[-1] + -(-widths[-1] // 16) * 16
    w = (torch.randn((n, ktot), generator=gen) / ktot ** 0.5).to(torch.bfloat16)
    b = 0.1 * torch.randn((n,), generator=gen)
    w, b = w.to(cuda_device), b.to(cuda_device)
    launches = fw.eval_wide_layer.launches
    with torch.no_grad():
        got = fw.eval_wide_layer(xs, w, b, relu)
        again = fw.eval_wide_layer(xs, w, b, relu)
        few = [fw.eval_wide_layer(xs, w, b, relu, grid=2 * c) for c in (1, 7)]
        want = fw.eval_wide_layer_plain(xs, w, b, relu)
    torch.cuda.synchronize()
    assert fw.eval_wide_layer.launches == launches + 4
    assert got.shape == (m, n) and torch.isfinite(got.float()).all()
    assert _close(got, want) <= 1e-2
    assert torch.equal(got, again)
    for out in few:
        assert torch.equal(got, out)


@pytest.mark.parametrize("mode", ["f32", "none", "mask", "mask_sigma"])
@pytest.mark.parametrize("width", [640, 1024])
def test_wide_dx_persistent_walk_matches_plain(cuda_device, width, mode):
    """`train_wide_dx` on 100,003 points in each epilogue mode (d_app in f32
    at the appearance width 48, unmasked bf16, the ReLU mask of a saved
    output, the mask after the sigma term), from rows 32 on of a transposed
    matrix: a relative norm within 1e-2 of its plain version (bf16
    operands, another summation order); two launches give the same bits,
    and so do launches on 1 and on 7 CTAs."""
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw

    modes = {"f32": ftw.DX_F32, "none": ftw.DX_NONE, "mask": ftw.DX_MASK,
             "mask_sigma": ftw.DX_MASK_SIGMA}
    code = modes[mode]
    m, k, row0 = WALK_POINTS, 48 if mode == "f32" else width, 32
    gen = torch.Generator().manual_seed(width + code)
    bf = lambda t: t.to(torch.bfloat16).to(cuda_device)  # noqa: E731
    g = bf(torch.randn((m, width), generator=gen) * 1e-2)
    wt = bf(torch.randn((row0 + k, width), generator=gen) / width ** 0.5)
    mask = bf(torch.randn((m, k), generator=gen)) if mode.startswith("mask") else None
    g_heads = bf(torch.randn((m, ftw.HEADS_GRAD_WIDTH), generator=gen) * 1e-2)
    w_sigma = bf(torch.randn((k,), generator=gen))
    if mode != "mask_sigma":
        g_heads = w_sigma = None
    args = (g, wt, row0, k, code, mask, g_heads, w_sigma)
    launches = ftw.train_wide_dx.launches
    with torch.no_grad():
        got = ftw.train_wide_dx(*args)
        again = ftw.train_wide_dx(*args)
        few = [ftw.train_wide_dx(*args, grid=c) for c in (1, 7)]
        want = ftw.train_wide_dx_plain(*args)
    torch.cuda.synchronize()
    assert ftw.train_wide_dx.launches == launches + 4
    assert got.shape == (m, k) and torch.isfinite(got.float()).all()
    assert got.dtype == (torch.float32 if mode == "f32" else torch.bfloat16)
    assert _rel(got, want) <= 1e-2
    if mask is not None:  # what the mask zeroes stays zero
        assert (got[mask.float() <= 0] == 0).all()
    assert torch.equal(got, again)
    for out in few:
        assert torch.equal(got, out)


def _dw_launch_tensors(job, plan, m, gen, device):
    """Seeded bf16 rows for every tensor a dW launch of `plan` reads, each
    as wide as the plan keeps it (the gradients as their jobs read them)."""
    widths = dict(plan.saved)
    tensors = {}
    for j in job:
        for name in (j.d, j.x):
            if name not in tensors:
                width = widths.get(name) or max(jj.d_col + jj.n for jj in job
                                                if jj.d == name)
                if name == "g_heads":
                    width = 16
                rows = torch.randn((m, width), generator=gen) * (1e-2 if j.d == name else 1)
                tensors[name] = rows.to(torch.bfloat16).to(device)
    return tensors


@pytest.mark.parametrize("grid", [None, 512, 14, 2])
@pytest.mark.parametrize("bg", [False, True])
def test_wide_dw_persistent_walk_matches_plain(cuda_device, bg, grid):
    """Every dW launch of the 1024-wide plan (the heads, dir_a's three
    jobs, trunk_final, the trunk, the skip layer's two jobs, layer 0) on
    100,003 points (the last 64-point stage ragged), at the default grid,
    at 256 clusters (the most a launch takes: short units, many partials
    per tile) and at 7 and 1 clusters (each walking many units, each unit
    many chains of products): a relative norm within 1e-2 of
    `train_wide_dw_plain` for every weight and bias gradient (bf16
    operands, another summation order), and two launches at one grid give
    the same bits."""
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw

    packed = _wide_train_case(cuda_device, bg, 1024, 64)[1]
    plan = ftw.check_plan(packed)
    gen = torch.Generator().manual_seed(11 + bg)
    m = WALK_POINTS
    launches = ftw.train_wide_dw.launches
    count = 0
    for kind, job in plan.steps:
        if kind != "dw":
            continue
        tensors = _dw_launch_tensors(job, plan, m, gen, cuda_device)
        want = ftw.train_wide_dw_plain(job, tensors, torch.zeros(plan.total,
                                                                 device=cuda_device))
        got = ftw.train_wide_dw(job, tensors, torch.zeros_like(want), grid)
        again = ftw.train_wide_dw(job, tensors, torch.zeros_like(want), grid)
        count += 2
        torch.cuda.synchronize()
        assert torch.equal(got, again), job
        for j in job:
            rows = slice(j.out_off, j.out_off + j.n * j.out_stride)
            a = got[rows].view(j.n, j.out_stride)[:, :j.k]
            b = want[rows].view(j.n, j.out_stride)[:, :j.k]
            assert torch.isfinite(a).all() and _rel(a, b) <= 1e-2, j
            if j.bias_off >= 0:
                bias = slice(j.bias_off, j.bias_off + j.n)
                assert _rel(got[bias], want[bias]) <= 1e-2, j
    assert ftw.train_wide_dw.launches == launches + count


def test_wide_dw_refuses_what_its_kernel_cannot_take(cuda_device):
    """`train_wide_dw` on the card refuses, before any launch, a job whose
    k is not a multiple of 4 (the kernel's sums store four columns at a
    time), a d_col off 16 bytes (TMA boxes) and a grid that is not 1-256
    whole clusters; it never falls back to its plain version."""
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw

    m = 1000
    tensors = {"d": torch.ones((m, 64), dtype=torch.bfloat16, device=cuda_device),
               "x": torch.ones((m, 64), dtype=torch.bfloat16, device=cuda_device)}
    out = torch.zeros(64 * 64 + 64, device=cuda_device)
    good = ftw.DwJob("d", 0, 32, "x", 64, 0, 64, 64 * 64)
    launches, calls = ftw.train_wide_dw.launches, ftw.train_wide_dw_plain.calls
    for job, grid in [(good._replace(k=62), None), (good._replace(d_col=4), None),
                      (good, 3), (good, 0), (good, 2 * ftw.DW_MAX_WORKERS + 2)]:
        with pytest.raises(ValueError):
            ftw.train_wide_dw([job], tensors, out, grid)
    assert ftw.train_wide_dw.launches == launches
    assert ftw.train_wide_dw_plain.calls == calls
    ftw.train_wide_dw([good], tensors, out)
    torch.cuda.synchronize()
    assert ftw.train_wide_dw.launches == launches + 1
    assert torch.equal(out[:32 * 64].view(32, 64), torch.full((32, 64), float(m),
                                                               device=cuda_device))


def _wide_f32_counts():
    """Launches of the four kernels of `wide_f32.cu` and of the f32 weight
    gradient (`train_f32.cu`)."""
    from mega_nerf_tpu_torch.render import fused_f32
    from mega_nerf_tpu_torch.render import fused_wide_f32 as fwf

    return [getattr(fwf, k).launches for k in fwf.WIDE_F32_KERNELS] + [
        fused_f32.weight_grad_f32.launches]


def _bf16_wide_counts():
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw
    from mega_nerf_tpu_torch.render import fused_wide as fw

    return fw.wide_kernel_launches() + ftw.wide_train_kernel_launches()


@pytest.mark.parametrize("m", [1000, 37])
@pytest.mark.parametrize("kw", WIDE_VARIANTS)
@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("width", [640, 1024])
def test_wide_f32_eval_kernels_match_plain(cuda_device, width, bg, kw, m):
    """f32 compute at widths 640 and 1024 (`wide_f32.cu`), TF32 off: the
    encode (1e-4 (1 + |x|): precise sinf against torch.sin), every layer of
    the chain fed the plain chain's input (1e-4 (1 + |y|)), the heads and
    the whole wide eval (rgb 1e-4, sigma 1e-4 (1 + |s|)); true f32 on both
    sides, the sums in another order. Only the f32 kernels launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    fw, packed, xyz, dirs, app = _wide_case(
        cuda_device, bg, {"layer_dim": width, "compute_dtype": "float32", **kw}, m)
    cfg = packed.config
    before, bf16 = _wide_f32_counts(), _bf16_wide_counts()
    with torch.no_grad():
        enc, dir_enc = fw.eval_wide_encode(packed, xyz, dirs)
        p_enc, p_dir = fw.eval_wide_encode_plain(packed, xyz, dirs)
        assert enc.dtype == torch.float32 and _close(enc, p_enc) <= 1e-4
        if packed.dp:
            assert _close(dir_enc, p_dir) <= 1e-4
        h = p_enc
        for i in range(cfg.layers):
            xs = [p_enc, h] if i in cfg.skip_layers else [h]
            got = fw.eval_wide_layer(xs, packed.mats[i], packed.biases[i], True)
            h = fw.eval_wide_layer_plain(xs, packed.mats[i], packed.biases[i], True)
            assert got.dtype == torch.float32 and _close(got, h) <= 1e-4, i
        branch = None
        if packed.has_branch:
            w, b = packed.mats[cfg.layers], packed.biases[cfg.layers]
            got = fw.eval_wide_layer([h], w, b, False)
            final = fw.eval_wide_layer_plain([h], w, b, False)
            assert _close(got, final) <= 1e-4
            xs = [final] + ([p_dir] if packed.dp else []) + ([app] if packed.ap else [])
            w, b = packed.mats[cfg.layers + 1], packed.biases[cfg.layers + 1]
            got = fw.eval_wide_layer(xs, w, b, True)
            branch = fw.eval_wide_layer_plain(xs, w, b, True)
            assert _close(got, branch) <= 1e-4
        heads = fw.eval_wide_heads(packed, h, branch)
        p_heads = fw.eval_wide_heads_plain(packed, h, branch)
        got = fw.fused_nerf_eval_wide(packed, xyz, dirs, app)
        want = fw.fused_nerf_eval_wide_plain(packed, xyz, dirs, app)
    torch.cuda.synchronize()
    assert _bf16_wide_counts() == bf16
    assert all(a > b for a, b in zip(_wide_f32_counts()[:3], before[:3]))
    for out, ref in ((heads, p_heads), (got, want)):
        assert out.shape == (m, 4) and torch.isfinite(out).all()
        err = (out - ref).abs()
        assert err[:, :3].max().item() <= 1e-4
        assert (err[:, 3] / (1 + ref[:, 3].abs())).max().item() <= 1e-4


@pytest.mark.parametrize("m", [1000, 37])
@pytest.mark.parametrize("kw", WIDE_TRAIN_VARIANTS)
@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("width", [640, 1024])
def test_wide_f32_train_kernels_match_plain(cuda_device, width, bg, kw, m):
    """The wide training route in f32 (`wide_f32.cu` and the f32 weight
    gradient), TF32 off, each kernel against its plain version on the same
    inputs (`walk_backward`), then the composed forward and backward:
    rgb 1e-4, sigma and the pre-activations 1e-4 (1 + |x|), every backward
    tensor and d_app a relative norm 1e-4; dW launches repeat bit for bit;
    the eval heads equal the training heads without noise bit for bit.
    Only the f32 kernels launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ftw, packed, xyz, dirs, app, noise, g = _wide_train_case(
        cuda_device, bg, width, m, compute_dtype="float32", **kw)
    from mega_nerf_tpu_torch.render import fused_wide as fw
    from mega_nerf_tpu_torch.render.fused_train import split_grads

    cfg = packed.config
    before, bf16 = _wide_f32_counts(), _bf16_wide_counts()
    with torch.no_grad():
        want, saved = ftw.fused_nerf_train_wide_fwd_plain(packed, xyz, dirs, app, noise)
        h_last = saved[f"h{cfg.layers - 1}"]
        out, pre = ftw.train_wide_heads_fwd(packed, h_last, saved.get("branch"), noise)
        clean, _ = ftw.train_wide_heads_fwd(packed, h_last, saved.get("branch"), None)
        ev = fw.eval_wide_heads(packed, h_last, saved.get("branch"))
        worst, same = _wide_train_walk(ftw, packed, saved, g)
        got, k_saved = ftw.fused_nerf_train_wide_fwd(packed, xyz, dirs, app, noise)
        flat, d_app = ftw.fused_nerf_train_wide_bwd(packed, saved, g)
        p_flat, p_d_app = ftw.fused_nerf_train_wide_bwd_plain(packed, saved, g)
    torch.cuda.synchronize()
    assert _bf16_wide_counts() == bf16
    assert all(a > b for a, b in zip(_wide_f32_counts(), before))
    for o, ref in ((out, want), (got, want)):
        assert o.shape == (m, 4) and torch.isfinite(o).all()
        err = (o - ref).abs()
        assert err[:, :3].max().item() <= 1e-4
        assert (err[:, 3] / (1 + ref[:, 3].abs())).max().item() <= 1e-4
    assert _close(pre, saved["pre"]) <= 1e-4
    assert torch.equal(ev, clean)
    assert set(k_saved) == set(saved)
    assert all(t.dtype == torch.float32 for t in k_saved.values())
    assert max(worst.values()) <= 1e-4, worst
    assert same
    for a, b in zip(split_grads(packed, flat), split_grads(packed, p_flat)):
        assert torch.isfinite(a).all() and _rel(a, b) <= 1e-4
    if cfg.appearance_dim:
        assert d_app.shape == (m, cfg.appearance_dim) and _rel(d_app, p_d_app) <= 1e-4


@pytest.mark.parametrize("bg", [False, True])
def test_wide_f32_dx_and_dw_repeat_bitwise(cuda_device, bg):
    """f32 at width 1024 on 20,011 points: every dX job and every dW launch
    of the plan, run twice on the same inputs, give the same bits (one
    thread sums each dX output in k order; the dW splits are added in a
    fixed order), and so does the whole backward."""
    ftw, packed, xyz, dirs, app, noise, g = _wide_train_case(
        cuda_device, bg, 1024, 20_011, compute_dtype="float32")
    from mega_nerf_tpu_torch.render.fused_train import transposed_weights

    with torch.no_grad():
        _, saved = ftw.fused_nerf_train_wide_fwd(packed, xyz, dirs, app, noise)
        _, same = _wide_train_walk(ftw, packed, saved, g)
        wts = transposed_weights(packed)
        rows, first_g = ftw.train_wide_heads_bwd(packed, g, saved["pre"],
                                                 saved[f"h{packed.config.layers - 1}"],
                                                 saved.get("branch"))
        plan = ftw.check_plan(packed)
        grads = {"g_heads": rows, plan.first: first_g}
        for kind, job in plan.steps:
            if kind != "dx":
                continue
            args = (grads[job.g], wts[job.mat], job.row0, job.k, job.mode,
                    saved.get(job.mask), rows, packed.sigma_w)
            a, b = ftw.train_wide_dx(*args), ftw.train_wide_dx(*args)
            assert a.dtype == torch.float32 and torch.equal(a, b), job
            grads[job.out] = a
        first, d_app = ftw.fused_nerf_train_wide_bwd(packed, saved, g)
        again, d_app2 = ftw.fused_nerf_train_wide_bwd(packed, saved, g)
    torch.cuda.synchronize()
    assert same
    assert torch.isfinite(first).all()
    assert torch.equal(first, again) and torch.equal(d_app, d_app2)


GEMM_MODES = ["layer", "layer relu", "dx f32", "dx none", "dx mask", "dx mask sigma"]


def _gemm_case(device, width, nseg, m, n, mode, seed):
    """Seeded operands of one f32 wide GEMM call: `nseg` segments in a
    packed layout of `width` (one segment; a skip layer's [enc | h]; the
    dir_a layer's [final | dir | app], dir 27 wide read from rows of 28),
    ReLU activations (layer forms) or signed, half-zero gradient rows (dX
    forms), weights N(0, 1 / K)."""
    from mega_nerf_tpu_torch.render import fused_wide_f32 as fwf
    from mega_nerf_tpu_torch.render.fused_train_wide import (
        DX_F32,
        DX_MASK,
        DX_MASK_SIGMA,
        DX_NONE,
    )

    gen = torch.Generator(device=device).manual_seed(seed)
    widths = [width] if nseg == 1 else ([80, width] if nseg == 2 else [width, 27, 48])
    cols, c = [], 0
    for k in widths:
        cols.append(c)
        c += -(-k // 16) * 16
    xs = []
    for k in widths:
        x = torch.randn((m, -(-k // 4) * 4), generator=gen, device=device)
        x = x.relu() if mode.startswith("layer") else x * (torch.rand(
            x.shape, generator=gen, device=device) > 0.5)
        xs.append(x[:, :k])
    w = torch.randn((n, c), generator=gen, device=device) / c ** 0.5
    code = {"layer": fwf.EPI_LAYER, "layer relu": fwf.EPI_LAYER_RELU, "dx f32": DX_F32,
            "dx none": DX_NONE, "dx mask": DX_MASK, "dx mask sigma": DX_MASK_SIGMA}[mode]
    kw = {}
    if code >= fwf.EPI_LAYER:
        kw["bias"] = torch.randn(n, generator=gen, device=device)
    if code in (DX_MASK, DX_MASK_SIGMA):
        kw["mask"] = torch.randn((m, n), generator=gen, device=device)
    if code == DX_MASK_SIGMA:
        kw["g_heads"] = torch.randn((m, 16), generator=gen, device=device)
        kw["w_sigma"] = torch.randn(n, generator=gen, device=device)
    return xs, w, cols, code, kw


def _gemm_reference(xs, w, cols, code, kw, dtype):
    """The GEMM's function in `dtype` (f32: its plain version, TF32 off;
    f64: the yardstick), the epilogue in the plain version's order."""
    from mega_nerf_tpu_torch.render import fused_wide_f32 as fwf
    from mega_nerf_tpu_torch.render.fused_train_wide import DX_MASK, DX_MASK_SIGMA

    y = sum(x.to(dtype) @ w[:, c:c + x.shape[1]].to(dtype).T for x, c in zip(xs, cols))
    if code >= fwf.EPI_LAYER:
        y = y + kw["bias"].to(dtype)
        if code == fwf.EPI_LAYER_RELU:
            y = y.clamp_min(0)
    if code == DX_MASK_SIGMA:
        y = y + kw["g_heads"][:, :1].to(dtype) * kw["w_sigma"].to(dtype)
    if code in (DX_MASK, DX_MASK_SIGMA):
        y = torch.where(kw["mask"] > 0, y, torch.zeros_like(y))
    return y


@pytest.mark.parametrize("m", [1000, 37])
@pytest.mark.parametrize("nseg", [1, 2, 3])
@pytest.mark.parametrize("mode", GEMM_MODES)
@pytest.mark.parametrize("width", [576, 640, 1024])
def test_wide_f32_gemm_matches_plain_and_f64(cuda_device, width, mode, nseg, m):
    """The f32 wide GEMM (`wide_f32_gemm_kernel`, 3xTF32 on wgmma) at widths
    576, 640 and 1024 with 1-3 segments, every epilogue, ragged M (1,000
    and 37 points: a part tile) and N (576 = 4.5 column tiles): within
    1e-4 (1 + |y|) of its plain version in f32 (TF32 off; the sums in
    another order), within 1e-5 of f64 products of the same f32 rows
    (relative, Frobenius: f32 accuracy), two launches bit for bit equal.
    The dX forms' f32 epilogue also writes an odd width (5 columns, the
    appearance gradient of a 5-wide embedding)."""
    from mega_nerf_tpu_torch.render import fused_wide_f32 as fwf

    torch.backends.cuda.matmul.allow_tf32 = False
    n = 5 if mode == "dx f32" and width == 576 else width
    xs, w, cols, code, kw = _gemm_case(cuda_device, width, nseg, m, n, mode,
                                       width + 7 * nseg + m + len(mode))
    launches = fwf.wide_f32_gemm.launches
    a = fwf.wide_f32_gemm(xs, w, n, code, torch.empty((m, n), device=cuda_device), cols, **kw)
    b = fwf.wide_f32_gemm(xs, w, n, code, torch.empty((m, n), device=cuda_device), cols, **kw)
    torch.cuda.synchronize()
    assert fwf.wide_f32_gemm.launches == launches + 2
    assert torch.isfinite(a).all() and torch.equal(a, b)
    assert _close(a, _gemm_reference(xs, w, cols, code, kw, torch.float32)) <= 1e-4
    ref = _gemm_reference(xs, w, cols, code, kw, torch.float64)
    assert ((a.double() - ref).norm() / ref.norm()).item() <= 1e-5


@pytest.mark.parametrize("mode", ["layer relu", "dx mask sigma"])
def test_wide_f32_gemm_persistent_walk_repeats_bitwise(cuda_device, mode):
    """100,003 points x 1024 columns, three segments: the persistent walk at
    the default grid, at 133, 7 and 1 CTAs (the tests-only `grid`) gives the
    same bits: each output is summed in one fixed order whichever CTA takes
    its tile."""
    from mega_nerf_tpu_torch.render import fused_wide_f32 as fwf

    m, n = 100_003, 1024
    xs, w, cols, code, kw = _gemm_case(cuda_device, 1024, 3, m, n, mode, 25)
    outs = []
    for grid in (None, 133, 7, 1):
        out = torch.empty((m, n), device=cuda_device)
        outs.append(fwf.wide_f32_gemm(xs, w, n, code, out, cols, grid=grid, **kw))
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = _gemm_reference(xs, w, cols, code, kw, torch.float64)
    assert ((outs[0].double() - ref).norm() / ref.norm()).item() <= 1e-5


def test_wide_f32_wrappers_refuse_what_the_kernels_cannot_take(cuda_device):
    """The f32 wide wrappers on the card raise, before any launch and
    without a plain version: bf16 segments or weights, a segment whose rows
    are off 16 bytes, segments that miss the packed columns, a bf16 mask,
    heads rows of the wrong dtype, a dX job past the matrix; nothing falls
    back."""
    ftw, packed, xyz, dirs, app, noise, g = _wide_train_case(
        cuda_device, False, 640, 256, compute_dtype="float32")
    from mega_nerf_tpu_torch.render import fused_train as ft
    from mega_nerf_tpu_torch.render import fused_wide_f32 as fwf

    before = _wide_f32_counts()
    calls = (ftw.train_wide_dx_plain.calls, ftw.train_wide_heads_fwd_plain.calls)
    h = torch.zeros((256, 640), device=cuda_device)
    w, b = packed.mats[1], packed.biases[1]
    wt = ft.transposed_weights(packed)[2]
    odd = torch.zeros((256, 641), device=cuda_device)
    for bad in (lambda: fwf.wide_f32_layer([h.to(torch.bfloat16)], w, b, True),
                lambda: fwf.wide_f32_layer([h], w.to(torch.bfloat16), b, True),
                lambda: fwf.wide_f32_layer([odd[:, 1:]], w, b, True),
                lambda: fwf.wide_f32_layer([h[:, :320]], w, b, True),
                lambda: fwf.wide_f32_dx(h, wt, 0, 640, ftw.DX_MASK,
                                        h.to(torch.bfloat16)),
                lambda: fwf.wide_f32_dx(h, wt, 100, 640, ftw.DX_NONE),
                lambda: fwf.wide_f32_dx(h, wt, 0, 640, ftw.DX_MASK_SIGMA, h, None,
                                        packed.sigma_w),
                lambda: fwf.wide_f32_heads_fwd(packed, h.to(torch.bfloat16),
                                               h[:, :320].contiguous(), noise),
                lambda: fwf.wide_f32_heads_bwd(packed, g, g.double(), h,
                                               h[:, :320].contiguous())):
        with pytest.raises(ValueError):
            bad()
    assert _wide_f32_counts() == before
    assert (ftw.train_wide_dx_plain.calls, ftw.train_wide_heads_fwd_plain.calls) == calls


def _render_counters():
    """Launches of every kernel wrapper and calls of every plain version."""
    from mega_nerf_tpu_torch.render import fused_train as ft
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw
    from mega_nerf_tpu_torch.render import fused_wide as fw

    return (fused_mlp.fused_nerf_eval.launches, fused_mlp.fused_nerf_eval_plain.calls,
            ft.fused_nerf_train_fwd.launches, ft.fused_nerf_train_fwd_plain.calls,
            ft.train_bwd_data.launches, ft.train_bwd_data_plain.calls,
            ft.weight_grad.launches, ft.weight_grad_plain.calls,
            fw.wide_kernel_launches(), fw.fused_nerf_eval_wide_plain.calls,
            ftw.wide_train_kernel_launches())


@pytest.mark.parametrize("train", [False, True])
def test_f32_render_on_the_card_takes_the_f32_kernels(cuda_device, train, monkeypatch):
    """`--compute_dtype float32` at width 256 with the fused kernels on (the
    default): on the card the MLP route takes the f32 kernels. `render_rays`
    in eval and train mode launches them (eval: one `eval_f32` launch a
    pass, 4 passes; train: one of each training kernel a pass), runs no
    plain version and no bf16 kernel, and matches the eager module's
    render (`--no_pallas`) on the same rays and generator seed: values and,
    in train mode, every parameter's gradient within 1e-4 relative (true f32
    on both sides, TF32 off; the sums run in another order). In train mode
    the weight gradient of each pass, launched again on the pass's rows,
    gives the same bits."""
    from mega_nerf_tpu_torch.render import fused_f32
    from mega_nerf_tpu_torch.render import fused_train as ft
    from mega_nerf_tpu_torch.render.rendering import RenderSettings, mlp_route, render_rays

    torch.backends.cuda.matmul.allow_tf32 = False
    hp = tiny_hparams(layer_dim=256, bg_layer_dim=256, appearance_dim=8,
                      compute_dtype="float32")
    gen = torch.Generator().manual_seed(11)
    bundles = []
    for make in (make_nerf, make_bg_nerf):
        bundle = make(hp, 5)
        init_weights(bundle.module, gen)
        bundle.module.to(cuda_device)
        bundles.append(bundle)
    fg, bg = bundles
    assert mlp_route(fg.config, "cuda", train) == (True, "")
    n = 64
    o = (torch.rand((n, 3), generator=gen) - 0.5) * 0.3
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen), dim=-1)
    far = torch.where(torch.arange(n)[:, None] % 2 == 0, 1e5, 0.8)
    rays = torch.cat([o, d, torch.full((n, 1), 0.05), far], -1).to(cuda_device)
    idx = (torch.arange(n) % 5).to(cuda_device)
    center = torch.tensor([0.05, -0.1, 0.0], device=cuda_device)
    radius = torch.tensor([1.4, 1.1, 1.2], device=cuda_device)
    repeats = []
    weight_grad = ft.weight_grad

    def recording_weight_grad(packed, act, grad):
        out = weight_grad(packed, act, grad)
        launches = fused_f32.weight_grad_f32.launches
        repeats.append(torch.equal(out, weight_grad(packed, act, grad)))
        fused_f32.weight_grad_f32.launches = launches  # not the render's launch
        return out

    monkeypatch.setattr(ft, "weight_grad", recording_weight_grad)
    recording_weight_grad.launches = weight_grad.launches  # the bf16 count, unchanged

    def run(fused):
        settings = RenderSettings(coarse_samples=16, fine_samples=16,
                                  use_fused_kernel=fused)
        for b in bundles:
            b.module.zero_grad(set_to_none=True)
        rng = torch.Generator(device=cuda_device).manual_seed(5)
        with torch.set_grad_enabled(train):
            res, _ = render_rays(fg, bg, rays, idx, settings, center, radius,
                                 train=train, generator=rng if train else None)
        grads = []
        if train:
            res["rgb_fine"].square().sum().backward()
            grads = [p.grad.clone() for b in bundles for p in b.module.parameters()
                     if p.grad is not None]
        return res["rgb_fine"].detach(), grads

    before, f32_before = _render_counters(), _f32_counts()
    got, got_grads = run(True)
    torch.cuda.synchronize()
    assert _render_counters() == before
    assert weight_grad.launches == recording_weight_grad.launches
    f32_new = [a - b for a, b in zip(_f32_counts(), f32_before)]
    assert f32_new == ([0, 4, 4, 4] if train else [4, 0, 0, 0])
    assert repeats == ([True] * 4 if train else [])
    want, want_grads = run(False)
    torch.cuda.synchronize()
    assert _render_counters() == before
    assert torch.isfinite(got).all() and got.shape == (n, 3)
    assert _rel(got, want) <= 1e-4
    assert len(got_grads) == len(want_grads) and (not train or got_grads)
    for a, b in zip(got_grads, want_grads):
        assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("margin", [1.0, 1.15])
def test_mixture_render_through_the_eval_kernel_matches_plain(cuda_device, margin,
                                                             monkeypatch, tmp_path):
    """A K = 3 fg and bg mixture (width 64, bf16, a merged native container)
    rendered through `eval_fwd.cu`: one launch per submodule per MLP pass
    (3 x 4), no plain call, each submodule on its own packed weights; the
    same mixture through the kernel's plain version: rgb 1e-2, depth 1e-2
    (1 + |depth|)."""
    from mega_nerf_tpu_torch.models.container import (
        ContainerData,
        container_to_bundles,
        load_container,
        save_native_container,
    )
    from mega_nerf_tpu_torch.render import rendering
    from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays

    k = 3
    hp = tiny_hparams(pos_xyz_dim=12, pos_dir_dim=4, layers=8, skip_layers=[4],
                      layer_dim=64, bg_layer_dim=64, appearance_dim=8,
                      compute_dtype="bfloat16", boundary_margin=margin,
                      mega_routing="auto")
    gen = torch.Generator().manual_seed(21)
    states = {}
    for side, make in (("fg", make_nerf), ("bg", make_bg_nerf)):
        states[side] = []
        for _ in range(k):
            module = make(hp, 5).module
            init_weights(module, gen)
            states[side].append({n: t.numpy() for n, t in module.state_dict().items()})
    centroids = torch.tensor([[0.0, -0.5, -0.2], [0.1, 0.5, -0.3], [-0.1, 0.0, 0.6]])
    data = ContainerData(centroids.numpy(), (k, 1), centroids.numpy().min(0),
                         centroids.numpy().max(0), True, True, False,
                         states["fg"], states["bg"])
    save_native_container(tmp_path / "merged.pt", data)
    fg, bg = container_to_bundles(load_container(tmp_path / "merged.pt"), hp)
    for b in (fg, bg):
        b.module.to(cuda_device)
    n = 512
    o = (torch.rand((n, 3), generator=gen) - 0.5) * 0.3
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen), dim=-1)
    far = torch.where(torch.arange(n)[:, None] % 2 == 0, 1e5, 0.8)
    rays = torch.cat([o, d, torch.full((n, 1), 0.05), far], -1).to(cuda_device)
    idx = (torch.arange(n) % 5).to(cuda_device)
    center = torch.tensor([0.05, -0.1, 0.0], device=cuda_device)
    radius = torch.tensor([1.4, 1.1, 1.2], device=cuda_device)
    settings = RenderSettings(coarse_samples=32, fine_samples=64, get_depth=True)

    before = _render_counters()
    with torch.no_grad():
        got, _ = render_rays(fg, bg, rays, idx, settings, center, radius)
    torch.cuda.synchronize()
    after = _render_counters()
    assert after[0] - before[0] == k * 4 and after[1] == before[1]
    assert set(fg.packed) == set(bg.packed) == {("sub", i) for i in range(k)}
    monkeypatch.setattr(rendering, "fused_nerf_eval", fused_mlp.fused_nerf_eval_plain)
    with torch.no_grad():
        want, _ = render_rays(fg, bg, rays, idx, settings, center, radius)
    assert torch.isfinite(got["rgb_fine"]).all()
    assert (got["rgb_fine"] - want["rgb_fine"]).abs().max().item() <= 1e-2
    depth_err = (got["depth_fine"] - want["depth_fine"]).abs() / (1 + want["depth_fine"].abs())
    assert depth_err.max().item() <= 1e-2


def test_render_of_a_ray_does_not_depend_on_its_row(cuda_device):
    """The culled renderer reorders rays (`support_order`, `tile_order`), so
    a ray's render must not depend on its row in the batch: the same rays
    in index order and permuted give the same bits (fg + bg at 256 + 512
    samples, whose coarse weights give the fine pdf 254-column rows)."""
    from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays

    hp = tiny_hparams(appearance_dim=4, layer_dim=64, bg_layer_dim=64,
                      compute_dtype="bfloat16")  # the eval kernel's route
    gen = torch.Generator().manual_seed(0)
    fg, bg = make_nerf(hp, 3), make_bg_nerf(hp, 3)
    for b in (fg, bg):
        init_weights(b.module, gen)
        b.module.to(cuda_device).eval()
    n = 1024
    o = torch.rand((n, 3), generator=gen) * 0.4 - 0.2
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen), dim=-1)
    far = torch.where(torch.arange(n) % 2 == 0, 1e5, 0.9)[:, None]
    rays = torch.cat([o, d, torch.full((n, 1), 0.05), far], -1).to(cuda_device)
    idx = (torch.arange(n) % 3).to(cuda_device)
    center = torch.tensor([0.0, 0.0, 0.0], device=cuda_device)
    radius = torch.tensor([1.2, 1.0, 1.1], device=cuda_device)
    perm = torch.randperm(n, generator=gen).to(cuda_device)
    settings = RenderSettings(get_depth=True, get_bg_fg_rgb=True)
    with torch.no_grad():
        a, _ = render_rays(fg, bg, rays, idx, settings, center, radius)
        b, _ = render_rays(fg, bg, rays[perm], idx[perm], settings, center, radius)
    inv = torch.argsort(perm)
    for key in a:
        assert torch.equal(a[key], b[key][inv]), key


# Three cells around the origin, and a fourth far away that no point reaches.
MIX_CENTROIDS = [[0.0, -0.5, -0.2], [0.1, 0.5, -0.3], [-0.1, 0.0, 0.6], [0.0, 60.0, 0.0]]


def _mixture(cuda_device, bg, routing, margin, k=3, width=64, seed=0):
    """A fg or bg mixture of K paper-layout submodules (8 layers, 48-d
    appearance, bf16) on the card, seeded random weights."""
    import numpy as np

    hp = tiny_hparams(pos_xyz_dim=12, pos_dir_dim=4, layers=8, skip_layers=[4],
                      layer_dim=width, bg_layer_dim=width, appearance_dim=48,
                      compute_dtype="bfloat16", mega_routing=routing,
                      routing_max_experts=4)
    hp._mega_centroid_metadata = {"centroids": np.asarray(MIX_CENTROIDS[:k], np.float32),
                                  "cluster_2d": False}
    bundle = (make_bg_nerf if bg else make_nerf)(hp, 7)
    bundle.boundary_margin = margin
    gen = torch.Generator().manual_seed(seed)
    init_weights(bundle.module, gen)
    with torch.no_grad():  # small random biases so no layer starts dead
        for name, p in bundle.module.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    bundle.module.to(cuda_device).eval()
    return bundle


def _chunk_points(cuda_device, rays, samples, gen):
    """`samples` points on each of `rays` rays through the cells, with the
    rays' unit directions and appearance indices."""
    o = torch.rand((rays, 1, 3), generator=gen) * 0.4 - 0.2
    d = torch.nn.functional.normalize(torch.randn((rays, 1, 3), generator=gen), dim=-1)
    t = torch.linspace(0.05, 1.2, samples)[None, :, None]
    xyz = (o + d * t).reshape(-1, 3)
    dirs = d.expand(rays, samples, 3).reshape(-1, 3)
    idx = torch.randint(0, 7, (rays,), generator=gen)
    return xyz.to(cuda_device), dirs.to(cuda_device), idx.to(cuda_device)


@pytest.mark.parametrize("margin", [1.0, 1.15])
@pytest.mark.parametrize("routing", ["routed", "ray"])
def test_routed_mixture_chunk_matches_plain(cuda_device, routing, margin, monkeypatch):
    """A routed (per point) and a ray-routed fg mixture chunk of K = 3
    through the eval kernel against the same route through the plain
    version: rgb 1e-2, sigma 1e-2 (1 + |sigma|). Each submodule launches
    once (at most K launches), and the routed blend stays within the
    same tolerance of the dense one (ray routing with full supports, and
    per-point routing where no point holds more than M = 4 weights)."""
    from mega_nerf_tpu_torch.models import mega
    from mega_nerf_tpu_torch.render import rendering
    from mega_nerf_tpu_torch.render.rendering import RenderSettings, query_points

    bundle = _mixture(cuda_device, False, routing, margin)
    rays, samples = 300, 64
    xyz, dirs, idx = _chunk_points(cuda_device, rays, samples, torch.Generator().manual_seed(2))
    experts = None
    if routing == "ray":
        experts = mega.ray_route_experts(torch.ones((rays, 3), dtype=torch.bool),
                                         device=cuda_device)
    settings = RenderSettings()

    def query():
        with torch.no_grad():
            return query_points(bundle, "fine", settings, xyz, dirs, idx, samples=samples,
                                ray_experts=experts)

    launches = fused_mlp.fused_nerf_eval.launches
    got = query()
    torch.cuda.synchronize()
    assert fused_mlp.fused_nerf_eval.launches - launches == 3
    bundle.routing = "dense"
    dense = query()
    bundle.routing = routing
    monkeypatch.setattr(rendering, "fused_nerf_eval", fused_mlp.fused_nerf_eval_plain)
    want = query()
    for ref in (want, dense):
        err = (got - ref).abs()
        assert torch.isfinite(got).all()
        assert err[:, :3].max().item() <= 1e-2
        assert (err[:, 3] / (1 + ref[:, 3].abs())).max().item() <= 1e-2


def _train_launches():
    from mega_nerf_tpu_torch.render import fused_train as ft

    return [ft.fused_nerf_train_fwd.launches, ft.train_bwd_data.launches,
            ft.weight_grad.launches]


def test_joint_mixture_train_step_matches_plain(cuda_device, monkeypatch):
    """One joint-mixture step (K = 3 fg and bg submodules, hard assignment)
    through the training kernels against the plain versions on the same
    batch: loss and every gradient relative 1e-2. Each kernel launches once
    per submodule and pass that got points: at most 4 x K. The same step
    again gives the same bits (the per-point appearance rows' gradient
    included)."""
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render import fused_train as ft
    from mega_nerf_tpu_torch.render.rendering import RenderSettings

    fg = _mixture(cuda_device, False, "auto", 1.0)
    bg = _mixture(cuda_device, True, "auto", 1.0, seed=1)
    center = torch.tensor([0.05, -0.1, 0.0], device=cuda_device)
    radius = torch.tensor([1.4, 1.1, 1.2], device=cuda_device)
    step = TrainStep(fg, bg, RenderSettings(coarse_samples=32, fine_samples=64),
                     1e-3, 0.1, 10, center, radius)
    gen = torch.Generator().manual_seed(3)
    n = 256
    o = torch.rand((n, 3), generator=gen) * 0.3 - 0.15
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen), dim=-1)
    far = torch.where(torch.arange(n) % 2 == 0, 1e5, 0.8)[:, None]
    batch = {"rays": torch.cat([o, d, torch.full((n, 1), 0.05), far], -1).to(cuda_device),
             "rgbs": torch.rand((n, 3), generator=gen).to(cuda_device),
             "img_indices": torch.randint(0, 7, (n,), generator=gen).to(cuda_device)}

    def loss_and_grads():
        for opt in (step.fg_opt, step.bg_opt):
            opt.zero_grad(set_to_none=True)
        loss, _, _ = step.loss(batch, torch.Generator(device=cuda_device).manual_seed(5))
        loss.backward()
        return loss.item(), {f"{side}.{name}": p.grad.detach().clone()
                             for side, b in (("fg", fg), ("bg", bg))
                             for name, p in b.module.named_parameters()
                             if p.grad is not None}

    before = _train_launches()
    k_loss, k_grads = loss_and_grads()
    torch.cuda.synchronize()
    used = [a - b for a, b in zip(_train_launches(), before)]
    assert used[0] == used[1] == used[2] and 4 <= used[0] <= 4 * 3
    again_loss, again = loss_and_grads()
    assert again_loss == k_loss
    assert [n for n, g in k_grads.items() if not torch.equal(again[n], g)] == []
    for name in ("fused_nerf_train_fwd", "train_bwd_data", "weight_grad"):
        monkeypatch.setattr(ft, name, getattr(ft, f"{name}_plain"))
    p_loss, p_grads = loss_and_grads()
    assert abs(k_loss - p_loss) <= 1e-2 * abs(p_loss)
    assert set(k_grads) == set(p_grads) and len(p_grads) > 0
    for name, g in p_grads.items():
        assert _rel(k_grads[name], g) <= 1e-2, name


def test_mixture_submodule_without_points_does_not_launch(cuda_device):
    """A fg mixture whose fourth cell lies far from every sample: a train
    step launches each training kernel for the three others only (2 passes
    x 3), and the fourth submodule gets a zero gradient, as optax gives it,
    so Adam moves it only by its momentum (none on a first step)."""
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render.rendering import RenderSettings

    fg = _mixture(cuda_device, False, "auto", 1.0, k=4)
    step = TrainStep(fg, None, RenderSettings(coarse_samples=32, fine_samples=32),
                     1e-3, 0.1, 10)
    gen = torch.Generator().manual_seed(4)
    n = 200
    o = torch.rand((n, 3), generator=gen) * 0.3 - 0.15
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen), dim=-1)
    batch = {"rays": torch.cat([o, d, torch.full((n, 1), 0.05), torch.full((n, 1), 1.0)],
                               -1).to(cuda_device),
             "rgbs": torch.rand((n, 3), generator=gen).to(cuda_device),
             "img_indices": torch.randint(0, 7, (n,), generator=gen).to(cuda_device)}
    far_before = [p.detach().clone() for p in fg.module[3].parameters()]
    before = _train_launches()
    step(batch, torch.Generator(device=cuda_device).manual_seed(1))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_train_launches(), before)] == [6, 6, 6]
    for p, p0 in zip(fg.module[3].parameters(), far_before):
        assert p.grad is not None and not p.grad.any()
        assert torch.equal(p, p0)
        assert int(step.fg_opt.state[p]["step"]) == 1


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("m", [1, 7, 300])
def test_kernels_at_small_point_counts(cuda_device, bg, m):
    """The point counts a routed pass can hand one submodule: the eval and
    the three training kernels at M = 1, 7 and 300 (the paper layout at
    width 256) against their plain versions: rgb 1e-2, sigma 1e-2
    (1 + |sigma|), backward tensors relative 1e-2."""
    kw = {"appearance_dim": 48, "layer_dim": 256}
    ft, packed, xyz, dirs, app, noise, g = _train_case(cuda_device, bg, kw, m)
    eval_app = app.to(torch.bfloat16)  # the eval kernel's rows (bf16-exact values)
    with torch.no_grad():
        got = fused_mlp.fused_nerf_eval(packed, xyz, dirs, eval_app)
        want = fused_mlp.fused_nerf_eval_plain(packed, xyz, dirs, eval_app)
    out, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
    p_out, p_act = ft.fused_nerf_train_fwd_plain(packed, xyz, dirs, app, noise)
    grad, d_app = ft.train_bwd_data(packed, act, g, noise)
    p_grad, p_d_app = ft.train_bwd_data_plain(packed, act, g, noise)
    flat = ft.weight_grad(packed, act, grad)
    p_flat = ft.weight_grad_plain(packed, act, grad)
    torch.cuda.synchronize()
    for a, b in ((got, want), (out, p_out)):
        err = (a - b).abs()
        assert torch.isfinite(a).all()
        assert err[:, :3].max().item() <= 1e-2
        assert (err[:, 3] / (1 + b[:, 3].abs())).max().item() <= 1e-2
    assert _rel(act, p_act) <= 1e-2
    assert _rel(grad, p_grad) <= 1e-2 and _rel(d_app, p_d_app) <= 1e-2
    offs = ft._offsets(ft.packed_shapes(packed))
    for i in range(len(offs) - 1):
        assert _rel(flat[offs[i]:offs[i + 1]], p_flat[offs[i]:offs[i + 1]]) <= 1e-2, i


def test_data_parallel_step_on_the_card_matches_one_process(cuda_device, tmp_path):
    """Two ranks on the card (`tests/torch_multiprocess_worker.py
    cuda_step`; gloo where they share one card, NCCL where each has its
    own), each with half of a 2,048-ray batch through the training kernels
    at width 64 (paper layout, bf16, fg + bg), gradients averaged over the
    ranks: every averaged gradient within 1e-2 relative of one process's
    kernel step on the whole batch (the card's backward tolerance; another
    summation order and bf16 operands), the same bits on both ranks, and 4
    launches of each training kernel on each rank."""
    # Beside this file: pytest puts the tests directory on the path.
    from torch_multiprocess_worker import spawn

    results = spawn("cuda_step", tmp_path, 2)
    assert results[0]["backend"] == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")
    assert results[0]["hash"] == results[1]["hash"]
    assert all(r["launches"] == [4, 4, 4] for r in results)
    rel = results[0]["rel"]
    assert len(rel) > 0 and max(rel.values()) <= 1e-2, rel
