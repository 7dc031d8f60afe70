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


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("kw", [
    {"appearance_dim": 48},
    {"appearance_dim": 0},
    {"appearance_dim": 0, "pos_dir_dim": 0},
])
def test_fused_eval_kernel_matches_plain(cuda_device, bg, kw):
    """bf16 compute; tolerance rgb 1e-2, sigma 1e-2 (1 + |sigma|): the sums
    run in another order, which can flip one bf16 rounding."""
    hp = tiny_hparams(pos_xyz_dim=12, pos_dir_dim=kw.get("pos_dir_dim", 4),
                      layers=8, skip_layers=[4], layer_dim=64, bg_layer_dim=64,
                      appearance_dim=kw["appearance_dim"],
                      compute_dtype="bfloat16")
    bundle = (make_bg_nerf if bg else make_nerf)(hp, 7)
    init_weights(bundle.module, torch.Generator().manual_seed(0))
    bundle.module.to(cuda_device)
    cfg = bundle.config
    packed = fused_mlp.pack_params(bundle.module)
    gen = torch.Generator().manual_seed(1)
    m = 1000  # not a multiple of the kernel's 64-point tile
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
    assert fused_mlp.fused_nerf_eval.launches == launches + 1
    err = (got - want).abs()
    assert err[:, :3].max().item() <= 1e-2
    assert (err[:, 3] / (1 + want[:, 3].abs())).max().item() <= 1e-2


def _train_case(cuda_device, bg, kw, m):
    from mega_nerf_tpu_torch.render import fused_train

    hp = tiny_hparams(pos_xyz_dim=12, pos_dir_dim=kw.get("pos_dir_dim", 4),
                      layers=8, skip_layers=[4], layer_dim=kw.get("layer_dim", 64),
                      bg_layer_dim=kw.get("layer_dim", 64),
                      appearance_dim=kw["appearance_dim"],
                      compute_dtype="bfloat16")
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
    noise = torch.rand((m,), generator=gen).to(torch.bfloat16).float().to(cuda_device)
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
])
def test_fused_train_kernels_match_plain(cuda_device, bg, kw):
    """Each training kernel against its plain version on the same inputs.
    Forward: rgb 1e-2, sigma 1e-2 (1 + |sigma|), saved rows 1e-2 relative.
    Backward-data (from the kernel forward's rows) and weight-gradient (from
    the kernel's gradient rows): relative norm 1e-2 per layer's rows, per
    gradient tensor and d_app (bf16 operands, another summation order).
    20,011 points, not a multiple of the 64-point tile: enough points that
    a single flipped bf16 rounding moves no tensor's relative norm far."""
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
