"""The port's CUDA kernels on the card: each against its plain version.

Marked `cuda`; each test skips where no CUDA device is present (decided in
the fixture, never at import). On a GPU machine:
`python -m pytest tests/test_torch_cuda.py -m cuda -q`.
"""

import pytest
import torch

from mega_nerf_tpu_torch.models import init_weights, make_bg_nerf, make_nerf
from mega_nerf_tpu_torch.render import fused_mlp
from tests.test_models import tiny_hparams

pytestmark = pytest.mark.cuda


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
