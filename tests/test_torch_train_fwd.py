"""The training forward kernel's plan (`fused_train.py::train_fwd_plan`),
checked without a GPU: the tile and shared-memory layout `csrc/train_fwd.cu`
follows, at every width the fused kernels admit."""

from argparse import Namespace

import pytest
import torch

from mega_nerf_tpu_torch.models import init_weights, make_nerf
from mega_nerf_tpu_torch.models.nerf import NeRFConfig
from mega_nerf_tpu_torch.render import fused_mlp
from mega_nerf_tpu_torch.render import fused_train as ft

VARIANTS = [  # (pos_dir_dim, appearance_dim): branch with dirs and/or app, or none
    (4, 48), (4, 0), (0, 48), (0, 0),
]


def _config(width, xyz_dim, pos_dir_dim, appearance_dim, **kw):
    return NeRFConfig(pos_xyz_dim=12, pos_dir_dim=pos_dir_dim, layers=8,
                      skip_layers=(4,), layer_dim=width,
                      appearance_dim=appearance_dim, xyz_dim=xyz_dim,
                      compute_dtype="bfloat16", **kw)


def _check_plan(cfg):
    plan = ft.train_fwd_plan(cfg)
    d = cfg.layer_dim
    assert plan.smem_bytes <= ft.FWD_SMEM_LIMIT
    assert plan.tm in (64, 128) and (d <= 256 or plan.tm == 64)
    assert 2 <= plan.stages <= ft.FWD_MAX_STAGES
    # Tiles and ring stages start on the swizzle period and do not overlap.
    o = plan.offsets
    order = ["enc", "dir", "app", "act", "ring", "bar", "sig"]
    assert [o[k] for k in order] == sorted(o[k] for k in order)
    for k in ("enc", "dir", "app", "act", "ring"):
        assert o[k] % 1024 == 0, k
    assert plan.stage_bytes % 1024 == 0
    assert o["bar"] == o["ring"] + plan.stages * plan.stage_bytes
    assert o["sig"] + 4 * plan.tm + ft.FWD_ALIGN == plan.smem_bytes
    # Every matrix's box, and the 64-column slices of weight rows a
    # warpgroup's wgmma reads from it, fit a stage; a warpgroup holds at
    # most 4 x 64 columns.
    for n, ktot in plan.mats:
        assert 128 * min(-(-n // 64) * 64, ft.FWD_BOX_ROWS) <= plan.stage_bytes
        assert ktot % 16 == 0 and n % 8 == 0
        assert n <= (256 if plan.tm == 128 else 512)
    # Box and store coordinates on 16 B.
    for mat, col, row in plan.weight_boxes:
        assert col % 8 == 0 and row % 8 == 0 and col < plan.mats[mat][1]
    covered = []
    for col, w in plan.row_stores:
        assert col % 8 == 0 and w % 8 == 0 and 0 < w <= ft.FWD_BLOCK
        covered += range(col, col + w)
    assert covered == list(range(plan.row_width))  # every column exactly once
    assert plan.row_width * 2 % 16 == 0
    return plan


@pytest.mark.parametrize("width", range(16, 513, 16))
def test_train_fwd_plan_fits_every_admitted_width(width):
    """For every admitted width, fg and bg points, with and without the
    branch, dirs and appearance: the tile fits the 232,448 B a CTA may use,
    every box and row store starts on 16 B, the stores cover each saved
    column once."""
    for xyz_dim in (3, 4):
        for pos_dir_dim, appearance_dim in VARIANTS:
            cfg = _config(width, xyz_dim, pos_dir_dim, appearance_dim)
            assert fused_mlp.supports_fused_kernel(cfg, train=True)[0]
            _check_plan(cfg)


@pytest.mark.parametrize("kw,admitted", [
    ({"layer_dim": 512}, True),
    ({"layer_dim": 528}, False),
    ({"layer_dim": 40}, False),
    ({"rgb_dim": 12, "pos_dir_dim": 0}, False),  # an SH head (no view dirs)
    ({"affine_appearance": True}, False),
    ({"skip_layers": (0,)}, False),
])
def test_train_fwd_plan_admits_what_the_gate_admits(kw, admitted):
    base = dict(pos_xyz_dim=12, pos_dir_dim=4, layers=8, skip_layers=(4,),
                layer_dim=256, appearance_dim=48, compute_dtype="bfloat16")
    base.update(kw)
    cfg = NeRFConfig(**base)
    assert fused_mlp.supports_fused_kernel(cfg, train=True)[0] == admitted
    if admitted:
        _check_plan(cfg)
    else:
        with pytest.raises(NotImplementedError):
            ft.train_fwd_plan(cfg)


@pytest.mark.parametrize("width,appearance_dim,pos_dir_dim", [
    (48, 0, 0), (64, 48, 4), (256, 48, 4), (272, 0, 4),
])
def test_train_fwd_plan_matches_packed_weights(width, appearance_dim, pos_dir_dim):
    """The plan's matrices are the packed ones, and its row width is the
    saved-row layout's."""
    hp = Namespace(pos_xyz_dim=12, pos_dir_dim=pos_dir_dim, layers=6,
                   skip_layers=[3], layer_dim=width, bg_layer_dim=width,
                   appearance_dim=appearance_dim, affine_appearance=False,
                   use_cascade=False, sh_deg=None, shifted_softplus=True,
                   compute_dtype="bfloat16")
    bundle = make_nerf(hp, 3)
    init_weights(bundle.module, torch.Generator().manual_seed(0))
    packed = fused_mlp.pack_params(bundle.module)
    plan = _check_plan(packed.config)
    assert plan.mats == [tuple(w.shape) for w in packed.mats]
    assert plan.row_width == ft.act_layout(packed)["width"]
    boxes_per_mat = [sum(1 for b in plan.weight_boxes if b[0] == i)
                     for i in range(len(plan.mats))]
    # Each input segment of K columns takes ceil(K / 64) boxes per 256 rows.
    for i, (n, ktot) in enumerate(plan.mats):
        assert boxes_per_mat[i] >= -(-ktot // 64) * -(-n // 256)
