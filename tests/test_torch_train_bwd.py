"""The backward-data kernel's plan (`fused_train.py::train_bwd_plan`),
checked without a GPU: the tile and shared-memory layout `csrc/train_bwd.cu`
follows at every width the fused kernels admit, the ring's weight boxes
against the transposed matrices, and the plan's products, mask loads and
stores run in numpy as the kernel runs them (zero-filled boxes, the
resident gradient tile) against `train_bwd_data_plain`."""

from argparse import Namespace

import numpy as np
import pytest
import torch

from mega_nerf_tpu_torch.models import init_weights, make_bg_nerf, make_nerf
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
    plan = ft.train_bwd_plan(cfg)
    d = cfg.layer_dim
    assert plan.smem_bytes <= ft.FWD_SMEM_LIMIT
    assert plan.tm == ft.train_fwd_plan(cfg).tm
    assert plan.tm in (64, 128) and (d <= 256 or plan.tm == 64)
    assert 2 <= plan.stages <= ft.FWD_MAX_STAGES
    # Tiles and ring stages start on the swizzle period and do not overlap.
    o = plan.offsets
    order = ["grad", "mask", "ring", "bar", "heads"]
    assert [o[k] for k in order] == sorted(o[k] for k in order)
    for k in ("grad", "mask", "ring"):
        assert o[k] % 1024 == 0, k
    tile = -(-d // 64) * 128 * plan.tm  # D columns in 64-column blocks
    assert o["mask"] - o["grad"] >= tile and o["ring"] - o["mask"] >= tile
    assert plan.stage_bytes % 1024 == 0
    assert o["bar"] == o["ring"] + plan.stages * plan.stage_bytes
    assert o["heads"] == o["bar"] + 16 * plan.stages + 32  # ring + 3 barriers
    assert o["heads"] + 8 * plan.tm + ft.FWD_ALIGN == plan.smem_bytes
    # Every product's boxes fit a stage, and the 64-column slices of rows a
    # warpgroup's wgmma reads from a stage too; a warpgroup holds at most
    # 4 x 64 output columns.
    for mat, row0, n, k, kind, col in plan.products:
        rows, cols = plan.mats[mat]
        assert 128 * min(-(-n // 64) * 64, ft.FWD_BOX_ROWS) <= plan.stage_bytes
        assert n <= (256 if plan.tm == 128 else 512)
        assert k <= d and k % 16 == 0 and cols % 8 == 0 and row0 + n <= rows
        assert col % 8 == 0 or kind == ft.BWD_APP
    for _, col, row in plan.weight_boxes:  # box coordinates on 16 B
        assert col % 8 == 0
    # The mask tile holds D columns; every load starts on 16 B.
    assert len(plan.mask_loads) == 1 + sum(
        kind in (ft.BWD_MASK, ft.BWD_MASK_SIGMA) for *_, kind, _ in plan.products)
    for col, w in plan.mask_loads:
        assert col % 8 == 0 and 0 < w <= d
    col, w = plan.first
    assert col % 8 == 0 and w % 8 == 0 and w <= d
    covered = []
    for col, w in plan.row_stores:
        assert col % 8 == 0 and w % 8 == 0 and 0 < w <= ft.FWD_BLOCK
        covered += range(col, col + w)
    assert covered == list(range(plan.row_width))  # every column exactly once
    assert plan.row_width * 2 % 16 == 0
    # The gradient row's segments: the first, one per product but d_app's,
    # and the heads, each stored once.
    written = [plan.first] + [(c, n) for _, _, n, _, kind, c in plan.products
                              if kind != ft.BWD_APP] + [(plan.row_width - 8, 8)]
    assert sorted(c for s in written for c in range(s[0], s[0] + s[1])) == \
        list(range(plan.row_width))
    return plan


@pytest.mark.parametrize("width", range(16, 513, 16))
def test_train_bwd_plan_fits_every_admitted_width(width):
    """For every admitted width, fg and bg points, with and without the
    branch, dirs and appearance: the tile fits the 232,448 B a CTA may use
    with at least two ring stages, every box, mask load and row store
    starts on 16 B, and the stores cover each gradient-row column once."""
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
def test_train_bwd_plan_admits_what_the_gate_admits(kw, admitted):
    base = dict(pos_xyz_dim=12, pos_dir_dim=4, layers=8, skip_layers=(4,),
                layer_dim=256, appearance_dim=48, compute_dtype="bfloat16")
    base.update(kw)
    cfg = NeRFConfig(**base)
    assert fused_mlp.supports_fused_kernel(cfg, train=True)[0] == admitted
    if admitted:
        _check_plan(cfg)
    else:
        with pytest.raises(NotImplementedError):
            ft.train_bwd_plan(cfg)


def _packed(width, appearance_dim, pos_dir_dim, bg=False, layers=6, skip=3,
            seed=0):
    hp = Namespace(pos_xyz_dim=12, pos_dir_dim=pos_dir_dim, layers=layers,
                   skip_layers=[skip], layer_dim=width, bg_layer_dim=width,
                   appearance_dim=appearance_dim, affine_appearance=False,
                   use_cascade=False, sh_deg=None, shifted_softplus=True,
                   compute_dtype="bfloat16")
    bundle = (make_bg_nerf if bg else make_nerf)(hp, 3)
    gen = torch.Generator().manual_seed(seed)
    init_weights(bundle.module, gen)
    with torch.no_grad():  # small random biases so no layer starts dead
        for name, p in bundle.module.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return bundle, fused_mlp.pack_params(bundle.module)


@pytest.mark.parametrize("width,appearance_dim,pos_dir_dim", [
    (16, 48, 4), (48, 0, 0), (64, 48, 4), (256, 48, 4), (272, 0, 4), (512, 48, 4),
    (512, 0, 0),
])
def test_train_bwd_plan_boxes_cover_every_product_once(width, appearance_dim,
                                                       pos_dir_dim):
    """The ring's boxes, against the shapes of `transposed_weights`: each
    product's K columns are covered by whole 64-column chunks from column
    0, its N rows by boxes of min(N, 256) rows from its first row, each
    (chunk, row range) once, in the kernel's order (product, chunk,
    half); the plan's matrices are the transposed ones."""
    _, packed = _packed(width, appearance_dim, pos_dir_dim)
    plan = _check_plan(packed.config)
    assert plan.mats == [tuple(w.shape) for w in ft.transposed_weights(packed)]
    assert plan.row_width == ft.grad_layout(packed)["width"]
    want = []
    for p, (mat, row0, n, k, kind, col) in enumerate(plan.products):
        rows, cols = plan.mats[mat]
        box_rows = min(n, ft.FWD_BOX_ROWS)
        hit = np.zeros((rows + 2 * ft.FWD_BOX_ROWS, cols + ft.FWD_BLOCK), np.int32)
        for q, c, r in plan.weight_boxes:
            if q == p:
                hit[r:r + box_rows, c:c + ft.FWD_BLOCK] += 1
        assert (hit[row0:row0 + n, :k] == 1).all(), p
        want += [(p, c, row0 + h) for c in range(0, k, ft.FWD_BLOCK)
                 for h in range(0, n, ft.FWD_BOX_ROWS)]
    assert plan.weight_boxes == want


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def emulate_train_bwd(packed, act, g, noise):
    """The backward-data kernel's schedule in numpy, from its plan: the
    heads (taken from the plain version: the kernel's arithmetic there is
    the plain version's), the elementwise first segment, then each product
    from its ring boxes (zero past the matrix) against the resident
    gradient tile (zero past each segment), each epilogue with the mask
    tile loaded from the saved rows (zero past the row and past M), and
    every gradient-row store."""
    cfg = packed.config
    plan = ft.train_bwd_plan(cfg)
    m, d = act.shape[0], cfg.layer_dim
    p_rows, _ = ft.train_bwd_data_plain(packed, act, g, noise)
    heads = p_rows[:, -8:-4].float().numpy()
    gs, g_rgb = heads[:, 0], heads[:, 1:]
    mpad = -(-m // plan.tm) * plan.tm
    aw = act.shape[1]
    rows = np.zeros((mpad, aw + ft.FWD_BLOCK + d), np.float32)
    rows[:m, :aw] = act.float().numpy()
    wts = [w.float().numpy() for w in ft.transposed_weights(packed)]
    w_sig = packed.sigma_w.float().numpy()
    w_rgb = packed.rgb_w.float().numpy()
    bf = lambda a: _bf16(a).float().numpy()  # noqa: E731
    blocks = -(-d // ft.FWD_BLOCK) * ft.FWD_BLOCK
    tile = np.zeros((mpad, blocks), np.float32)
    grad = np.full((m, plan.row_width), np.nan, np.float32)
    grad[:, -8:] = p_rows[:, -8:].float().numpy()
    masks = iter(plan.mask_loads)

    def mask_tile():
        col, w = next(masks)
        return rows[:, col:col + -(-w // ft.FWD_BLOCK) * ft.FWD_BLOCK]

    col, w = plan.first
    rgb_in = w_rgb.shape[1]
    v = np.zeros((mpad, w), np.float32)
    v[:m, :rgb_in] = g_rgb @ w_rgb[:, :w]
    if not packed.has_branch:
        v[:m] = gs[:, None] * w_sig[None] + v[:m]
    tile[:, :w] = bf(np.where(mask_tile()[:, :w] > 0, v, 0))
    grad[:, col:col + w] = tile[:m, :w]
    d_app = np.full((m, cfg.appearance_dim), np.nan, np.float32) if packed.ap else None
    for p, (mat, row0, n, k, kind, col) in enumerate(plan.products):
        box_rows = min(n, ft.FWD_BOX_ROWS)
        wt = np.zeros((wts[mat].shape[0] + 2 * ft.FWD_BOX_ROWS,
                       wts[mat].shape[1] + ft.FWD_BLOCK), np.float32)
        wt[:wts[mat].shape[0], :wts[mat].shape[1]] = wts[mat]
        acc = np.zeros((mpad, 2 * ft.FWD_BOX_ROWS), np.float32)
        for q, c, r in plan.weight_boxes:
            if q == p:
                box = wt[r:r + box_rows, c:c + ft.FWD_BLOCK]
                acc[:, r - row0:r - row0 + box_rows] += \
                    tile[:, c:c + ft.FWD_BLOCK] @ box.T
        out = acc[:, :n]
        if kind == ft.BWD_APP:
            live = min(n, cfg.appearance_dim - col)
            d_app[:, col:col + live] = out[:m, :live]
            continue
        if kind == ft.BWD_MASK_SIGMA:
            out = out.copy()
            out[:m] += gs[:, None] * w_sig[None, :n]
        if kind != ft.BWD_FINAL:
            out = np.where(mask_tile()[:, :n] > 0, out, 0)
        tile[:, :n] = bf(out)
        grad[:, col:col + n] = tile[:m, :n]
    assert next(masks, None) is None
    return torch.from_numpy(grad), None if d_app is None else torch.from_numpy(d_app)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-12)).item()


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("width,appearance_dim,pos_dir_dim,m", [
    (16, 48, 4, 300), (48, 0, 0, 200), (64, 48, 4, 130), (32, 0, 4, 70),
    (272, 48, 4, 70),
])
def test_train_bwd_plan_schedule_matches_plain(bg, width, appearance_dim,
                                               pos_dir_dim, m):
    """The plan run as the kernel runs it, on the plain forward's saved rows
    from seeded inputs, against `train_bwd_data_plain`: relative norm 1e-3
    per gradient-row segment and for d_app (f32 sums in another order can
    flip a bf16 rounding; a wrong box, mask or column moves a segment by
    far more). M is not a multiple of the tile; widths 16 (KB = 16), 48
    (not a multiple of 64), 64, 32 without appearance, and 272 (64-point
    tiles, output columns over two boxes)."""
    bundle, packed = _packed(width, appearance_dim, pos_dir_dim, bg=bg, seed=width)
    cfg = bundle.config
    rng = np.random.default_rng(width + m)
    if cfg.xyz_dim == 3:
        xyz = rng.uniform(-1.5, 1.5, (m, 3))
    else:
        p = rng.normal(size=(m, 3))
        xyz = np.concatenate([p / np.linalg.norm(p, axis=-1, keepdims=True),
                              rng.uniform(0, 1, (m, 1))], -1)
    dirs = rng.normal(size=(m, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    app = None
    if cfg.appearance_dim:
        app = _bf16(rng.normal(scale=0.1, size=(m, cfg.appearance_dim))).float()
    noise = _bf16(rng.uniform(0, 1, m)).float()
    g = t(rng.normal(size=(m, 4)))
    _, act = ft.fused_nerf_train_fwd_plain(packed, t(xyz), t(dirs) if cfg.pos_dir_dim
                                           else None, app, noise)
    want, want_app = ft.train_bwd_data_plain(packed, act, g, noise)
    got, got_app = emulate_train_bwd(packed, act, g, noise)
    assert torch.isfinite(got).all()
    gl = ft.grad_layout(packed)
    segs = [(i * width, width) for i in range(cfg.layers)]
    if packed.has_branch:
        segs += [(gl["dfinal"], width), (gl["da"], ft.branch_k(cfg))]
    segs.append((gl["heads"], 8))
    for col, w in segs:
        assert _rel(got[:, col:col + w], want[:, col:col + w]) <= 1e-3, col
    assert (want_app is None) == (got_app is None)
    if want_app is not None:
        assert _rel(got_app, want_app) <= 1e-3
