"""The wide training MLP (512 < layer_dim <= 1024): one layer at a time.

Counterpart of the JAX package's `render/pallas_train.py` (`_make_train_fn`,
`fused_nerf_train_apply`) at the widths its training gate admits past the
port's fused chain (`fused_train.py`, <= 512). It replaces
`pallas_train.py::_train_fwd_kernel` and `::_train_bwd_kernel` there.

The forward is the wide eval route (`fused_wide.py`) with its layer
outputs kept: `eval_wide_encode`, one `eval_wide_layer` GEMM per matmul
layer, then `train_wide_heads_fwd`. Every tensor the backward reads is a
layer's own output, saved as it is (`TrainWidePlan.saved`): a fused chain
cannot hold a 64-point activation tile past width 512 (256 KB at 1024,
over a CTA's 227 KB), and a 1024 x 1024 layer does ~500 FLOP per byte it
moves, above the card's ridge of ~295, so passing activations through
device memory costs little.

The backward runs the hand-written kernels of `csrc/train_wide.cu`:

- `train_wide_heads_fwd`: the sigma and rgb heads with the sigma noise
  added before the activation -> (M, 4) f32 [rgb, sigma] and the
  pre-activations [rgb_pre, sigma_pre + noise] the backward starts from;
- `train_wide_heads_bwd`: from the (M, 4) cotangent the head derivatives
  g_rgb = g s(1 - s) and g_sigma (shifted softplus or ReLU), as bf16 rows
  (`HEADS_GRAD_WIDTH` columns: g_sigma at 0, g_rgb at `HEADS_RGB_COL`), and
  d_branch_pre = (g_rgb W_rgb) * (branch > 0), or without the branch
  d_pre of the last trunk layer from both heads;
- `train_wide_dx`: one layer's backward-data GEMM, Y = G W[:, cols], on
  `fused_train.transposed_weights`, with an epilogue mode (`DX_*`): f32
  out (d_app), bf16 out (d_final), the ReLU mask of the saved output, or
  that mask after adding g_sigma[p] w_sigma[c] in f32 (the last trunk
  layer, as `_train_bwd_kernel` sums both terms before masking);
- `train_wide_dw`: one packed matrix's weight gradient (or the heads'),
  dW = d_pre^T [X segments] and db = sum d_pre, split over the points and
  reduced in a fixed order, into the flat f32 buffer in
  `fused_train.packed_shapes` order.

`train_wide_plan(cfg)` lists the saved tensors, the backward's steps (dX
jobs and dW launches, in the order they run) and, per step, the gradient
tensors it frees. Each kernel wrapper runs its plain version on CPU
tensors and launches its kernel on CUDA tensors or raises; wrappers count
launches in `.launches`, plain versions their calls in `.calls`.
`fused_train.fused_nerf_train_apply` (the `torch.autograd.Function`) runs
`fused_nerf_train_wide_fwd` and `fused_nerf_train_wide_bwd` past width 512;
`walk_backward` holds each backward kernel against its plain version.

In f32 compute (`--compute_dtype float32`) every wrapper here and of
`fused_wide.py` hands CUDA tensors to its counterpart in
`fused_wide_f32.py`: the true-f32 kernels of `csrc/wide_f32.cu` (encode,
one GEMM for the layers and every dX job, the heads forward and backward)
and the f32 weight-gradient kernel pair of `csrc/train_f32.cu`; the saved
tensors and gradients are f32, the plan is the same.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mega_nerf_tpu_torch.models.nerf import NeRFConfig
from mega_nerf_tpu_torch.render.fused_mlp import (
    MMA_K,
    PackedMLP,
    _check,
    _raise_if,
    _round_up,
)
from mega_nerf_tpu_torch.render.fused_train import (
    _ints,
    _offsets,
    _stream,
    packed_shapes,
    transposed_weights,
)
from mega_nerf_tpu_torch.render.fused_wide import (
    DX_CLUSTER,
    _check_rows,
    _device_rule,
    _longs,
    check_weights_dtype,
    eval_wide_encode,
    eval_wide_encode_plain,
    eval_wide_layer,
    eval_wide_layer_plain,
    wide_grid,
    wide_plan_ints,
    wide_resident_ctas,
)

HEADS_GRAD_WIDTH = 16  # bf16 columns of a heads-gradient row (32 B)
HEADS_RGB_COL = 8  # g_rgb's first column: TMA boxes start on 16 B
# train_wide_dx's epilogues (train_wide.cu MODE_*).
DX_F32 = 0  # f32 out, no mask: d_app
DX_NONE = 1  # bf16 out, no mask: d_final
DX_MASK = 2  # bf16 out, masked by the saved layer output (> 0)
DX_MASK_SIGMA = 3  # the same after adding g_sigma[p] * w_sigma[c] in f32
# train_wide_dw's tiles and limits (train_wide.cu DW_*): 128 (n) x 256 (k)
# output tiles, 64 points per ring stage, a 4-stage ring of 64-point boxes
# (d_pre 64 x 128 and X 64 x 256), barriers, a worker's units and the
# fixup's list of partial slots.
DW_TILE_N = 128
DW_TILE_K = 256
DW_STAGE = 64
DW_STAGES = 4
DW_TILE_ELEMS = DW_TILE_N * DW_TILE_K + DW_TILE_N  # partial tile + bias row
DW_MAX_JOBS = 4
DW_MAX_MAPS = 4
DW_MAX_TILES = 64
DW_MAX_WORKERS = 256
DW_MAX_UNITS = DW_MAX_TILES + 1  # of one worker
DW_SMEM_BYTES = (1024 + DW_STAGES * 2 * DW_STAGE * (DW_TILE_N + DW_TILE_K)
                 + 2 * DW_STAGES * 8 + 16 + 20 * DW_MAX_UNITS + 4 * DW_MAX_WORKERS)
# What the two CTAs of a dW cluster share (train_wide.cu SHARE_*): nothing,
# the X boxes (neighbouring n-tiles of one k-tile) or the d_pre boxes
# (neighbouring k-tiles of one n-tile).
DW_SHARE_NONE, DW_SHARE_X, DW_SHARE_A = 0, 1, 2
DW_CLUSTER = 2  # CTAs of a dW cluster


class DxJob(NamedTuple):
    """One backward-data GEMM: out = mode(g_tensor @ W_mat[:, row0:row0 + k]),
    read from the transposed matrix's rows [row0, row0 + k); `mask` names
    the saved output whose ReLU mask the epilogue applies."""
    g: str
    mat: int
    row0: int
    k: int
    mode: int
    out: str
    mask: Optional[str]


class DwJob(NamedTuple):
    """One weight-gradient product of a dW launch: dW[r][c] (at out_off +
    r * out_stride + c of the flat buffer) = sum_p d[p][d_col + r] x[p][c]
    for r < n, c < k, and db[r] (at bias_off, when >= 0) = sum_p
    d[p][d_col + r]."""
    d: str
    d_col: int
    n: int
    x: str
    k: int
    out_off: int
    out_stride: int
    bias_off: int


class TrainWidePlan(NamedTuple):
    """`saved` (name, bf16 width) of every tensor the forward keeps for the
    backward, plus "pre" (M, 4) f32; `first` the name of the heads
    backward's second output (d_branch_pre "g_a", or "g_pre{L-1}" without
    the branch); `steps` ("dx", DxJob) or ("dw", (DwJob, ...)) in the order
    the backward runs them, and `frees[i]` the gradient tensors no step
    after step i reads."""
    saved: Tuple[Tuple[str, int], ...]
    first: str
    steps: Tuple[Tuple[str, object], ...]
    frees: Tuple[Tuple[str, ...], ...]
    total: int  # f32 elements of the flat gradient buffer


def _h(i: int) -> str:
    return f"h{i}"


def _g(i: int) -> str:
    return f"g_pre{i}"


@functools.lru_cache(maxsize=None)
def train_wide_plan(cfg: NeRFConfig) -> TrainWidePlan:
    """The wide training route's saved tensors and backward steps for
    `cfg`, in the packed layout of `fused_mlp.pack_params`."""
    d, n_layers = cfg.layer_dim, cfg.layers
    ep, dp = _round_up(cfg.enc_in, MMA_K), _round_up(cfg.dir_in, MMA_K)
    ap = _round_up(cfg.appearance_dim, MMA_K)
    branch = cfg.uses_dir_branch
    saved = [("enc", ep)]
    if branch and dp:
        saved.append(("dir", dp))
    if branch and ap:
        saved.append(("app", ap))
    saved += [(_h(i), d) for i in range(n_layers)]
    if branch:
        saved += [("final", d), ("branch", d // 2)]
    shapes = [(d, ep if i == 0 else (ep + d if i in cfg.skip_layers else d))
              for i in range(n_layers)]
    if branch:
        shapes += [(d, d), (d // 2, d + dp + ap)]
    flat = []
    for s in shapes:
        flat += [s, (s[0],)]
    rgb_in = d // 2 if branch else d
    flat += [(d,), (1,), (3, rgb_in), (3,)]
    offs = _offsets(flat)

    def layer_dw(i: int, g: str) -> Tuple[DwJob, ...]:
        w_off, b_off, ktot = offs[2 * i], offs[2 * i + 1], shapes[i][1]
        if i == 0:
            return (DwJob(g, 0, d, "enc", ep, w_off, ktot, b_off),)
        if i in cfg.skip_layers:
            return (DwJob(g, 0, d, "enc", ep, w_off, ktot, b_off),
                    DwJob(g, 0, d, _h(i - 1), d, w_off + ep, ktot, -1))
        return (DwJob(g, 0, d, _h(i - 1), d, w_off, ktot, b_off),)

    h_last = _h(n_layers - 1)
    k = 2 * len(shapes)
    heads = (DwJob("g_heads", 0, 1, h_last, d, offs[k], d, offs[k + 1]),
             DwJob("g_heads", HEADS_RGB_COL, 3, "branch" if branch else h_last,
                   rgb_in, offs[k + 2], rgb_in, offs[k + 3]))
    steps: List[Tuple[str, object]] = [("dw", heads)]
    if branch:
        a, f = n_layers + 1, n_layers
        if cfg.appearance_dim:
            steps.append(("dx", DxJob("g_a", a, d + dp, cfg.appearance_dim, DX_F32,
                                      "d_app", None)))
        steps.append(("dx", DxJob("g_a", a, 0, d, DX_NONE, "g_final", None)))
        ktot = shapes[a][1]
        xs = [("final", d, 0)] + ([("dir", dp, d)] if dp else []) \
            + ([("app", ap, d + dp)] if ap else [])
        steps.append(("dw", tuple(
            DwJob("g_a", 0, d // 2, x, w, offs[2 * a] + col, ktot,
                  offs[2 * a + 1] if col == 0 else -1) for x, w, col in xs)))
        steps.append(("dx", DxJob("g_final", f, 0, d, DX_MASK_SIGMA,
                                  _g(n_layers - 1), h_last)))
        steps.append(("dw", (DwJob("g_final", 0, d, h_last, d, offs[2 * f], d,
                                   offs[2 * f + 1]),)))
    for i in reversed(range(1, n_layers)):
        row0 = ep if i in cfg.skip_layers else 0
        steps.append(("dx", DxJob(_g(i), i, row0, d, DX_MASK, _g(i - 1), _h(i - 1))))
        steps.append(("dw", layer_dw(i, _g(i))))
    steps.append(("dw", layer_dw(0, _g(0))))

    def reads(step) -> List[str]:
        kind, job = step
        if kind == "dx":
            return [job.g, "g_heads"] if job.mode == DX_MASK_SIGMA else [job.g]
        return [j.d for j in job]

    frees, seen = [], set()
    for step in reversed(steps):
        names = [nm for nm in reads(step) if nm not in seen]
        seen.update(names)
        frees.append(tuple(dict.fromkeys(names)))
    return TrainWidePlan(tuple(saved), "g_a" if branch else _g(n_layers - 1),
                         tuple(steps), tuple(reversed(frees)), offs[-1])


def check_plan(packed: PackedMLP) -> TrainWidePlan:
    """The plan of `packed`'s config; raises unless its flat layout is the
    packed one (`fused_train.packed_shapes`)."""
    plan = train_wide_plan(packed.config)
    if plan.total != _offsets(packed_shapes(packed))[-1]:
        raise ValueError("train_wide: packed weights do not match the plan")
    return plan


def app_operand(packed: PackedMLP, app: torch.Tensor) -> torch.Tensor:
    """The appearance rows as dir_a's third A segment: (M, AP) in the
    compute dtype, zero columns past appearance_dim (16-byte rows for TMA)."""
    a = app.to(packed.config.dtype)
    if a.shape[1] != packed.ap:
        a = F.pad(a, (0, packed.ap - a.shape[1]))
    return a.contiguous()


# ---------------------------------------------------------------- plain


def train_wide_heads_fwd_plain(packed: PackedMLP, h: torch.Tensor,
                               branch: Optional[torch.Tensor],
                               noise: Optional[torch.Tensor]):
    """-> ((M, 4) f32 [sigmoid rgb, activated sigma], (M, 4) f32 [rgb_pre,
    sigma_pre + noise]) from the last trunk output h and the branch (h
    feeds the rgb head without it)."""
    train_wide_heads_fwd_plain.calls += 1
    sigma_pre = h.float() @ packed.sigma_w.float() + packed.sigma_b
    if noise is not None:
        sigma_pre = sigma_pre + noise.float()
    x = branch if branch is not None else h
    rgb_pre = x.float() @ packed.rgb_w.float().T + packed.rgb_b
    if packed.config.shifted_softplus:
        sigma = F.softplus(sigma_pre - 1.0)
    else:
        sigma = torch.relu(sigma_pre)
    out = torch.cat([torch.sigmoid(rgb_pre), sigma[:, None]], -1)
    return out, torch.cat([rgb_pre, sigma_pre[:, None]], -1)


def train_wide_heads_bwd_plain(packed: PackedMLP, g: torch.Tensor,
                               pre: torch.Tensor, h: torch.Tensor,
                               branch: Optional[torch.Tensor]):
    """-> (heads-gradient rows (M, HEADS_GRAD_WIDTH), d_pre) in the compute
    dtype: `_train_bwd_kernel`'s head steps, the cotangent rounded to the
    compute dtype, g_rgb and g_sigma rounded after their f32 products;
    d_pre = round((g_rgb W_rgb) * (branch > 0)), or without the branch
    round((g_sigma w_sigma + g_rgb W_rgb) * (h > 0))."""
    train_wide_heads_bwd_plain.calls += 1
    dt = packed.config.dtype

    def rnd(x):
        return x.to(dt).float()

    g = rnd(g.float())
    s = torch.sigmoid(pre[:, :3])
    g_rgb = rnd(g[:, :3] * s * (1.0 - s))
    if packed.config.shifted_softplus:
        g_sig = rnd(g[:, 3] * torch.sigmoid(pre[:, 3] - 1.0))
    else:
        g_sig = rnd(g[:, 3] * (pre[:, 3] > 0).float())
    rows = torch.zeros((g.shape[0], HEADS_GRAD_WIDTH), dtype=dt, device=g.device)
    rows[:, 0] = g_sig.to(dt)
    rows[:, HEADS_RGB_COL:HEADS_RGB_COL + 3] = g_rgb.to(dt)
    d_rgb = g_rgb @ packed.rgb_w.float()
    if branch is not None:
        return rows, (d_rgb * (branch.float() > 0)).to(dt)
    d_h = g_sig[:, None] * packed.sigma_w.float()[None] + d_rgb
    return rows, (d_h * (h.float() > 0)).to(dt)


def train_wide_dx_plain(g: torch.Tensor, wt: torch.Tensor, row0: int, k: int,
                        mode: int, mask: Optional[torch.Tensor] = None,
                        g_heads: Optional[torch.Tensor] = None,
                        w_sigma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mode(g @ wt[row0:row0 + k]^T): compute-dtype operands, f32 products
    and sums; DX_MASK_SIGMA adds g_sigma (g_heads' column 0) x w_sigma
    first; the mask modes zero where `mask` <= 0; f32 out for DX_F32, else
    rounded to wt's dtype."""
    train_wide_dx_plain.calls += 1
    y = g.float() @ wt[row0:row0 + k].float().T
    if mode == DX_MASK_SIGMA:
        y = y + g_heads[:, 0].float()[:, None] * w_sigma.float()[None]
    if mode in (DX_MASK, DX_MASK_SIGMA):
        y = y * (mask.float() > 0)
    return y if mode == DX_F32 else y.to(wt.dtype)


def train_wide_dw_plain(jobs: Sequence[DwJob], tensors: Dict[str, torch.Tensor],
                        out: torch.Tensor) -> torch.Tensor:
    """Writes each job's dW = D^T X and db = column sums of D into the flat
    f32 buffer `out` (compute-dtype operands, f32 products and sums)."""
    train_wide_dw_plain.calls += 1
    for j in jobs:
        dm = tensors[j.d][:, j.d_col:j.d_col + j.n].float()
        dw = dm.T @ tensors[j.x][:, :j.k].float()
        out[j.out_off:j.out_off + j.n * j.out_stride].view(j.n, j.out_stride)[:, :j.k] = dw
        if j.bias_off >= 0:
            out[j.bias_off:j.bias_off + j.n] = dm.sum(0)
    return out


for _fn in (train_wide_heads_fwd_plain, train_wide_heads_bwd_plain,
            train_wide_dx_plain, train_wide_dw_plain):
    _fn.calls = 0


# ---------------------------------------------------------------- kernels


def _train_wide_library() -> ctypes.CDLL:
    from mega_nerf_tpu_torch.render._build import load_library

    lib = load_library("train_wide")
    if not getattr(lib, "_train_wide_bound", False):
        vp = ctypes.c_void_p
        lib.train_wide_heads_fwd_launch.argtypes = [vp, vp, vp]
        lib.train_wide_heads_bwd_launch.argtypes = [vp, vp, vp]
        lib.train_wide_dx_launch.argtypes = [vp, vp, vp, ctypes.c_int, vp]
        lib.train_wide_resident_ctas.argtypes = [ctypes.c_int, vp]
        lib.train_wide_resident_ctas.restype = ctypes.c_int
        lib.train_wide_dw_launch.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, vp]
        lib.train_wide_dw_resident_ctas.argtypes = [vp]
        lib.train_wide_dw_resident_ctas.restype = ctypes.c_int
        for fn in (lib.train_wide_heads_fwd_launch, lib.train_wide_heads_bwd_launch,
                   lib.train_wide_dx_launch, lib.train_wide_dw_launch):
            fn.restype = ctypes.c_int
        lib.error_string = lib.train_wide_error_string
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib._train_wide_bound = True
    return lib


def _f32_compute(name: str, packed: PackedMLP) -> bool:
    """True in f32 compute (the f32 wide kernels), False in bf16; raises on
    a compute dtype no wide kernel takes."""
    dt = packed.config.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{name}: no kernel computes in "
                                  f"{packed.config.compute_dtype}")
    return dt == torch.float32


def _check_head_weights(name: str, packed: PackedMLP, device) -> None:
    for t in (packed.sigma_w, packed.rgb_w):
        if t.dtype != torch.bfloat16 or t.device != device:
            raise ValueError(f"{name}: head weights must be bf16 on the rows' device")
    for t in (packed.sigma_b, packed.rgb_b):
        if t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"{name}: head biases must be f32 on the rows' device")


def train_wide_heads_fwd(packed: PackedMLP, h: torch.Tensor,
                         branch: Optional[torch.Tensor],
                         noise: Optional[torch.Tensor]):
    """-> ((M, 4) f32 [rgb, sigma], (M, 4) f32 [rgb_pre, sigma_pre + noise])
    from the last trunk output h (M, D) and the branch (M, D / 2) (None
    without it); noise (M,) f32 or None. In f32 compute:
    `fused_wide_f32.wide_f32_heads_fwd`."""
    if not _device_rule("train_wide_heads_fwd", h):
        return train_wide_heads_fwd_plain(packed, h, branch, noise)
    if _f32_compute("train_wide_heads_fwd", packed):
        from mega_nerf_tpu_torch.render.fused_wide_f32 import wide_f32_heads_fwd

        return wide_f32_heads_fwd(packed, h, branch, noise)
    m, d = h.shape[0], packed.config.layer_dim
    _check("h", h, torch.bfloat16, (m, d))
    if packed.has_branch:
        _check("branch", branch, torch.bfloat16, (m, d // 2))
    if noise is not None:
        _check("noise", noise, torch.float32, (m,))
    _check_head_weights("train_wide_heads_fwd", packed, h.device)
    out = torch.empty((m, 4), dtype=torch.float32, device=h.device)
    pre = torch.empty((m, 4), dtype=torch.float32, device=h.device)
    if m == 0:
        return out, pre
    lib = _train_wide_library()
    ptrs = [h.data_ptr(), branch.data_ptr() if packed.has_branch else 0,
            0 if noise is None else noise.data_ptr(),
            packed.sigma_w.data_ptr(), packed.sigma_b.data_ptr(),
            packed.rgb_w.data_ptr(), packed.rgb_b.data_ptr(), out.data_ptr(),
            pre.data_ptr()]
    dims = [m, d, d // 2 if packed.has_branch else d, int(packed.has_branch),
            int(packed.config.shifted_softplus)]
    err = lib.train_wide_heads_fwd_launch(_longs(ptrs), _ints(dims), _stream(h))
    train_wide_heads_fwd.launches += 1
    _raise_if(lib, err, "train_wide_heads_fwd")
    return out, pre


def train_wide_heads_bwd(packed: PackedMLP, g: torch.Tensor, pre: torch.Tensor,
                         h: torch.Tensor, branch: Optional[torch.Tensor]):
    """-> (heads-gradient rows (M, HEADS_GRAD_WIDTH) bf16, d_pre bf16: of the
    branch (M, D / 2), or of the last trunk layer (M, D) without it) from
    the cotangent g (M, 4) f32 and the forward's pre-activations. In f32
    compute: `fused_wide_f32.wide_f32_heads_bwd` (f32 rows and d_pre)."""
    if not _device_rule("train_wide_heads_bwd", g):
        return train_wide_heads_bwd_plain(packed, g, pre, h, branch)
    if _f32_compute("train_wide_heads_bwd", packed):
        from mega_nerf_tpu_torch.render.fused_wide_f32 import wide_f32_heads_bwd

        return wide_f32_heads_bwd(packed, g, pre, h, branch)
    m, d = g.shape[0], packed.config.layer_dim
    _check("g", g, torch.float32, (m, 4))
    _check("pre", pre, torch.float32, (m, 4))
    _check("h", h, torch.bfloat16, (m, d))
    if packed.has_branch:
        _check("branch", branch, torch.bfloat16, (m, d // 2))
    _check_head_weights("train_wide_heads_bwd", packed, g.device)
    width = d // 2 if packed.has_branch else d
    rows = torch.empty((m, HEADS_GRAD_WIDTH), dtype=torch.bfloat16, device=g.device)
    d_pre = torch.empty((m, width), dtype=torch.bfloat16, device=g.device)
    if m == 0:
        return rows, d_pre
    lib = _train_wide_library()
    ptrs = [g.data_ptr(), pre.data_ptr(), h.data_ptr(),
            branch.data_ptr() if packed.has_branch else 0,
            packed.sigma_w.data_ptr(), packed.rgb_w.data_ptr(), rows.data_ptr(),
            d_pre.data_ptr()]
    dims = [m, d, width, int(packed.has_branch), int(packed.config.shifted_softplus),
            HEADS_GRAD_WIDTH, HEADS_RGB_COL]
    err = lib.train_wide_heads_bwd_launch(_longs(ptrs), _ints(dims), _stream(g))
    train_wide_heads_bwd.launches += 1
    _raise_if(lib, err, "train_wide_heads_bwd")
    return rows, d_pre


def train_wide_dx(g: torch.Tensor, wt: torch.Tensor, row0: int, k: int, mode: int,
                  mask: Optional[torch.Tensor] = None,
                  g_heads: Optional[torch.Tensor] = None,
                  w_sigma: Optional[torch.Tensor] = None,
                  grid: Optional[int] = None) -> torch.Tensor:
    """mode(g @ wt[row0:row0 + k]^T) -> (M, k), f32 for DX_F32, else bf16.

    g (M, N) bf16 gradient rows; wt (Ktot, N) bf16 transposed packed matrix
    (`fused_train.transposed_weights`); mask (M, k) bf16 saved output for
    the mask modes; g_heads (M, HEADS_GRAD_WIDTH) and w_sigma (k,) bf16 for
    DX_MASK_SIGMA. On CUDA tensors the kernel is persistent
    (`fused_wide.wide_grid` CTAs, without clusters; `grid`, the tests'
    only, sets another count). An f32 matrix (f32 compute) goes to
    `fused_wide_f32.wide_f32_dx` (f32 operands and outputs, no `grid`)."""
    if not _device_rule("train_wide_dx", g):
        return train_wide_dx_plain(g, wt, row0, k, mode, mask, g_heads, w_sigma)
    if wt.dtype == torch.float32:
        from mega_nerf_tpu_torch.render.fused_wide_f32 import wide_f32_dx

        if grid is not None:
            raise ValueError("train_wide_dx: the f32 GEMM takes no grid")
        return wide_f32_dx(g, wt, row0, k, mode, mask, g_heads, w_sigma)
    m, n = g.shape
    if mode not in (DX_F32, DX_NONE, DX_MASK, DX_MASK_SIGMA):
        raise ValueError(f"train_wide_dx: unknown mode {mode}")
    if wt.dim() != 2 or wt.shape[1] != n or not 0 <= row0 <= row0 + k <= wt.shape[0]:
        raise ValueError(f"train_wide_dx: rows [{row0}, {row0 + k}) of a "
                         f"{tuple(wt.shape)} matrix against {n}-wide gradients")
    _check_rows("g", g, torch.bfloat16, m, n)
    _check("wt", wt, torch.bfloat16, tuple(wt.shape))
    masked = mode in (DX_MASK, DX_MASK_SIGMA)
    if masked:
        _check("mask", mask, torch.bfloat16, (m, k))
    if mode == DX_MASK_SIGMA:
        _check("g_heads", g_heads, torch.bfloat16, (m, HEADS_GRAD_WIDTH))
        _check("w_sigma", w_sigma, torch.bfloat16, (k,))
    for t in (wt, mask, g_heads, w_sigma):
        if t is not None and t.device != g.device:
            raise ValueError("train_wide_dx: tensors on different devices")
    if mode != DX_F32 and k % 8:
        raise ValueError("train_wide_dx: bf16 outputs leave by TMA (k a multiple of 8)")
    out = torch.empty((m, k), dtype=torch.float32 if mode == DX_F32 else torch.bfloat16,
                      device=g.device)
    if m == 0 or k == 0:
        return out
    lib = _train_wide_library()
    ptrs = [g.data_ptr(), wt.data_ptr() + 2 * row0 * n, out.data_ptr(),
            mask.data_ptr() if masked else 0,
            g_heads.data_ptr() if mode == DX_MASK_SIGMA else 0,
            w_sigma.data_ptr() if mode == DX_MASK_SIGMA else 0]
    dims = [m, k, n, mode, g.stride(0), HEADS_GRAD_WIDTH]
    if grid is None:
        grid = wide_grid(m, k, wide_resident_ctas(lib, "train_wide", g.device), DX_CLUSTER)
    err = lib.train_wide_dx_launch(_longs(ptrs), _ints(dims), _ints(wide_plan_ints()),
                                   int(grid), _stream(g))
    train_wide_dx.launches += 1
    _raise_if(lib, err, "train_wide_dx")
    return out


def dw_tiles(jobs: Sequence[DwJob]) -> List[Tuple[int, int, int]]:
    """(job, n0, k0) of every DW_TILE_N x DW_TILE_K output tile of a launch."""
    return [(j, n0, k0) for j, job in enumerate(jobs)
            for n0 in range(0, job.n, DW_TILE_N) for k0 in range(0, job.k, DW_TILE_K)]


def dw_items(jobs: Sequence[DwJob]) -> List[Tuple[int, int, int]]:
    """The launch's tiles (`dw_tiles` indices) as the items its clusters
    walk: (tile of CTA rank 0, tile of rank 1 or -1, what they share).
    Neighbouring n-tiles of one k-tile of a job (sharing X), then of what
    is left neighbouring k-tiles of one n-tile (sharing d_pre), then any
    two, and a last lone tile with an idle peer."""
    tiles = dw_tiles(jobs)
    index = {t: i for i, t in enumerate(tiles)}
    items: List[Tuple[int, int, int]] = []
    rest: Dict[Tuple[int, int], List[int]] = {}
    for j, job in enumerate(jobs):
        for k0 in range(0, job.k, DW_TILE_K):
            ns = [index[(j, n0, k0)] for n0 in range(0, job.n, DW_TILE_N)]
            items += [(ns[i], ns[i + 1], DW_SHARE_X) for i in range(0, len(ns) - 1, 2)]
            if len(ns) % 2:
                rest.setdefault(tiles[ns[-1]][:2], []).append(ns[-1])
    singles = []
    for group in rest.values():
        items += [(group[i], group[i + 1], DW_SHARE_A)
                  for i in range(0, len(group) - 1, 2)]
        if len(group) % 2:
            singles.append(group[-1])
    items += [(singles[i], singles[i + 1], DW_SHARE_NONE)
              for i in range(0, len(singles) - 1, 2)]
    if len(singles) % 2:
        items.append((singles[-1], -1, DW_SHARE_NONE))
    return items


class DwWalk(NamedTuple):
    """The balanced walk of a dW launch (train_wide.cu DwWalk): `workers`
    (clusters of DW_CLUSTER CTAs) share `items` of `stages` 64-point
    stages each. Worker c does w + (c < e) stages. The first q * items
    workers are mains, main m * items + p on one stretch of item p (the
    q mains of every item run over the same points at once); the rest are
    floaters, walking each item's remaining last stages, items in order,
    as one line cut into equal shares (stream-K)."""
    items: int
    stages: int
    workers: int
    q: int
    w: int
    e: int

    def share(self, c: int) -> int:
        return self.w + (c < self.e)

    def main_start(self, m: int, p: int) -> int:
        """First stage of main m of item p (at m = q: the floaters' first)."""
        return m * self.w + (min(m, (self.e - p - 1) // self.items + 1)
                             if self.e > p else 0)

    def floater_start(self, f: int) -> int:
        return f * self.w + min(f, max(0, self.e - self.q * self.items))


def dw_walk(items: int, stages: int, workers: int) -> DwWalk:
    total = items * stages
    return DwWalk(items, stages, workers, workers // items, total // workers,
                  total - workers * (total // workers))


def dw_units(walk: DwWalk, c: int) -> List[Tuple[int, int, int, int]]:
    """(item, first stage, end stage, partial slot) of worker c's units, in
    the order it walks them (train_wide.cu DwUnits)."""
    mains = walk.q * walk.items
    if c < mains:
        p = c % walk.items
        s0 = walk.main_start(c // walk.items, p)
        return [(p, s0, s0 + walk.share(c), c)] if walk.share(c) else []
    x0 = walk.floater_start(c - mains)
    x1 = x0 + walk.share(c)
    units, pre = [], 0
    for p in range(walk.items):
        if pre >= x1:
            break
        f0 = walk.main_start(walk.q, p)
        lo, hi = max(x0, pre), min(x1, pre + walk.stages - f0)
        if lo < hi:
            units.append((p, f0 + lo - pre, f0 + hi - pre, c + p))
        pre += walk.stages - f0
    return units


def dw_fixup_order(walk: DwWalk, item: int) -> List[int]:
    """The partial slots of `item` in the order its fixup sums them: its
    mains, then the floaters that walked its last stages."""
    mains = walk.q * walk.items
    order = [m * walk.items + item for m in range(walk.q)
             if walk.share(m * walk.items + item)]
    pre = sum(walk.stages - walk.main_start(walk.q, i) for i in range(item))
    end = pre + walk.stages - walk.main_start(walk.q, item)
    for f in range(walk.workers - mains):
        lo = walk.floater_start(f)
        if max(lo, pre) < min(lo + walk.share(mains + f), end):
            order.append(mains + f + item)
    return order


def dw_grid(items: int, stages: int, resident: int) -> int:
    """CTAs of a dW launch: one per SM (whole clusters), no more workers
    than stages."""
    return DW_CLUSTER * max(1, min(resident // DW_CLUSTER, items * stages, DW_MAX_WORKERS))


_DW_RESIDENT: Dict[int, int] = {}


def _dw_resident(lib: ctypes.CDLL, device: torch.device) -> int:
    """CTAs of the dW kernel the card holds at once in clusters of
    DW_CLUSTER (the occupancy query), cached per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _DW_RESIDENT:
        ctas = ctypes.c_int(0)
        with torch.cuda.device(index):
            _raise_if(lib, lib.train_wide_dw_resident_ctas(ctypes.byref(ctas)),
                      "train_wide_dw_resident_ctas")
        if ctas.value < DW_CLUSTER:
            raise RuntimeError("train_wide_dw: no cluster of its CTAs fits the card")
        _DW_RESIDENT[index] = ctas.value
    return _DW_RESIDENT[index]


def train_wide_dw(jobs: Sequence[DwJob], tensors: Dict[str, torch.Tensor],
                  out: torch.Tensor, grid: Optional[int] = None) -> torch.Tensor:
    """Writes each job's dW and db into the flat f32 buffer `out` (one
    launch per call). On CUDA tensors the kernel is persistent: `dw_grid`
    CTAs (one per SM) in clusters of DW_CLUSTER walk `dw_walk`'s balanced
    split of the (item, 64-point stage) space, and each tile's partials are
    summed in point order, so two launches at one grid give the same bits.
    `grid`, the tests' only, sets another CTA count (whole clusters).
    f32 tensors (f32 compute) go to `fused_wide_f32.wide_f32_dw` (the f32
    weight-gradient kernel pair, no `grid`)."""
    if not _device_rule("train_wide_dw", out):
        return train_wide_dw_plain(jobs, tensors, out)
    if tensors[jobs[0].d].dtype == torch.float32:
        from mega_nerf_tpu_torch.render.fused_wide_f32 import wide_f32_dw

        if grid is not None:
            raise ValueError("train_wide_dw: the f32 weight gradient takes no grid")
        return wide_f32_dw(jobs, tensors, out)
    if not 1 <= len(jobs) <= DW_MAX_JOBS:
        raise ValueError(f"train_wide_dw: 1-{DW_MAX_JOBS} jobs, got {len(jobs)}")
    if out.dtype != torch.float32 or out.dim() != 1 or not out.is_contiguous():
        raise ValueError("train_wide_dw: out must be a contiguous flat f32 buffer")
    if grid is not None and (grid < DW_CLUSTER or grid % DW_CLUSTER
                             or grid > DW_CLUSTER * DW_MAX_WORKERS):
        raise ValueError(f"train_wide_dw: grid {grid} is not 1-{DW_MAX_WORKERS} "
                         f"clusters of {DW_CLUSTER}")
    names = list(dict.fromkeys(nm for j in jobs for nm in (j.d, j.x)))
    if len(names) > DW_MAX_MAPS:
        raise ValueError(f"train_wide_dw: more than {DW_MAX_MAPS} tensors")
    m = tensors[names[0]].shape[0]
    for nm in names:
        t = tensors[nm]
        _check_rows(nm, t, torch.bfloat16, m, t.shape[1] if t.dim() == 2 else -1)
        if t.device != out.device:
            raise ValueError("train_wide_dw: tensors on different devices")
    for j in jobs:  # d_col on 16 B (TMA boxes), k in fours (the sums' stores)
        if j.d_col % 8 or j.k % 4 or j.d_col + j.n > tensors[j.d].shape[1] \
                or j.k > tensors[j.x].shape[1]:
            raise ValueError(f"train_wide_dw: job {j} does not fit its tensors")
        end = max(j.out_off + (j.n - 1) * j.out_stride + j.k, j.bias_off + j.n)
        if end > out.numel():
            raise ValueError(f"train_wide_dw: job {j} writes past the buffer")
    tiles = dw_tiles(jobs)
    if len(tiles) > DW_MAX_TILES:
        raise ValueError(f"train_wide_dw: {len(tiles)} tiles exceed {DW_MAX_TILES}")
    if m == 0:
        for j in jobs:
            out[j.out_off:j.out_off + j.n * j.out_stride].view(
                j.n, j.out_stride)[:, :j.k] = 0
            if j.bias_off >= 0:
                out[j.bias_off:j.bias_off + j.n] = 0
        return out
    lib = _train_wide_library()
    items = dw_items(jobs)
    if grid is None:
        grid = dw_grid(len(items), -(-m // DW_STAGE), _dw_resident(lib, out.device))
    # A partial per unit and CTA: main slots 0 .. q P - 1, floater slots
    # below workers + items (`dw_units`).
    scratch = torch.empty((grid // DW_CLUSTER + len(items)) * DW_CLUSTER * DW_TILE_ELEMS,
                          dtype=torch.float32, device=out.device)
    counters = torch.zeros(len(tiles), dtype=torch.int32, device=out.device)
    ptrs = [out.data_ptr(), scratch.data_ptr(), counters.data_ptr()]
    ptrs += [tensors[nm].data_ptr() for nm in names]
    dims = [m, len(names), len(jobs), len(tiles), len(items)]
    dims += [v for nm in names for v in (tensors[nm].shape[1], tensors[nm].stride(0))]
    job_ints = [v for j in jobs for v in (names.index(j.d), j.d_col, j.n,
                                          names.index(j.x), j.k, j.out_off,
                                          j.out_stride, j.bias_off)]
    err = lib.train_wide_dw_launch(_longs(ptrs), _ints(dims), _ints(job_ints),
                                   _ints(v for t in tiles for v in t),
                                   _ints(v for it in items for v in it), int(grid),
                                   _stream(out))
    train_wide_dw.launches += 1
    _raise_if(lib, err, "train_wide_dw")
    return out


for _fn in (train_wide_heads_fwd, train_wide_heads_bwd, train_wide_dx, train_wide_dw):
    _fn.launches = 0

TRAIN_WIDE_KERNELS = ("train_wide_heads_fwd", "train_wide_heads_bwd",
                      "train_wide_dx", "train_wide_dw")


class _Ops(NamedTuple):
    encode: object
    layer: object
    heads_fwd: object
    heads_bwd: object
    dx: object
    dw: object


def _kernel_ops() -> _Ops:
    return _Ops(eval_wide_encode, eval_wide_layer, train_wide_heads_fwd,
                train_wide_heads_bwd, train_wide_dx, train_wide_dw)


def _plain_ops() -> _Ops:
    return _Ops(eval_wide_encode_plain, eval_wide_layer_plain,
                train_wide_heads_fwd_plain, train_wide_heads_bwd_plain,
                train_wide_dx_plain, train_wide_dw_plain)


# ------------------------------------------------------------ composition


def _forward(packed: PackedMLP, xyz, dirs, app, noise, ops: _Ops):
    cfg = packed.config
    plan = check_plan(packed)
    enc, dir_enc = ops.encode(packed, xyz, dirs)
    saved = {"enc": enc}
    h, branch = enc, None
    for i in range(cfg.layers):
        xs = [enc, h] if i in cfg.skip_layers else [h]
        h = saved[_h(i)] = ops.layer(xs, packed.mats[i], packed.biases[i], True)
    if packed.has_branch:
        final = saved["final"] = ops.layer([h], packed.mats[cfg.layers],
                                           packed.biases[cfg.layers], False)
        xs = [final]
        if packed.dp:
            xs.append(saved.setdefault("dir", dir_enc))
        if packed.ap:
            xs.append(saved.setdefault("app", app_operand(packed, app)))
        branch = saved["branch"] = ops.layer(xs, packed.mats[cfg.layers + 1],
                                             packed.biases[cfg.layers + 1], True)
    out, saved["pre"] = ops.heads_fwd(packed, h, branch, noise)
    assert {nm for nm, _ in plan.saved} == set(saved) - {"pre"}
    return out, saved


def _backward(packed: PackedMLP, saved: Dict[str, torch.Tensor], g: torch.Tensor,
              ops: _Ops):
    cfg = packed.config
    plan = check_plan(packed)
    wts = transposed_weights(packed)
    grads: Dict[str, torch.Tensor] = {}
    grads["g_heads"], grads[plan.first] = ops.heads_bwd(
        packed, g.float().contiguous(), saved["pre"], saved[_h(cfg.layers - 1)],
        saved.get("branch"))
    out = torch.empty(plan.total, dtype=torch.float32, device=g.device)
    d_app = None
    for (kind, job), frees in zip(plan.steps, plan.frees):
        if kind == "dx":
            y = ops.dx(grads[job.g], wts[job.mat], job.row0, job.k, job.mode,
                       saved.get(job.mask), grads.get("g_heads"), packed.sigma_w)
            if job.out == "d_app":
                d_app = y
            else:
                grads[job.out] = y
        else:
            ops.dw(job, {**saved, **grads}, out)
        for nm in frees:
            del grads[nm]
    return out, d_app


def fused_nerf_train_wide_fwd(packed: PackedMLP, xyz, dirs, app, noise):
    """The wide training forward -> ((M, 4) f32, saved tensors by name):
    `eval_wide_encode`, `eval_wide_layer` per matmul layer, then
    `train_wide_heads_fwd` (their plain versions on CPU tensors; in f32
    compute their f32 kernels)."""
    if xyz.device.type == "cuda":
        m, a = xyz.shape[0], packed.config.appearance_dim
        _f32_compute("fused_nerf_train_wide_fwd", packed)
        check_weights_dtype("fused_nerf_train_wide_fwd", packed)
        if packed.ap and (app is None or tuple(app.shape) != (m, a)):
            raise ValueError(f"app: expected ({m}, {a}) appearance rows")
    return _forward(packed, xyz, dirs, app, noise, _kernel_ops())


def fused_nerf_train_wide_fwd_plain(packed: PackedMLP, xyz, dirs, app, noise):
    """The same composed from the plain versions, on any device."""
    fused_nerf_train_wide_fwd_plain.calls += 1
    return _forward(packed, xyz, dirs, app, noise, _plain_ops())


def fused_nerf_train_wide_bwd(packed: PackedMLP, saved: Dict[str, torch.Tensor],
                              g: torch.Tensor):
    """The wide training backward from the saved tensors -> (flat f32
    gradients in `packed_shapes` order, d_app (M, appearance_dim) f32 or
    None): `train_wide_heads_bwd`, then the plan's dX and dW steps."""
    return _backward(packed, saved, g, _kernel_ops())


def fused_nerf_train_wide_bwd_plain(packed: PackedMLP, saved: Dict[str, torch.Tensor],
                                    g: torch.Tensor):
    """The same composed from the plain versions, on any device."""
    fused_nerf_train_wide_bwd_plain.calls += 1
    return _backward(packed, saved, g, _plain_ops())


fused_nerf_train_wide_fwd_plain.calls = 0
fused_nerf_train_wide_bwd_plain.calls = 0


DW_REPEAT = "train_wide_dw (repeat)"


def walk_backward(packed: PackedMLP, saved: Dict[str, torch.Tensor], g: torch.Tensor
                  ) -> Iterator[Tuple[str, torch.Tensor, torch.Tensor]]:
    """The backward's kernels against their plain versions, for a check on
    the card: each kernel is fed the same inputs as its plain version, and
    the plain outputs are carried on, so errors do not compound. Yields
    (kernel, kernel output, plain output): the heads backward's two outputs,
    every dX job's output, every dW job's weight gradient and bias sums;
    and per dW launch (DW_REPEAT, buffer after a second launch, after the
    first), which must be equal bit for bit."""
    plan = check_plan(packed)
    wts = transposed_weights(packed)
    args = (packed, g, saved["pre"], saved[_h(packed.config.layers - 1)],
            saved.get("branch"))
    names = ("g_heads", plan.first)
    grads = dict(zip(names, train_wide_heads_bwd_plain(*args)))
    for nm, got in zip(names, train_wide_heads_bwd(*args)):
        yield "train_wide_heads_bwd", got, grads[nm]
    k_flat = torch.zeros(plan.total, dtype=torch.float32, device=g.device)
    p_flat = torch.zeros_like(k_flat)
    for (kind, job), frees in zip(plan.steps, plan.frees):
        if kind == "dx":
            dx_args = (grads[job.g], wts[job.mat], job.row0, job.k, job.mode,
                       saved.get(job.mask), grads.get("g_heads"), packed.sigma_w)
            want = train_wide_dx_plain(*dx_args)
            yield "train_wide_dx", train_wide_dx(*dx_args), want
            grads[job.out] = want
        else:
            tensors = {**saved, **grads}
            train_wide_dw(job, tensors, k_flat)
            again = k_flat.clone()
            train_wide_dw(job, tensors, again)
            yield DW_REPEAT, again, k_flat
            train_wide_dw_plain(job, tensors, p_flat)
            for j in job:
                rows = slice(j.out_off, j.out_off + j.n * j.out_stride)
                yield ("train_wide_dw", k_flat[rows].view(j.n, j.out_stride)[:, :j.k],
                       p_flat[rows].view(j.n, j.out_stride)[:, :j.k])
                if j.bias_off >= 0:
                    bias = slice(j.bias_off, j.bias_off + j.n)
                    yield "train_wide_dw", k_flat[bias], p_flat[bias]
        for nm in frees:
            grads.pop(nm, None)


def wide_train_kernel_launches() -> int:
    """Launches of the four training kernels of `csrc/train_wide.cu`."""
    return (train_wide_heads_fwd.launches + train_wide_heads_bwd.launches
            + train_wide_dx.launches + train_wide_dw.launches)


__all__ = [
    "DxJob", "DwJob", "TrainWidePlan", "train_wide_plan", "check_plan",
    "app_operand", "dw_tiles", "dw_items", "DwWalk", "dw_walk", "dw_units",
    "dw_fixup_order", "dw_grid", "walk_backward", "DW_REPEAT",
    "train_wide_heads_fwd", "train_wide_heads_bwd", "train_wide_dx", "train_wide_dw",
    "train_wide_heads_fwd_plain", "train_wide_heads_bwd_plain",
    "train_wide_dx_plain", "train_wide_dw_plain",
    "fused_nerf_train_wide_fwd", "fused_nerf_train_wide_fwd_plain",
    "fused_nerf_train_wide_bwd", "fused_nerf_train_wide_bwd_plain",
    "wide_train_kernel_launches",
    "TRAIN_WIDE_KERNELS",
]
