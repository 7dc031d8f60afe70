"""Fused NeRF training MLP: the differentiable apply, plain versions and the
kernel wrappers.

Counterpart of the JAX package's `render/pallas_train.py`. The hand-written
Hopper kernels are in `csrc/train_fwd.cu` (forward), `csrc/train_bwd.cu`
(backward-data) and `csrc/weight_grad.cu` (weight gradient) for bf16
compute, and in `csrc/train_f32.cu` (`fused_f32.py`: the same three steps
in true f32) for f32 compute; they replace
`mega_nerf_tpu/render/pallas_train.py::_train_fwd_kernel` and
`::_train_bwd_kernel`.

- `fused_nerf_train_apply(module, xyz, dirs, app, sigma_noise)` is a
  `torch.autograd.Function`. It takes the module's f32 parameters as inputs
  and packs them into the compute dtype inside the call (as the JAX path
  packs with `cast=False`), and returns their gradients in their own
  shapes (padding columns dropped), plus d_app for the gathered appearance
  rows (f32, exact in the compute dtype). Positions, directions and noise get no
  gradient. Past width 512 (`fused_mlp.is_wide`) it runs the wide training
  route of `fused_train_wide.py` in place of the three kernels here.
- The forward saves every activation of a point in one row (the layout of
  `act_layout`); the backward reads them: the backward-data step writes
  each layer's pre-activation gradient to one row per point
  (`grad_layout`) plus d_app, and the weight-gradient step forms
  dW = d_pre^T . input and the bias sums for every layer.
- Each of the three steps has a plain version that repeats its kernel's
  arithmetic (`_train_bwd_kernel`'s, for the backward: cotangent rounded to
  the compute dtype, output derivatives in f32, compute-dtype matmul
  operands with f32 accumulation, ReLU masks from the rounded
  activations). A wrapper runs the plain version on a CPU tensor and
  launches its kernel on a CUDA tensor (the bf16 kernel here, or in f32
  compute the f32 kernel of `fused_f32.py`), or raises.
- Each kernel wrapper counts its bf16 launches in `.launches` (the f32
  kernels count theirs in `fused_f32.py`); each plain version its calls in
  `.calls`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mega_nerf_tpu_torch.models.nerf import NeRF, NeRFConfig
from mega_nerf_tpu_torch.render.fused_mlp import (
    MMA_K,
    ForwardTrace,
    PackedMLP,
    _raise_if,
    _round_up,
    check_inputs,
    forward_trace,
    is_wide,
    launch_tables,
    mat_layout,
    mlp_param_names,
    pack_tensors,
    skip_mask,
    supports_fused_kernel,
)

WG_TILE_N = 128  # weight-gradient output tile: 128 (n) x 256 (k) (weight_grad.cu TN, TK)
WG_TILE_K = 256
WG_STAGE = 64  # points per pipeline stage (weight_grad.cu SP)
WG_TILE_ELEMS = WG_TILE_N * WG_TILE_K + WG_TILE_N  # partial tile + bias row
WG_WAVES = 2  # CTAs per launch: up to two waves of the CTAs the card holds
WG_MIN_SPLIT = 4096  # points per split at least
# What the two CTAs of a cluster share (weight_grad.cu SHARE_*): nothing, the
# X boxes (two n-tiles of a job) or the d_pre boxes (two k-tiles of a job).
WG_SHARE_NONE, WG_SHARE_X, WG_SHARE_A = 0, 1, 2
WG_IDLE = (-1, 0, 0)  # the tile of a CTA with no work
# The training forward (train_fwd.cu): tiles of 64-column blocks, TM rows x
# 128 B each; weight boxes of 64 columns x up to 256 rows; row stores of 64
# columns x 64 points.
FWD_SMEM_LIMIT = 232_448  # shared memory one CTA may use on an H100
FWD_BLOCK = 64
FWD_BOX_ROWS = 256
FWD_MAX_STAGES = 4
FWD_ALIGN = 1024  # the kernel aligns its base to the swizzle period
# The backward-data kernel's products (train_bwd.cu): what each epilogue
# does with its accumulators.
BWD_APP = 0  # d_app columns, f32 to global memory
BWD_FINAL = 1  # d_final: bf16 into the gradient tile, no mask
BWD_MASK = 2  # d_pre: masked by the mask tile, bf16 into the gradient tile
BWD_MASK_SIGMA = 3  # the same after adding g_sigma * w_sigma
_WIDE_WHY = "layer_dim past 512 (the wide training route, fused_train_wide.py)"


# ------------------------------------------------------------------ layouts


def branch_k(cfg: NeRFConfig) -> int:
    """Width of the d_a_pre tile: D / 2 rounded up to the MMA depth."""
    return _round_up(cfg.layer_dim // 2, MMA_K)


def _act_columns(cfg: NeRFConfig, ep: int, dp: int, ap: int) -> Dict[str, int]:
    d, n = cfg.layer_dim, cfg.layers
    lay = {"h0": ep, "final": ep + n * d}
    lay["dir"] = lay["final"] + d
    lay["app"] = lay["dir"] + dp
    lay["branch"] = lay["app"] + ap
    lay["width"] = lay["branch"] + d // 2 if cfg.uses_dir_branch else lay["final"]
    return lay


def act_layout(packed: PackedMLP) -> Dict[str, int]:
    """Column offsets of a saved activation row (train_fwd.cu ActLayout)."""
    return _act_columns(packed.config, packed.ep, packed.dp, packed.ap)


def _grad_columns(cfg: NeRFConfig) -> Dict[str, int]:
    d, n = cfg.layer_dim, cfg.layers
    lay = {"dfinal": n * d, "da": n * d + d}
    lay["heads"] = lay["da"] + branch_k(cfg) if cfg.uses_dir_branch else n * d
    lay["width"] = lay["heads"] + 8
    return lay


def grad_layout(packed: PackedMLP) -> Dict[str, int]:
    """Column offsets of a gradient row (train_bwd.cu writes them):
    [d_pre_0 D | ... | d_pre_{L-1} D | d_final D | d_a KB | heads 8], the
    d_final and d_a segments only with the branch; heads = [g_sigma, g_r,
    g_g, g_b, 0, 0, 0, 0]."""
    return _grad_columns(packed.config)


def packed_shapes(packed: PackedMLP) -> List[Tuple[int, ...]]:
    """Shapes of the packed gradient tensors, in flat order: (mat, bias)
    per matmul layer, then sigma_w, sigma_b, rgb_w, rgb_b."""
    shapes: List[Tuple[int, ...]] = []
    for w, b in zip(packed.mats, packed.biases):
        shapes += [tuple(w.shape), tuple(b.shape)]
    return shapes + [tuple(packed.sigma_w.shape), (1,),
                     tuple(packed.rgb_w.shape), (3,)]


def _offsets(shapes) -> List[int]:
    offs, o = [], 0
    for s in shapes:
        offs.append(o)
        o += math.prod(s)
    return offs + [o]


def unpack_grads(cfg: NeRFConfig, grads: List[torch.Tensor],
                 params: List[torch.Tensor]) -> List[torch.Tensor]:
    """Packed-layout gradients -> gradients in the parameters' shapes, in
    `mlp_param_names` order (padding columns dropped)."""
    out: List[torch.Tensor] = []
    it = iter(params)
    for i, (_, _, pieces) in enumerate(mat_layout(cfg)):
        w = next(it)
        next(it)
        gw = w.new_zeros(w.shape)
        for src, dst, n in pieces:
            gw[:, src:src + n] = grads[2 * i][:, dst:dst + n]
        out += [gw, grads[2 * i + 1]]
    k = 2 * len(mat_layout(cfg))
    out += [grads[k][None], grads[k + 1], grads[k + 2], grads[k + 3]]
    return out


# ------------------------------------------------------------- plain versions


def fused_nerf_train_fwd_plain(packed: PackedMLP, xyz, dirs, app, noise):
    """Plain version of the training forward -> ((M, 4) f32, saved rows
    (M, act width) in the compute dtype, laid out as the kernel's)."""
    fused_nerf_train_fwd_plain.calls += 1
    tr = forward_trace(packed, xyz, dirs, app, noise)
    parts = [tr.enc, *tr.hs]
    if packed.has_branch:
        parts += [tr.branch_in, tr.branch]
    return tr.output(packed.config.shifted_softplus), torch.cat(parts, -1)


fused_nerf_train_fwd_plain.calls = 0


def trace_from_rows(packed: PackedMLP, act: torch.Tensor,
                    noise: Optional[torch.Tensor],
                    acc: torch.dtype = torch.float32) -> ForwardTrace:
    """A ForwardTrace read from the saved rows; the sigma and rgb
    pre-activations are recomputed from them as the backward kernel does,
    in `acc` (f32, or f64 for a reference)."""
    cfg = packed.config
    d, lay = cfg.layer_dim, act_layout(packed)
    hs = [act[:, lay["h0"] + i * d:lay["h0"] + (i + 1) * d]
          for i in range(cfg.layers)]
    sigma_pre = hs[-1].to(acc) @ packed.sigma_w.to(acc) + packed.sigma_b.to(acc)
    if noise is not None:
        sigma_pre = sigma_pre + noise.to(acc)
    branch_in = branch = None
    h = hs[-1]
    if packed.has_branch:
        branch_in = act[:, lay["final"]:lay["branch"]]
        branch = h = act[:, lay["branch"]:lay["width"]]
    rgb_pre = h.to(acc) @ packed.rgb_w.to(acc).T + packed.rgb_b.to(acc)
    return ForwardTrace(act[:, :packed.ep], branch_in, hs, sigma_pre, branch,
                        rgb_pre)


def train_bwd_data_plain(packed: PackedMLP, act: torch.Tensor, g: torch.Tensor,
                         noise: Optional[torch.Tensor],
                         acc: torch.dtype = torch.float32):
    """Plain version of the backward-data kernel -> (gradient rows (M, grad
    width) in the compute dtype, d_app (M, appearance_dim) f32 or None).

    `_train_bwd_kernel`'s steps: the cotangent rounded to the compute
    dtype, output derivatives in f32, then per layer d_pre = round(d_h *
    (h > 0)) and d_h = d_pre @ W in f32. `acc=torch.float64` gives an f32
    model's reference: the same f32 rows, weights and cotangent in, every
    product, sum and derivative in f64 (rows and d_app in f64)."""
    train_bwd_data_plain.calls += 1
    cfg = packed.config
    dt = cfg.dtype if acc == torch.float32 else acc
    n_layers, d = cfg.layers, cfg.layer_dim
    tr = trace_from_rows(packed, act, noise, acc)

    def rnd(x):
        return x.to(dt).to(acc)

    g = rnd(g.to(acc))
    s = torch.sigmoid(tr.rgb_pre)
    g_rgb = rnd(g[:, :3] * s * (1.0 - s))
    if cfg.shifted_softplus:
        g_sig = rnd(g[:, 3] * torch.sigmoid(tr.sigma_pre - 1.0))
    else:
        g_sig = rnd(g[:, 3] * (tr.sigma_pre > 0).to(acc))
    heads = F.pad(torch.cat([g_sig[:, None], g_rgb], -1), (0, 4))

    d_h_sig = g_sig[:, None] * packed.sigma_w.to(acc)[None]
    d_app = None
    tail = []
    if packed.has_branch:
        d_a = rnd((g_rgb @ packed.rgb_w.to(acc)) * (tr.branch.to(acc) > 0))
        w_a = packed.mats[n_layers + 1].to(acc)
        if packed.ap:
            col = d + packed.dp
            d_app = d_a @ w_a[:, col:col + cfg.appearance_dim]
        d_final = rnd(d_a @ w_a[:, :d])
        d_h = d_final @ packed.mats[n_layers].to(acc) + d_h_sig
        tail = [d_final, F.pad(d_a, (0, branch_k(cfg) - d // 2))]
    else:
        d_h = d_h_sig + g_rgb @ packed.rgb_w.to(acc)

    d_pres = [None] * n_layers
    for i in reversed(range(n_layers)):
        d_pres[i] = rnd(d_h * (tr.hs[i].to(acc) > 0))
        if i > 0:
            w = packed.mats[i].to(acc)
            d_h = d_pres[i] @ (w[:, packed.ep:] if i in cfg.skip_layers else w)
    rows = torch.cat([*d_pres, *tail, heads], -1).to(dt)
    return rows, d_app


train_bwd_data_plain.calls = 0


def weight_grad_plain(packed: PackedMLP, act: torch.Tensor,
                      grad: torch.Tensor) -> torch.Tensor:
    """Plain version of the weight-gradient kernel -> flat f32 gradients in
    `packed_shapes` order: per job, dW = D^T X and db = column sums of D
    (compute-dtype operands, f32 products and sums)."""
    weight_grad_plain.calls += 1
    out = torch.empty(_offsets(packed_shapes(packed))[-1], dtype=torch.float32,
                      device=act.device)
    for d_col, n, x_col, k, out_off, stride, bias_off in weight_grad_jobs(packed):
        dm = grad[:, d_col:d_col + n].float()
        dw = dm.T @ act[:, x_col:x_col + k].float()
        out[out_off:out_off + n * stride].view(n, stride)[:, :k] = dw
        if bias_off >= 0:
            out[bias_off:bias_off + n] = dm.sum(0)
    return out


weight_grad_plain.calls = 0


# ------------------------------------------------------------ kernel wrappers


def _wg_library():
    from mega_nerf_tpu_torch.render._build import load_library

    lib = load_library("weight_grad")
    if not getattr(lib, "_wg_bound", False):
        vp = ctypes.c_void_p
        lib.weight_grad_launch.argtypes = [vp, vp, vp, vp, vp, vp]
        lib.weight_grad_launch.restype = ctypes.c_int
        lib.weight_grad_resident_ctas.argtypes = [vp]
        lib.weight_grad_resident_ctas.restype = ctypes.c_int
        lib.error_string = lib.weight_grad_error_string
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib._wg_bound = True
    return lib


_RESIDENT: Dict[int, int] = {}


def _resident_ctas(lib, device: torch.device) -> int:
    """CTAs of the weight-gradient kernel the card holds at once."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _RESIDENT:
        ctas = ctypes.c_int(0)
        with torch.cuda.device(index):
            _raise_if(lib, lib.weight_grad_resident_ctas(ctypes.byref(ctas)),
                      "weight_grad occupancy")
        _RESIDENT[index] = max(ctas.value, 2)
    return _RESIDENT[index]


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _cuda_only(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")


def _blocks(w: int) -> int:
    return -(-w // FWD_BLOCK)


def _stores(segments) -> List[Tuple[int, int]]:
    """(column, width) stores of segments: 64-column blocks, then the tail."""
    stores = []
    for col0, w in segments:
        full = w // FWD_BLOCK
        stores += [(col0 + FWD_BLOCK * b, FWD_BLOCK) for b in range(full)]
        if w > FWD_BLOCK * full:
            stores.append((col0 + FWD_BLOCK * full, w - FWD_BLOCK * full))
    return stores


class TrainFwdPlan(NamedTuple):
    """The training forward kernel's tile and shared memory (train_fwd.cu).

    `tm` points per CTA (two consumer warpgroups: 64 points each at 128,
    the same 64 points and split output columns at 64); `offsets` (enc,
    dir, app, act, ring, bar, sig) in bytes from the kernel's 1024-aligned
    base; `smem_bytes` includes the alignment slack. `mats` (N, Ktot) per
    packed matrix; `weight_boxes` (matrix, column, row) in ring order;
    `row_stores` (column, width) of every saved-row store of a tile (64-wide
    TMA boxes and the narrower tails)."""
    tm: int
    stages: int
    stage_bytes: int
    offsets: Dict[str, int]
    smem_bytes: int
    row_width: int
    mats: List[Tuple[int, int]]
    weight_boxes: List[Tuple[int, int, int]]
    row_stores: List[Tuple[int, int]]


def _fwd_segments(cfg: NeRFConfig, ep: int, dp: int, ap: int):
    """(N, [(K, first column in the packed matrix)]) per matmul layer, as
    train_fwd.cu make_layer."""
    d = cfg.layer_dim
    out = []
    for i in range(cfg.layers):
        segs = []
        if i == 0 or i in cfg.skip_layers:
            segs.append((ep, 0))
        if i > 0:
            segs.append((d, ep if i in cfg.skip_layers else 0))
        out.append((d, segs))
    if cfg.uses_dir_branch:
        out.append((d, [(d, 0)]))
        segs = [(d, 0)] + ([(dp, d)] if dp else []) + ([(ap, d + dp)] if ap else [])
        out.append((d // 2, segs))
    return out


@functools.lru_cache(maxsize=None)
def train_fwd_plan(cfg: NeRFConfig) -> TrainFwdPlan:
    """The training forward's tile for `cfg`: 128 points when D <= 256 and
    at least two ring stages fit, else 64; as many stages (up to 4) as the
    shared memory holds. Raises NotImplementedError where the fused kernels
    do not cover the architecture, ValueError where the tile does not fit."""
    ok, why = supports_fused_kernel(cfg, train=True)
    if not ok or is_wide(cfg):
        raise NotImplementedError(f"fused kernel does not cover: {why or _WIDE_WHY}")
    d = cfg.layer_dim
    ep, dp = _round_up(cfg.enc_in, MMA_K), _round_up(cfg.dir_in, MMA_K)
    ap = _round_up(cfg.appearance_dim, MMA_K)
    segments = _fwd_segments(cfg, ep, dp, ap)
    mats = [(n, _round_up(max(k + c for k, c in segs), MMA_K)) for n, segs in segments]
    # A stage holds the rows a warpgroup's wgmma reads: its output columns
    # in slices of 64, past N when N is not a multiple of 64.
    stage_bytes = 128 * min(FWD_BOX_ROWS, _round_up(max(n for n, _ in mats), FWD_BLOCK))
    widths = {"enc": ep, "dir": dp, "app": ap, "act": d}
    for tm in ((128, 64) if d <= 256 else (64,)):
        offsets, o = {}, 0
        for name, w in widths.items():
            offsets[name] = o
            o += _blocks(w) * tm * 128
        fixed = o + 4 * tm + FWD_ALIGN
        stages = min(FWD_MAX_STAGES, (FWD_SMEM_LIMIT - fixed) // (stage_bytes + 16))
        if stages >= 2:
            break
    else:
        raise ValueError(f"train_fwd: no tile fits {FWD_SMEM_LIMIT} B of shared "
                         f"memory for {cfg}")
    offsets["ring"] = o
    offsets["bar"] = o + stages * stage_bytes
    offsets["sig"] = offsets["bar"] + 16 * stages
    smem = offsets["sig"] + 4 * tm + FWD_ALIGN
    boxes = []
    for i, (n, segs) in enumerate(segments):
        for k, col in segs:
            for j in range(_blocks(k)):
                for h in range(-(-n // FWD_BOX_ROWS)):
                    boxes.append((i, col + FWD_BLOCK * j, FWD_BOX_ROWS * h))
    lay = _act_columns(cfg, ep, dp, ap)
    tiles = [(0, ep)] + [(lay["h0"] + i * d, d) for i in range(cfg.layers)]
    if cfg.uses_dir_branch:
        tiles += [(lay["final"], d), (lay["dir"], dp), (lay["app"], ap),
                  (lay["branch"], d // 2)]
    return TrainFwdPlan(tm, stages, stage_bytes, offsets, smem, lay["width"], mats,
                        boxes, sorted(_stores(tiles)))


def _fwd_library():
    from mega_nerf_tpu_torch.render._build import load_library

    lib = load_library("train_fwd")
    if not getattr(lib, "_fwd_bound", False):
        vp = ctypes.c_void_p
        lib.train_fwd_launch.argtypes = [vp, vp, vp, vp, vp, vp]
        lib.train_fwd_launch.restype = ctypes.c_int
        lib.error_string = lib.train_fwd_error_string
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib._fwd_bound = True
    return lib


def fused_nerf_train_fwd(packed: PackedMLP, xyz, dirs, app, noise):
    """Training forward -> ((M, 4) f32, saved rows (M, act width)).

    CPU tensors run `fused_nerf_train_fwd_plain`; CUDA tensors launch the
    kernel of `csrc/train_fwd.cu` (bf16 compute), which also writes the
    bf16 rows the backward reads, or of `csrc/train_f32.cu` (f32 compute,
    f32 rows), or raise.
    app: (M, appearance_dim) rows (any float dtype, exact in the compute
    dtype); noise: (M,) f32 or None."""
    if xyz.device.type == "cpu":
        return fused_nerf_train_fwd_plain(packed, xyz, dirs, app, noise)
    _cuda_only("fused_nerf_train_fwd", xyz)
    if app is not None:
        app = app.to(packed.config.dtype).contiguous()
    check_inputs(packed, xyz, dirs, app)
    m = xyz.shape[0]
    if noise is not None:
        if noise.dtype != torch.float32 or noise.shape != (m,) \
                or not noise.is_contiguous():
            raise ValueError("noise: expected contiguous f32 (M,)")
    if packed.config.dtype == torch.float32:
        from mega_nerf_tpu_torch.render.fused_f32 import fused_nerf_train_fwd_f32

        return fused_nerf_train_fwd_f32(packed, xyz, dirs, app, noise)
    plan = train_fwd_plan(packed.config)
    if plan.mats != [tuple(w.shape) for w in packed.mats]:
        raise ValueError("train_fwd: packed matrices do not match the plan")
    lib = _fwd_library()
    out = torch.empty((m, 4), dtype=torch.float32, device=xyz.device)
    act = torch.empty((m, plan.row_width), dtype=torch.bfloat16, device=xyz.device)
    if m == 0:
        return out, act
    c_ptrs, c_dims = launch_tables(packed, xyz, dirs, app, out)
    extra = [0 if noise is None else noise.data_ptr(), act.data_ptr()]
    o = plan.offsets
    ints = [plan.row_width, plan.tm, plan.stages, plan.stage_bytes, o["enc"],
            o["dir"], o["app"], o["act"], o["ring"], o["bar"], o["sig"],
            plan.smem_bytes]
    shapes = [v for s in plan.mats for v in s]
    err = lib.train_fwd_launch(
        c_ptrs, c_dims, (ctypes.c_longlong * 2)(*extra),
        (ctypes.c_int * len(ints))(*ints), (ctypes.c_int * len(shapes))(*shapes),
        _stream(xyz))
    fused_nerf_train_fwd.launches += 1
    _raise_if(lib, err, "fused_nerf_train_fwd")
    return out, act


fused_nerf_train_fwd.launches = 0


def transposed_weights(packed: PackedMLP) -> List[torch.Tensor]:
    """(Ktot, N) copies of the matmul weights for the backward-data
    kernel; dir_a's columns pad to `branch_k` with zeros."""
    cfg = packed.config
    out = [w.t().contiguous() for w in packed.mats]
    if packed.has_branch:
        kb = branch_k(cfg)
        out[-1] = F.pad(out[-1], (0, kb - cfg.layer_dim // 2)).contiguous()
    return out


class TrainBwdPlan(NamedTuple):
    """The backward-data kernel's tile and shared memory (train_bwd.cu).

    `tm` points per CTA, as the forward's plan picks them; `offsets` (grad,
    mask, ring, bar, heads) in bytes from the kernel's 1024-aligned base:
    the resident gradient tile, the mask tile, the ring, the barriers and
    the per-point head derivatives. `mats` (Ktot, N) per transposed matrix
    (`transposed_weights`). `first` (column, width): the gradient-row
    segment the elementwise start writes (d_a with the branch, else
    d_pre_{L-1}). `products` (matrix, first row, N, K, kind, column) in the
    order the kernel runs them: A is the gradient tile's first K columns, B
    rows [first row, + N) of the matrix; `column` is where the output goes
    in the gradient row (for BWD_APP, the first d_app column).
    `mask_loads` (column, width) of the saved rows the mask tile holds, in
    order: the first for the elementwise start, then one per masked
    product. `weight_boxes` (product, column, row) in ring order;
    `row_stores` (column, width) of every gradient-row store of a tile."""
    tm: int
    stages: int
    stage_bytes: int
    offsets: Dict[str, int]
    smem_bytes: int
    row_width: int
    mats: List[Tuple[int, int]]
    first: Tuple[int, int]
    products: List[Tuple[int, int, int, int, int, int]]
    mask_loads: List[Tuple[int, int]]
    weight_boxes: List[Tuple[int, int, int]]
    row_stores: List[Tuple[int, int]]


@functools.lru_cache(maxsize=None)
def train_bwd_plan(cfg: NeRFConfig) -> TrainBwdPlan:
    """The backward-data kernel's tile for `cfg`: 128 points when D <= 256
    and at least two ring stages fit, else 64; as many stages (up to 4) as
    the shared memory holds. Raises NotImplementedError where the fused
    kernels do not cover the architecture, ValueError where the tile does
    not fit."""
    ok, why = supports_fused_kernel(cfg, train=True)
    if not ok or is_wide(cfg):
        raise NotImplementedError(f"fused kernel does not cover: {why or _WIDE_WHY}")
    d, n_layers = cfg.layer_dim, cfg.layers
    ep, dp = _round_up(cfg.enc_in, MMA_K), _round_up(cfg.dir_in, MMA_K)
    ap = _round_up(cfg.appearance_dim, MMA_K)
    kb = branch_k(cfg)
    mats = [(_round_up(max(k + c for k, c in segs), MMA_K), n)
            for n, segs in _fwd_segments(cfg, ep, dp, ap)]
    al = _act_columns(cfg, ep, dp, ap)
    has_branch = cfg.uses_dir_branch
    if has_branch:  # dir_a's columns pad to KB
        mats[-1] = (mats[-1][0], kb)
    gl = _grad_columns(cfg)
    h_col = [al["h0"] + i * d for i in range(n_layers)]
    products, masks = [], []
    if has_branch:
        a = n_layers + 1
        for c in range(0, ap, FWD_BOX_ROWS):
            products.append((a, d + dp + c, min(FWD_BOX_ROWS, ap - c), kb, BWD_APP, c))
        products.append((a, 0, d, kb, BWD_FINAL, gl["dfinal"]))
        products.append((n_layers, 0, d, d, BWD_MASK_SIGMA, (n_layers - 1) * d))
        first = (gl["da"], kb)
        masks += [(al["branch"], d // 2), (h_col[-1], d)]
    else:
        first = ((n_layers - 1) * d, d)
        masks.append((h_col[-1], d))
    for i in reversed(range(1, n_layers)):
        row0 = ep if i in cfg.skip_layers else 0
        products.append((i, row0, d, d, BWD_MASK, (i - 1) * d))
        masks.append((h_col[i - 1], d))
    box_rows = max(min(n, FWD_BOX_ROWS) for _, _, n, _, _, _ in products)
    stage_bytes = 128 * _round_up(box_rows, FWD_BLOCK)
    tile = _blocks(d) * 128  # bytes of one row of the gradient or mask tile
    for tm in ((128, 64) if d <= 256 else (64,)):
        offsets = {"grad": 0, "mask": tile * tm, "ring": 2 * tile * tm}
        fixed = offsets["ring"] + 8 * tm + 32 + FWD_ALIGN
        stages = min(FWD_MAX_STAGES, (FWD_SMEM_LIMIT - fixed) // (stage_bytes + 16))
        if stages >= 2:
            break
    else:
        raise ValueError(f"train_bwd: no tile fits {FWD_SMEM_LIMIT} B of shared "
                         f"memory for {cfg}")
    offsets["bar"] = offsets["ring"] + stages * stage_bytes
    offsets["heads"] = offsets["bar"] + 16 * stages + 32
    smem = offsets["heads"] + 8 * tm + FWD_ALIGN
    boxes = [(p, FWD_BLOCK * j, row0 + FWD_BOX_ROWS * h)
             for p, (_, row0, n, k, _, _) in enumerate(products)
             for j in range(_blocks(k)) for h in range(-(-n // FWD_BOX_ROWS))]
    segments = [(i * d, d) for i in range(n_layers)]
    if has_branch:
        segments += [(gl["dfinal"], d), (gl["da"], kb)]
    segments.append((gl["heads"], 8))
    return TrainBwdPlan(tm, stages, stage_bytes, offsets, smem, gl["width"],
                        mats, first, products, masks, boxes,
                        sorted(_stores(segments)))


def _bwd_library():
    from mega_nerf_tpu_torch.render._build import load_library

    lib = load_library("train_bwd")
    if not getattr(lib, "_bwd_bound", False):
        vp = ctypes.c_void_p
        lib.train_bwd_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp]
        lib.train_bwd_launch.restype = ctypes.c_int
        lib.error_string = lib.train_bwd_error_string
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib._bwd_bound = True
    return lib


def _ints(values) -> ctypes.Array:
    values = list(values)
    return (ctypes.c_int * max(len(values), 1))(*values)


def train_bwd_data(packed: PackedMLP, act: torch.Tensor, g: torch.Tensor,
                   noise: Optional[torch.Tensor]):
    """The backward-data kernel -> (gradient rows (M, grad width) in the
    compute dtype, d_app (M, appearance_dim) f32 or None). CPU tensors run
    `train_bwd_data_plain`; CUDA tensors launch the kernel of
    `csrc/train_bwd.cu` (bf16 compute, `wgmma` over `transposed_weights`)
    or of `csrc/train_f32.cu` (f32 compute: 3xTF32 split products on
    `wgmma` over the same transposed matrices and their TF32 rests,
    `fused_f32.t_rests`), or raise."""
    if act.device.type == "cpu":
        return train_bwd_data_plain(packed, act, g, noise)
    _cuda_only("train_bwd_data", act)
    cfg = packed.config
    m = act.shape[0]
    if g.dtype != torch.float32 or g.shape != (m, 4) or not g.is_contiguous():
        raise ValueError("g: expected contiguous f32 (M, 4)")
    if noise is not None and (noise.dtype != torch.float32 or noise.shape != (m,)
                              or not noise.is_contiguous()):
        raise ValueError("noise: expected contiguous f32 (M,)")
    al = act_layout(packed)
    if act.dtype != cfg.dtype or act.shape[1] != al["width"] \
            or not act.is_contiguous():
        raise ValueError(f"act: expected the contiguous {cfg.compute_dtype} saved rows")
    if cfg.dtype == torch.float32:
        from mega_nerf_tpu_torch.render.fused_f32 import train_bwd_data_f32

        return train_bwd_data_f32(packed, act, g, noise)
    plan = train_bwd_plan(cfg)
    wts = transposed_weights(packed)
    if plan.mats != [tuple(w.shape) for w in wts]:
        raise ValueError("train_bwd: packed matrices do not match the plan")
    grad = torch.empty((m, plan.row_width), dtype=torch.bfloat16, device=act.device)
    d_app = None
    if packed.ap:
        d_app = torch.empty((m, cfg.appearance_dim), dtype=torch.float32,
                            device=act.device)
    if m == 0:
        return grad, d_app
    lib = _bwd_library()
    ptrs = [act.data_ptr(), grad.data_ptr(), g.data_ptr(),
            0 if noise is None else noise.data_ptr(),
            0 if d_app is None else d_app.data_ptr(),
            packed.sigma_w.data_ptr(), packed.sigma_b.data_ptr(),
            packed.rgb_w.data_ptr(), packed.rgb_b.data_ptr()]
    ptrs += [w.data_ptr() for w in wts]
    d = cfg.layer_dim
    h_last = al["h0"] + (cfg.layers - 1) * d
    dims = [m, d, int(packed.has_branch), int(cfg.shifted_softplus),
            cfg.appearance_dim, al["width"], plan.row_width, h_last,
            al["branch"] if packed.has_branch else h_last,
            d // 2 if packed.has_branch else d, *plan.first]
    o = plan.offsets
    ints = [plan.tm, plan.stages, plan.stage_bytes, o["grad"], o["mask"], o["ring"],
            o["bar"], o["heads"], plan.smem_bytes, len(plan.products),
            len(plan.mask_loads), len(plan.mats)]
    err = lib.train_bwd_launch(
        (ctypes.c_longlong * len(ptrs))(*ptrs), _ints(dims), _ints(ints),
        _ints(v for pr in plan.products for v in pr),
        _ints(v for ml in plan.mask_loads for v in ml),
        _ints(v for s in plan.mats for v in s), _stream(act))
    train_bwd_data.launches += 1
    _raise_if(lib, err, "train_bwd_data")
    return grad, d_app


train_bwd_data.launches = 0


def weight_grad_jobs(packed: PackedMLP) -> List[Tuple[int, ...]]:
    """The weight-gradient kernel's jobs (weight_grad.cu Job): (d_col, n,
    x_col, k, out_off, out_stride, bias_off) per GEMM, offsets into the
    flat f32 gradient buffer in `packed_shapes` order."""
    cfg = packed.config
    d, n_layers = cfg.layer_dim, cfg.layers
    al, gl = act_layout(packed), grad_layout(packed)
    offs = _offsets(packed_shapes(packed))
    jobs = []
    for i in range(n_layers):
        w_off, b_off = offs[2 * i], offs[2 * i + 1]
        ktot = packed.mats[i].shape[1]
        if i == 0:
            jobs.append((i * d, d, 0, packed.ep, w_off, ktot, b_off))
        elif i in cfg.skip_layers:
            jobs.append((i * d, d, 0, packed.ep, w_off, ktot, b_off))
            jobs.append((i * d, d, al["h0"] + (i - 1) * d, d, w_off + packed.ep,
                         ktot, -1))
        else:
            jobs.append((i * d, d, al["h0"] + (i - 1) * d, d, w_off, ktot, b_off))
    h_last = al["h0"] + (n_layers - 1) * d
    k = 2 * len(packed.mats)
    jobs.append((gl["heads"], 1, h_last, d, offs[k], d, offs[k + 1]))
    if packed.has_branch:
        f = 2 * n_layers
        jobs.append((gl["dfinal"], d, h_last, d, offs[f], d, offs[f + 1]))
        ka = packed.mats[n_layers + 1].shape[1]
        jobs.append((gl["da"], d // 2, al["final"], ka, offs[f + 2], ka,
                     offs[f + 3]))
        rgb_x, rgb_in = al["branch"], d // 2
    else:
        rgb_x, rgb_in = h_last, d
    jobs.append((gl["heads"] + 1, 3, rgb_x, rgb_in, offs[k + 2], rgb_in,
                 offs[k + 3]))
    return jobs


class WeightGradPlan(NamedTuple):
    """The weight-gradient kernel's work: `tiles` (job, n0, k0) output
    tiles of WG_TILE_N x WG_TILE_K (or WG_IDLE), in pairs: tiles 2c and
    2c + 1 run as one cluster of two CTAs sharing what `share[c]` says;
    each tile is summed over `splits` ranges of `split_len` points (a
    multiple of WG_STAGE; the last range ends at M). The CTA of split s and
    tile t is s * len(tiles) + t, and the last CTA of a tile adds the
    partials in split order 0, 1, ..., splits - 1."""
    jobs: List[Tuple[int, ...]]
    tiles: List[Tuple[int, int, int]]
    share: List[int]
    splits: int
    split_len: int


def _pair_tiles(jobs) -> Tuple[List[Tuple[int, int, int]], List[int]]:
    """Tiles in cluster pairs: the n-tiles of a job at one k0 share X; a
    job's leftover tiles at one n0 share d_pre; the rest pair up sharing
    nothing (with an idle tile if their count is odd)."""
    tiles: List[Tuple[int, int, int]] = []
    share: List[int] = []
    singles: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
    for j, job in enumerate(jobs):
        for k0 in range(0, job[3], WG_TILE_K):
            ns = list(range(0, job[1], WG_TILE_N))
            for i in range(0, len(ns) - 1, 2):
                tiles += [(j, ns[i], k0), (j, ns[i + 1], k0)]
                share.append(WG_SHARE_X)
            if len(ns) % 2:
                singles.setdefault((j, ns[-1]), []).append((j, ns[-1], k0))
    rest = []
    for group in singles.values():
        for i in range(0, len(group) - 1, 2):
            tiles += group[i:i + 2]
            share.append(WG_SHARE_A)
        if len(group) % 2:
            rest.append(group[-1])
    if len(rest) % 2:
        rest.append(WG_IDLE)
    for i in range(0, len(rest), 2):
        tiles += rest[i:i + 2]
        share.append(WG_SHARE_NONE)
    return tiles, share


def weight_grad_plan(packed: PackedMLP, m: int, resident: int = 132) -> WeightGradPlan:
    """Tiles and splits of one launch over m points on a card that holds
    `resident` CTAs at once (one per SM, in clusters of two): as many splits
    as fill WG_WAVES waves, at least WG_MIN_SPLIT points each."""
    jobs = weight_grad_jobs(packed)
    for d_col, n, x_col, _, _, _, _ in jobs:
        # The kernel's TMA boxes start on 16 B: X columns always, d_pre
        # columns up to `d_col % 8` rows into one output tile.
        if x_col % 8 or (d_col % 8 and n + d_col % 8 > WG_TILE_N):
            raise ValueError(f"weight_grad: job at columns {d_col}/{x_col} "
                             "does not fit the kernel's tiles")
    tiles, share = _pair_tiles(jobs)
    splits = max(1, min(WG_WAVES * resident // len(tiles), -(-m // WG_MIN_SPLIT)))
    split_len = _round_up(-(-m // splits), WG_STAGE)
    return WeightGradPlan(jobs, tiles, share, -(-m // split_len), split_len)


def weight_grad(packed: PackedMLP, act: torch.Tensor,
                grad: torch.Tensor) -> torch.Tensor:
    """The weight-gradient kernel -> flat f32 gradients in `packed_shapes`
    order (split-K over points, splits summed in a fixed order). CPU
    tensors run `weight_grad_plain`; CUDA tensors launch the kernel of
    `csrc/weight_grad.cu` (bf16 rows) or of `csrc/train_f32.cu` (f32
    rows), or raise."""
    if act.device.type == "cpu":
        return weight_grad_plain(packed, act, grad)
    _cuda_only("weight_grad", act)
    m = act.shape[0]
    dt = packed.config.dtype
    for name, t in (("act", act), ("grad", grad)):
        if t.dtype != dt or t.shape[0] != m or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {packed.config.compute_dtype} "
                             "rows, one per point")
    if dt == torch.float32:
        from mega_nerf_tpu_torch.render.fused_f32 import weight_grad_f32

        return weight_grad_f32(packed, act, grad)
    total = _offsets(packed_shapes(packed))[-1]
    out = torch.empty(total, dtype=torch.float32, device=act.device)
    if m == 0:
        return out.zero_()
    lib = _wg_library()
    plan = weight_grad_plan(packed, m, _resident_ctas(lib, act.device))
    ntiles = len(plan.tiles)
    scratch = torch.empty(plan.splits * ntiles * WG_TILE_ELEMS,
                          dtype=torch.float32, device=act.device)
    counters = torch.zeros(ntiles, dtype=torch.int32, device=act.device)
    ptrs = [act.data_ptr(), grad.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), counters.data_ptr()]
    dims = [m, len(plan.jobs), ntiles, plan.splits, plan.split_len,
            act.shape[1], grad.shape[1]]
    jobs = [v for j in plan.jobs for v in j]
    tiles = [v for t in plan.tiles for v in t]
    err = lib.weight_grad_launch(
        (ctypes.c_longlong * len(ptrs))(*ptrs), (ctypes.c_int * len(dims))(*dims),
        (ctypes.c_int * len(jobs))(*jobs), (ctypes.c_int * len(tiles))(*tiles),
        (ctypes.c_int * len(plan.share))(*plan.share), _stream(act))
    weight_grad.launches += 1
    _raise_if(lib, err, "weight_grad")
    return out


weight_grad.launches = 0


def fused_nerf_train_bwd(
    packed: PackedMLP, act: torch.Tensor, noise: Optional[torch.Tensor],
    g: torch.Tensor,
) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """Backward of the training forward from its saved rows -> (packed-layout
    gradients in `packed_shapes` order, d_app or None): `train_bwd_data`
    then `weight_grad` (their plain versions on CPU tensors)."""
    grad, d_app = train_bwd_data(packed, act, g.float().contiguous(), noise)
    return split_grads(packed, weight_grad(packed, act, grad)), d_app


def split_grads(packed: PackedMLP, flat: torch.Tensor) -> List[torch.Tensor]:
    """A flat f32 gradient buffer as views in `packed_shapes` order."""
    shapes = packed_shapes(packed)
    offs = _offsets(shapes)
    return [flat[offs[i]:offs[i + 1]].view(s) for i, s in enumerate(shapes)]


# -------------------------------------------------------- autograd Function


class _TrainApply(torch.autograd.Function):
    """The fused chain to width 512; past it the wide route, which saves
    every layer's output by name (imported here: it builds on this module)."""

    @staticmethod
    def forward(ctx, cfg, xyz, dirs, app, noise, *params):
        packed = pack_tensors(cfg, dict(zip(mlp_param_names(cfg), params)))
        if is_wide(cfg):
            from mega_nerf_tpu_torch.render.fused_train_wide import fused_nerf_train_wide_fwd

            out, saved = fused_nerf_train_wide_fwd(packed, xyz, dirs, app, noise)
        else:
            out, act = fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
            saved = {"act": act, "noise": noise}
        ctx.cfg, ctx.packed, ctx.names = cfg, packed, list(saved)
        ctx.save_for_backward(*saved.values(), *params)
        return out

    @staticmethod
    def backward(ctx, g):
        tensors = ctx.saved_tensors
        saved, params = dict(zip(ctx.names, tensors)), tensors[len(ctx.names):]
        if is_wide(ctx.cfg):
            from mega_nerf_tpu_torch.render.fused_train_wide import fused_nerf_train_wide_bwd

            flat, d_app = fused_nerf_train_wide_bwd(ctx.packed, saved, g)
            grads = split_grads(ctx.packed, flat)
        else:
            grads, d_app = fused_nerf_train_bwd(ctx.packed, saved["act"], saved["noise"], g)
        param_grads = unpack_grads(ctx.cfg, grads, params)
        return (None, None, None, d_app if ctx.needs_input_grad[3] else None,
                None, *param_grads)


def fused_nerf_train_apply(
    module: NeRF,
    xyz: torch.Tensor,  # (M, xyz_dim) f32
    dirs: Optional[torch.Tensor],  # (M, 3) direction coordinates
    app: Optional[torch.Tensor],  # (M, appearance_dim) gathered rows, f32
    sigma_noise: Optional[torch.Tensor],  # (M,) f32, or None
) -> torch.Tensor:
    """Differentiable fused forward -> (M, 4) [sigmoid rgb, activated
    sigma]; gradients flow to the module's MLP parameters and to `app`.
    CPU tensors run the plain versions; CUDA tensors the kernels (bf16 or
    f32 compute; past width 512 the wide route's, to 1024)."""
    cfg = module.config
    named = dict(module.named_parameters())
    params = [named[n] for n in mlp_param_names(cfg)]
    return _TrainApply.apply(cfg, xyz, dirs, app, sigma_noise, *params)


__all__ = [
    "fused_nerf_train_apply", "fused_nerf_train_fwd",
    "fused_nerf_train_fwd_plain", "fused_nerf_train_bwd", "train_bwd_data",
    "train_bwd_data_plain", "weight_grad", "weight_grad_plain",
    "act_layout", "grad_layout", "packed_shapes", "split_grads", "unpack_grads",
    "weight_grad_jobs", "weight_grad_plan", "train_fwd_plan", "train_bwd_plan",
]
