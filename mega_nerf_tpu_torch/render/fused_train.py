"""Fused NeRF training MLP: the differentiable apply, plain versions and the
kernel wrappers.

Counterpart of the JAX package's `render/pallas_train.py`. The hand-written
Hopper kernels are in `csrc/fused_train.cu`; they replace
`mega_nerf_tpu/render/pallas_train.py::_train_fwd_kernel` and
`::_train_bwd_kernel`.

- `fused_nerf_train_apply(module, xyz, dirs, app, sigma_noise)` is a
  `torch.autograd.Function`. It takes the module's f32 parameters as inputs
  and packs them into the compute dtype inside the call (as the JAX path
  packs with `cast=False`), and returns their gradients in their own
  shapes (padding columns dropped), plus d_app for the gathered appearance
  rows (f32, bf16-exact values). Positions, directions and noise get no
  gradient.
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
  launches its kernel on a CUDA tensor, or raises.
- Each kernel wrapper counts its launches in `.launches`; each plain version
  its calls in `.calls`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from mega_nerf_tpu_torch.models.nerf import NeRF, NeRFConfig
from mega_nerf_tpu_torch.render.fused_mlp import (
    MMA_K,
    ForwardTrace,
    PackedMLP,
    _round_up,
    check_inputs,
    forward_trace,
    launch_tables,
    mat_layout,
    mlp_param_names,
    pack_tensors,
    skip_mask,
)

WG_TILE = 128  # weight-gradient output tile side (fused_train.cu WN, WK)
WG_CHUNK = 32  # points per weight-gradient chunk (fused_train.cu MC)
WG_TILE_ELEMS = WG_TILE * WG_TILE + WG_TILE
WG_TARGET_CTAS = 132 * 8  # ~4 waves of an H100 at two CTAs per SM
WG_MIN_SPLIT = 4096  # points per split at least


# ------------------------------------------------------------------ layouts


def branch_k(cfg: NeRFConfig) -> int:
    """Width of the d_a_pre tile: D / 2 rounded up to the MMA depth."""
    return _round_up(cfg.layer_dim // 2, MMA_K)


def act_layout(packed: PackedMLP) -> Dict[str, int]:
    """Column offsets of a saved activation row (fused_train.cu ActLayout)."""
    cfg = packed.config
    d, n = cfg.layer_dim, cfg.layers
    lay = {"h0": packed.ep, "final": packed.ep + n * d}
    lay["dir"] = lay["final"] + d
    lay["app"] = lay["dir"] + packed.dp
    lay["branch"] = lay["app"] + packed.ap
    lay["width"] = lay["branch"] + d // 2 if packed.has_branch else lay["final"]
    return lay


def grad_layout(packed: PackedMLP) -> Dict[str, int]:
    """Column offsets of a gradient row (fused_train.cu GradLayout)."""
    cfg = packed.config
    d, n = cfg.layer_dim, cfg.layers
    lay = {"dfinal": n * d, "da": n * d + d}
    lay["heads"] = lay["da"] + branch_k(cfg) if packed.has_branch else n * d
    lay["width"] = lay["heads"] + 8
    return lay


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
                    noise: Optional[torch.Tensor]) -> ForwardTrace:
    """A ForwardTrace read from the saved rows; the sigma and rgb
    pre-activations are recomputed from them as the backward kernel does."""
    cfg = packed.config
    d, lay = cfg.layer_dim, act_layout(packed)
    hs = [act[:, lay["h0"] + i * d:lay["h0"] + (i + 1) * d]
          for i in range(cfg.layers)]
    sigma_pre = hs[-1].float() @ packed.sigma_w.float() + packed.sigma_b
    if noise is not None:
        sigma_pre = sigma_pre + noise.float()
    branch_in = branch = None
    h = hs[-1]
    if packed.has_branch:
        branch_in = act[:, lay["final"]:lay["branch"]]
        branch = h = act[:, lay["branch"]:lay["width"]]
    rgb_pre = h.float() @ packed.rgb_w.float().T + packed.rgb_b
    return ForwardTrace(act[:, :packed.ep], branch_in, hs, sigma_pre, branch,
                        rgb_pre)


def train_bwd_data_plain(packed: PackedMLP, act: torch.Tensor, g: torch.Tensor,
                         noise: Optional[torch.Tensor]):
    """Plain version of the backward-data kernel -> (gradient rows (M, grad
    width) in the compute dtype, d_app (M, appearance_dim) f32 or None).

    `_train_bwd_kernel`'s steps: the cotangent rounded to the compute
    dtype, output derivatives in f32, then per layer d_pre = round(d_h *
    (h > 0)) and d_h = d_pre @ W in f32."""
    train_bwd_data_plain.calls += 1
    cfg = packed.config
    dt = cfg.dtype
    n_layers, d = cfg.layers, cfg.layer_dim
    tr = trace_from_rows(packed, act, noise)

    def rnd(x):
        return x.to(dt).float()

    g = rnd(g.float())
    s = torch.sigmoid(tr.rgb_pre)
    g_rgb = rnd(g[:, :3] * s * (1.0 - s))
    if cfg.shifted_softplus:
        g_sig = rnd(g[:, 3] * torch.sigmoid(tr.sigma_pre - 1.0))
    else:
        g_sig = rnd(g[:, 3] * (tr.sigma_pre > 0).float())
    heads = F.pad(torch.cat([g_sig[:, None], g_rgb], -1), (0, 4))

    d_h_sig = g_sig[:, None] * packed.sigma_w.float()[None]
    d_app = None
    tail = []
    if packed.has_branch:
        d_a = rnd((g_rgb @ packed.rgb_w.float()) * (tr.branch.float() > 0))
        w_a = packed.mats[n_layers + 1].float()
        if packed.ap:
            col = d + packed.dp
            d_app = d_a @ w_a[:, col:col + cfg.appearance_dim]
        d_final = rnd(d_a @ w_a[:, :d])
        d_h = d_final @ packed.mats[n_layers].float() + d_h_sig
        tail = [d_final, F.pad(d_a, (0, branch_k(cfg) - d // 2))]
    else:
        d_h = d_h_sig + g_rgb @ packed.rgb_w.float()

    d_pres = [None] * n_layers
    for i in reversed(range(n_layers)):
        d_pres[i] = rnd(d_h * (tr.hs[i].float() > 0))
        if i > 0:
            w = packed.mats[i].float()
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


def _library():
    from mega_nerf_tpu_torch.render._build import load_library

    lib = load_library("fused_train")
    if not getattr(lib, "_train_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_nerf_train_fwd_launch.argtypes = [vp, vp, ctypes.c_longlong,
                                                    ctypes.c_longlong, ci, vp]
        lib.train_bwd_data_launch.argtypes = [vp, vp, vp]
        lib.weight_grad_launch.argtypes = [vp, vp, vp, vp]
        for fn in (lib.fused_nerf_train_fwd_launch, lib.train_bwd_data_launch,
                   lib.weight_grad_launch):
            fn.restype = ci
        lib.fused_train_error_string.argtypes = [ci]
        lib.fused_train_error_string.restype = ctypes.c_char_p
        lib._train_bound = True
    return lib


def _raise_if(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.fused_train_error_string(err).decode())


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _cuda_only(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")


def fused_nerf_train_fwd(packed: PackedMLP, xyz, dirs, app, noise):
    """Training forward -> ((M, 4) f32, saved rows (M, act width)).

    CPU tensors run `fused_nerf_train_fwd_plain`; CUDA tensors launch the
    kernel, which also writes the bf16 rows the backward reads, or raise.
    app: (M, appearance_dim) rows (any float dtype, bf16-exact values);
    noise: (M,) f32 or None."""
    if xyz.device.type == "cpu":
        return fused_nerf_train_fwd_plain(packed, xyz, dirs, app, noise)
    _cuda_only("fused_nerf_train_fwd", xyz)
    if app is not None:
        app = app.to(torch.bfloat16).contiguous()
    check_inputs(packed, xyz, dirs, app)
    m = xyz.shape[0]
    if noise is not None:
        if noise.dtype != torch.float32 or noise.shape != (m,) \
                or not noise.is_contiguous():
            raise ValueError("noise: expected contiguous f32 (M,)")
    lib = _library()
    width = act_layout(packed)["width"]
    out = torch.empty((m, 4), dtype=torch.float32, device=xyz.device)
    act = torch.empty((m, width), dtype=torch.bfloat16, device=xyz.device)
    if m == 0:
        return out, act
    c_ptrs, c_dims = launch_tables(packed, xyz, dirs, app, out)
    err = lib.fused_nerf_train_fwd_launch(
        c_ptrs, c_dims, 0 if noise is None else noise.data_ptr(),
        act.data_ptr(), width, _stream(xyz))
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


def train_bwd_data(packed: PackedMLP, act: torch.Tensor, g: torch.Tensor,
                   noise: Optional[torch.Tensor]):
    """The backward-data kernel -> (gradient rows (M, grad width) bf16,
    d_app (M, appearance_dim) f32 or None). CPU tensors run
    `train_bwd_data_plain`."""
    if act.device.type == "cpu":
        return train_bwd_data_plain(packed, act, g, noise)
    _cuda_only("train_bwd_data", act)
    cfg = packed.config
    m = act.shape[0]
    if g.dtype != torch.float32 or g.shape != (m, 4) or not g.is_contiguous():
        raise ValueError("g: expected contiguous f32 (M, 4)")
    lib = _library()
    gl = grad_layout(packed)
    grad = torch.empty((m, gl["width"]), dtype=torch.bfloat16, device=act.device)
    d_app = None
    if packed.ap:
        d_app = torch.empty((m, cfg.appearance_dim), dtype=torch.float32,
                            device=act.device)
    if m == 0:
        return grad, d_app
    wts = transposed_weights(packed)
    ptrs = [act.data_ptr(), grad.data_ptr(), g.data_ptr(),
            0 if noise is None else noise.data_ptr(),
            0 if d_app is None else d_app.data_ptr(),
            packed.sigma_w.data_ptr(), packed.sigma_b.data_ptr(),
            packed.rgb_w.data_ptr(), packed.rgb_b.data_ptr()]
    ptrs += [w.data_ptr() for w in wts]
    dims = [m, cfg.layers, cfg.layer_dim, skip_mask(cfg),
            int(packed.has_branch), int(cfg.shifted_softplus), packed.ep,
            packed.dp, packed.ap, cfg.appearance_dim, branch_k(cfg),
            act.shape[1], gl["width"]]
    err = lib.train_bwd_data_launch(
        (ctypes.c_longlong * len(ptrs))(*ptrs), (ctypes.c_int * len(dims))(*dims),
        _stream(act))
    train_bwd_data.launches += 1
    _raise_if(lib, err, "train_bwd_data")
    return grad, d_app


train_bwd_data.launches = 0


def weight_grad_jobs(packed: PackedMLP) -> List[Tuple[int, ...]]:
    """The weight-gradient kernel's jobs (fused_train.cu Job): (d_col, n,
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


def _tiles(jobs) -> int:
    return sum(-(-j[1] // WG_TILE) * -(-j[3] // WG_TILE) for j in jobs)


def weight_grad(packed: PackedMLP, act: torch.Tensor,
                grad: torch.Tensor) -> torch.Tensor:
    """The weight-gradient kernel -> flat f32 gradients in `packed_shapes`
    order (split-K over points, splits summed in a fixed order). CPU
    tensors run `weight_grad_plain`."""
    if act.device.type == "cpu":
        return weight_grad_plain(packed, act, grad)
    _cuda_only("weight_grad", act)
    m = act.shape[0]
    jobs = weight_grad_jobs(packed)
    tiles = _tiles(jobs)
    total = _offsets(packed_shapes(packed))[-1]
    out = torch.empty(total, dtype=torch.float32, device=act.device)
    if m == 0:
        return out.zero_()
    splits = max(1, min(-(-WG_TARGET_CTAS // tiles), -(-m // WG_MIN_SPLIT)))
    split_len = _round_up(-(-m // splits), WG_CHUNK)
    splits = -(-m // split_len)
    scratch = torch.empty(splits * tiles * WG_TILE_ELEMS, dtype=torch.float32,
                          device=act.device)
    counters = torch.zeros(tiles, dtype=torch.int32, device=act.device)
    lib = _library()
    ptrs = [act.data_ptr(), grad.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), counters.data_ptr()]
    dims = [m, len(jobs), tiles, splits, split_len, act.shape[1], grad.shape[1]]
    flat = [v for j in jobs for v in j]
    err = lib.weight_grad_launch(
        (ctypes.c_longlong * len(ptrs))(*ptrs), (ctypes.c_int * len(dims))(*dims),
        (ctypes.c_int * len(flat))(*flat), _stream(act))
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
    flat = weight_grad(packed, act, grad)
    shapes = packed_shapes(packed)
    offs = _offsets(shapes)
    grads = [flat[offs[i]:offs[i + 1]].view(s) for i, s in enumerate(shapes)]
    return grads, d_app


# -------------------------------------------------------- autograd Function


class _TrainApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, xyz, dirs, app, noise, *params):
        packed = pack_tensors(cfg, dict(zip(mlp_param_names(cfg), params)))
        out, act = fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
        ctx.cfg, ctx.packed = cfg, packed
        ctx.save_for_backward(act, noise, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        act, noise, *params = ctx.saved_tensors
        grads, d_app = fused_nerf_train_bwd(ctx.packed, act, noise, g)
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
    sigma]; gradients flow to the module's MLP parameters and to `app`."""
    cfg = module.config
    named = dict(module.named_parameters())
    params = [named[n] for n in mlp_param_names(cfg)]
    return _TrainApply.apply(cfg, xyz, dirs, app, sigma_noise, *params)


__all__ = [
    "fused_nerf_train_apply", "fused_nerf_train_fwd",
    "fused_nerf_train_fwd_plain", "fused_nerf_train_bwd", "train_bwd_data",
    "train_bwd_data_plain", "weight_grad", "weight_grad_plain",
    "act_layout", "grad_layout", "packed_shapes", "unpack_grads",
    "weight_grad_jobs",
]
