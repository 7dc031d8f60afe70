"""The wide MLP in f32 compute (512 < layer_dim <= 1024, `--compute_dtype
float32`): wrappers of the hand-written kernels of `csrc/wide_f32.cu`.

Counterparts of the JAX package's Pallas kernels in f32 compute at the
widths their gates admit past the port's f32 chain (`fused_f32.py`, <= 512):
`render/pallas_mlp.py::_mlp_kernel` (eval) and `render/pallas_train.py::
_train_fwd_kernel` / `::_train_bwd_kernel` (training), which JAX runs in f32
to width 1024. f32 accuracy: f32 operands and sums; the GEMM's products are
3xTF32 split products on the tensor cores (within 1e-5 of f64 products,
where one-pass TF32 is not), so an f32 run gets the numbers of the port's
f32 eager module and of the JAX package's f32 kernels, to summation order
and that split's last bits.

- `wide_f32_encode`: the f32 encodes (M, EP) and (M, DP), by `eval_wide.cu`'s
  encode design carried to f32 rows: persistent CTAs over tiles of
  `fused_wide.encode_plan(..., 4)` points, a lane per point walking one
  coordinate's frequencies (`fused_wide.encode_walk`), each sine through
  one Cody-Waite reduction (bit for bit sinf), rows staged in shared memory
  and stored as one contiguous range;
- `wide_f32_gemm`: Y = epilogue(sum_s X_s W[:, seg_s]^T) in two forms:
  `wide_f32_layer` (a forward layer: bias, optional ReLU) and `wide_f32_dx`
  (a backward-data job on `fused_train.transposed_weights`, the epilogues
  `fused_train_wide.DX_*`);
- `wide_f32_heads_fwd`: the sigma and rgb heads, with sigma noise and the
  pre-activations in training, without both in eval (the same kernel, so
  the eval heads equal the training heads without noise bit for bit);
- `wide_f32_heads_bwd`: the heads' backward, f32 rows of
  `fused_train_wide.HEADS_GRAD_WIDTH` columns and d_pre;
- `wide_f32_dw`: a dW step of `fused_train_wide.train_wide_plan`, through
  the f32 weight-gradient kernel pair of `csrc/train_f32.cu`
  (`fused_f32.weight_grad_f32_jobs`), which the narrow f32 route launches
  too.

The bf16 wrappers of `fused_wide.py` and `fused_train_wide.py` call these
on CUDA tensors when the compute dtype (the packed weights') is f32, so
`fused_nerf_eval_wide`, `fused_nerf_train_wide_fwd` and
`fused_nerf_train_wide_bwd` run them with no code of their own. Each
wrapper runs its plain version (the wide route's, dtype-generic) on CPU
tensors and launches its kernel on CUDA tensors or raises; each kernel
counts its launches in `.launches`, apart from the bf16 wide kernels and
the narrow f32 kernels (the weight gradient in `fused_f32.weight_grad_f32`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from mega_nerf_tpu_torch.render.fused_f32 import WgJob, weight_grad_f32_jobs
from mega_nerf_tpu_torch.render.fused_mlp import (
    MMA_K,
    PackedMLP,
    _check,
    _raise_if,
    _resident_ctas,
    _round_up,
)
from mega_nerf_tpu_torch.render.fused_train import _ints, _stream
from mega_nerf_tpu_torch.render.fused_wide import (
    ENCODE_MAX_SMEM,
    WIDE_MAX_SEGMENTS,
    _device_rule,
    _longs,
    encode_plan,
    eval_wide_encode_plain,
    eval_wide_layer_plain,
    segment_columns,
)

F32 = torch.float32
# The GEMM's plan (wide_f32.cu BM, BN, BK, STAGES, GEMM_SMEM; its launcher
# checks this copy): 128 x 128 output tiles, 32-column k-stages (one
# 128-byte swizzle row of f32), a 4-stage ring of three 16 KB boxes a stage
# (A, W, W's TF32 rests), barriers and 1 KB of alignment.
GEMM_TILE_M = 128
GEMM_TILE_N = 128
GEMM_K = 32
GEMM_STAGES = 4
GEMM_SMEM = GEMM_STAGES * 3 * GEMM_TILE_M * GEMM_K * 4 + 2 * GEMM_STAGES * 8 + 1024
# k-stages of a chain of tensor-core products, run from zero and then added
# into the f32 totals (wide_f32.cu CHAIN_STAGES): 8 k-steps of 8.
GEMM_CHAIN = 2
# The GEMM's epilogues (wide_f32.cu EPI_*): the backward-data forms are
# fused_train_wide.DX_* (0-3), then the forward layer's.
EPI_LAYER = 4
EPI_LAYER_RELU = 5


def _library() -> ctypes.CDLL:
    from mega_nerf_tpu_torch.render._build import load_library

    lib = load_library("wide_f32")
    if not getattr(lib, "_wide_f32_bound", False):
        vp = ctypes.c_void_p
        for fn in ("wide_f32_encode_launch", "wide_f32_heads_fwd_launch",
                   "wide_f32_heads_bwd_launch"):
            getattr(lib, fn).argtypes = [vp, vp, vp]
            getattr(lib, fn).restype = ctypes.c_int
        lib.wide_f32_gemm_launch.argtypes = [vp, vp, vp, ctypes.c_int, vp]
        lib.wide_f32_gemm_launch.restype = ctypes.c_int
        lib.wide_f32_resident_ctas.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.wide_f32_resident_ctas.restype = ctypes.c_int
        lib.error_string = lib.wide_f32_error_string
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib._wide_f32_bound = True
    return lib


def _check_f32_rows(name: str, t: torch.Tensor, rows: int, cols: int) -> None:
    """A row-major f32 (rows, cols) view the kernels read in 16-byte pieces:
    unit column stride, 16-byte aligned base and row stride."""
    ok = (t.dtype == F32 and t.dim() == 2 and tuple(t.shape) == (rows, cols)
          and t.stride(1) == 1 and t.stride(0) % 4 == 0 and t.data_ptr() % 16 == 0)
    if not ok:
        raise ValueError(
            f"{name}: expected an f32 ({rows}, {cols}) view with unit column stride "
            f"and 16-byte aligned base and rows, got {t.dtype} {tuple(t.shape)} "
            f"strides {t.stride()}")


def _check_weights(name: str, packed: PackedMLP, device) -> None:
    if packed.config.dtype != F32:
        raise ValueError(f"{name}: the f32 kernels take an f32 compute dtype, got "
                         f"{packed.config.compute_dtype}")
    for t in (packed.sigma_w, packed.rgb_w, packed.sigma_b, packed.rgb_b):
        if t.dtype != F32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: head weights must be contiguous f32 on the rows' "
                             "device")


# ------------------------------------------------------------------ encode


def wide_f32_encode(packed: PackedMLP, xyz: torch.Tensor, dirs: Optional[torch.Tensor],
                    enc: Optional[torch.Tensor] = None,
                    dir_enc: Optional[torch.Tensor] = None):
    """-> (enc (M, EP), dir enc (M, DP) or None), f32, in the column form of
    `fused_mlp.encode` (cos as sin(x 2^k + pi/2), sinf's results). On CUDA
    tensors the kernel writes into `enc` / `dir_enc` when given (contiguous,
    16-byte aligned: the kernel stores 16-byte chunks), else into new
    tensors; xyz_dim 1-4, with dirs or without. Its tile and shared memory
    are `fused_wide.encode_plan` at 4 bytes an element, which the launcher
    checks against its own copy."""
    if not _device_rule("wide_f32_encode", xyz):
        return eval_wide_encode_plain(packed, xyz, dirs)
    cfg = packed.config
    if cfg.dtype != F32:
        raise ValueError(f"wide_f32_encode: f32 compute only, got {cfg.compute_dtype}")
    if not 1 <= cfg.xyz_dim <= 4:
        raise ValueError(f"wide_f32_encode: xyz_dim {cfg.xyz_dim} (the kernel takes 1-4)")
    tile, smem = encode_plan(cfg.xyz_dim, packed.ep, packed.dp, 4)
    if smem > ENCODE_MAX_SMEM:
        raise ValueError(f"wide_f32_encode: {cfg.pos_xyz_dim} / {cfg.pos_dir_dim} "
                         f"frequencies need {smem} bytes of shared memory per tile")
    m = xyz.shape[0]
    _check("xyz", xyz, F32, (m, cfg.xyz_dim))
    if enc is None:
        enc = torch.empty((m, packed.ep), dtype=F32, device=xyz.device)
    _check("enc", enc, F32, (m, packed.ep))
    if packed.dp:
        _check("dirs", dirs, F32, (m, 3))
        if dir_enc is None:
            dir_enc = torch.empty((m, packed.dp), dtype=F32, device=xyz.device)
        _check("dir_enc", dir_enc, F32, (m, packed.dp))
    else:
        dir_enc = None
    for name, t in (("enc", enc), ("dir_enc", dir_enc)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"wide_f32_encode: {name} is not 16-byte aligned")
    if m == 0:
        return enc, dir_enc
    lib = _library()
    ptrs = [xyz.data_ptr(), dirs.data_ptr() if packed.dp else 0, enc.data_ptr(),
            dir_enc.data_ptr() if packed.dp else 0]
    dims = [m, cfg.xyz_dim, cfg.pos_xyz_dim, cfg.pos_dir_dim, packed.ep, packed.dp,
            tile, smem]
    err = lib.wide_f32_encode_launch(_longs(ptrs), _ints(dims), _stream(xyz))
    wide_f32_encode.launches += 1
    _raise_if(lib, err, "wide_f32_encode")
    return enc, dir_enc


# -------------------------------------------------------------------- GEMM


def gemm_tiles(m: int, n: int) -> int:
    """Output tiles of the GEMM over (m, n)."""
    return -(-m // GEMM_TILE_M) * -(-n // GEMM_TILE_N)


def gemm_grid(m: int, n: int, resident: int) -> int:
    """CTAs of a persistent GEMM launch: one per output tile, at most as
    many as the card holds at once."""
    return max(1, min(gemm_tiles(m, n), resident))


def gemm_walk(m: int, n: int, grid: int) -> List[List[Tuple[int, int]]]:
    """(first point, first column) of the tiles each of `grid` CTAs computes,
    in order, mirroring the kernel: CTA b takes tiles t = b, b + grid, ...,
    tile t at point tile t // ntn and column tile t % ntn."""
    ntn = -(-n // GEMM_TILE_N)
    return [[(t // ntn * GEMM_TILE_M, t % ntn * GEMM_TILE_N)
             for t in range(b, gemm_tiles(m, n), grid)] for b in range(grid)]


def gemm_wlo_shape(n: int, w_cols: int) -> Tuple[int, int]:
    """(rows, row pitch) of the scratch for W's TF32 rests: W's first n
    rows, each padded to 16 bytes (TMA reads it)."""
    return n, _round_up(w_cols, 4)


def gemm_plan_ints() -> List[int]:
    """The plan the kernel checks: tile_m, tile_n, tile_k, stages, chain,
    smem."""
    return [GEMM_TILE_M, GEMM_TILE_N, GEMM_K, GEMM_STAGES, GEMM_CHAIN, GEMM_SMEM]


def check_gemm_operands(xs: Sequence[torch.Tensor], w: torch.Tensor, n: int, mode: int,
                        out: torch.Tensor, cols: Sequence[int],
                        bias: Optional[torch.Tensor] = None,
                        mask: Optional[torch.Tensor] = None,
                        g_heads: Optional[torch.Tensor] = None,
                        w_sigma: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError unless the GEMM kernel takes these operands: 1-3 f32
    segments (M, K_s) and W (>= n rows), each row-major with a 16-byte
    aligned base and row pitch (TMA reads them in boxes), each segment
    inside W's columns at a column that is a multiple of 4; a contiguous f32
    `out` (M, n); the epilogue's operands of `mode`; one device."""
    from mega_nerf_tpu_torch.render.fused_train_wide import (
        DX_F32,
        DX_MASK,
        DX_MASK_SIGMA,
        HEADS_GRAD_WIDTH,
    )

    if not 1 <= len(xs) <= WIDE_MAX_SEGMENTS or len(cols) != len(xs):
        raise ValueError(f"wide_f32_gemm: 1-{WIDE_MAX_SEGMENTS} segments, each with its "
                         f"column, got {len(xs)} and {len(cols)}")
    if not DX_F32 <= mode <= EPI_LAYER_RELU:
        raise ValueError(f"wide_f32_gemm: unknown epilogue {mode}")
    m = xs[0].shape[0]
    widths = [x.shape[1] for x in xs]
    if w.dtype != F32 or w.dim() != 2 or w.stride(1) != 1 or w.stride(0) % 4 \
            or w.data_ptr() % 16 or w.shape[0] < n:
        raise ValueError(f"wide_f32_gemm: w must be a row-major f32 matrix of at least "
                         f"{n} rows, 16-byte aligned, got {w.dtype} {tuple(w.shape)} "
                         f"strides {w.stride()}")
    for i, (x, c) in enumerate(zip(xs, cols)):
        if x.device != w.device:
            raise ValueError("wide_f32_gemm: segments and weights on different devices")
        _check_f32_rows(f"segment {i}", x, m, widths[i])
        if c % 4 or c < 0 or c + _round_up(widths[i], MMA_K) > w.shape[1]:
            raise ValueError(f"wide_f32_gemm: segment {i} ({widths[i]} wide at column "
                             f"{c}) is not inside the {w.shape[1]} columns of W")
    _check("out", out, F32, (m, n))
    if out.device != w.device:
        raise ValueError("wide_f32_gemm: out on another device than the weights")
    if mode >= EPI_LAYER:
        _check("bias", bias, F32, (n,))
    if mode in (DX_MASK, DX_MASK_SIGMA):
        _check("mask", mask, F32, (m, n))
    if mode == DX_MASK_SIGMA:
        _check("g_heads", g_heads, F32, (m, HEADS_GRAD_WIDTH))
        _check("w_sigma", w_sigma, F32, (n,))
    for t in (bias, mask, g_heads, w_sigma):
        if t is not None and t.device != w.device:
            raise ValueError("wide_f32_gemm: tensors on different devices")


def wide_f32_gemm(xs: Sequence[torch.Tensor], w: torch.Tensor, n: int, mode: int,
                  out: torch.Tensor, cols: Sequence[int],
                  bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  g_heads: Optional[torch.Tensor] = None,
                  w_sigma: Optional[torch.Tensor] = None,
                  grid: Optional[int] = None) -> torch.Tensor:
    """out (M, n) f32 = epilogue(sum_s X_s W[:n, cols_s : cols_s + K_s]^T) on
    CUDA tensors: xs 1-3 f32 segments (M, K_s), w a row-major f32 (>= n,
    ld) matrix (row c gives output column c), `cols` each segment's first
    column of W (`fused_wide.segment_columns`). Epilogues: EPI_LAYER /
    EPI_LAYER_RELU add `bias` (and the ReLU); fused_train_wide.DX_F32 and
    DX_NONE none; DX_MASK zeroes where `mask` (M, n) <= 0, DX_MASK_SIGMA
    adds g_heads[:, 0] w_sigma first. The kernel: W's TF32 rests into
    scratch (`gemm_wlo_shape`), then persistent CTAs (`gemm_grid`; `grid`,
    the tests' only, sets another count) over 128 x 128 output tiles,
    3xTF32 products on `wgmma` in a fixed order with no split over K, so
    launches repeat bit for bit."""
    from mega_nerf_tpu_torch.render.fused_train_wide import HEADS_GRAD_WIDTH

    check_gemm_operands(xs, w, n, mode, out, cols, bias, mask, g_heads, w_sigma)
    if w.device.type != "cuda":
        raise ValueError(f"wide_f32_gemm: a kernel of the card, got tensors on {w.device}")
    m = xs[0].shape[0]
    if m == 0 or n == 0:
        return out
    lib = _library()
    if grid is None:
        grid = gemm_grid(m, n, _resident_ctas(lib, w.device, GEMM_SMEM,
                                              "wide_f32_resident_ctas"))
    elif grid < 1:
        raise ValueError(f"wide_f32_gemm: grid {grid}")
    wlo = torch.empty(gemm_wlo_shape(n, w.shape[1]), dtype=F32, device=w.device)
    ptrs = [x.data_ptr() for x in xs] + [0] * (WIDE_MAX_SEGMENTS - len(xs))
    ptrs += [w.data_ptr(), *(0 if t is None else t.data_ptr()
                             for t in (bias, mask, g_heads, w_sigma)),
             out.data_ptr(), wlo.data_ptr()]
    dims = [m, n, len(xs), w.stride(0), n, mode, n, HEADS_GRAD_WIDTH]
    for i in range(WIDE_MAX_SEGMENTS):
        dims += [xs[i].shape[1], xs[i].stride(0), cols[i]] if i < len(xs) else [0, 0, 0]
    dims += [w.shape[1], wlo.shape[1]]
    err = lib.wide_f32_gemm_launch(_longs(ptrs), _ints(dims), _ints(gemm_plan_ints()), grid,
                                   _stream(w))
    wide_f32_gemm.launches += 1
    _raise_if(lib, err, "wide_f32_gemm")
    return out


def wide_f32_layer(xs: Sequence[torch.Tensor], w: torch.Tensor, b: torch.Tensor,
                   relu: bool, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(sum_s X_s W[:, col_s : col_s + K_s]^T + b) -> (M, N) f32, the
    GEMM's layer form: xs in `pack_params`' column order, w (N, Ktot) f32
    packed matrix, b (N,) f32; `out` (contiguous) is written when given."""
    if not _device_rule("wide_f32_layer", w):
        return eval_wide_layer_plain(xs, w, b, relu)
    n, ktot = w.shape
    cols = segment_columns([x.shape[1] for x in xs])
    if cols[-1] + _round_up(xs[-1].shape[1], MMA_K) != ktot:
        raise ValueError(f"wide_f32_layer: segments of widths {[x.shape[1] for x in xs]} "
                         f"do not fill the packed matrix's {ktot} columns")
    if out is None:
        out = torch.empty((xs[0].shape[0], n), dtype=F32, device=w.device)
    return wide_f32_gemm(xs, w, n, EPI_LAYER_RELU if relu else EPI_LAYER, out, cols,
                         bias=b)


def wide_f32_dx(g: torch.Tensor, wt: torch.Tensor, row0: int, k: int, mode: int,
                mask: Optional[torch.Tensor] = None,
                g_heads: Optional[torch.Tensor] = None,
                w_sigma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mode(g @ wt[row0:row0 + k]^T) -> (M, k) f32, the GEMM's backward-data
    form: g (M, N) f32 gradient rows; wt (Ktot, N) f32 transposed packed
    matrix (`fused_train.transposed_weights`); mask (M, k) f32 saved output
    for the mask modes; g_heads (M, HEADS_GRAD_WIDTH) f32 and w_sigma (k,)
    f32 for DX_MASK_SIGMA."""
    from mega_nerf_tpu_torch.render.fused_train_wide import DX_F32, train_wide_dx_plain

    if not _device_rule("wide_f32_dx", g):
        return train_wide_dx_plain(g, wt, row0, k, mode, mask, g_heads, w_sigma)
    n = g.shape[1]
    if not DX_F32 <= mode < EPI_LAYER:
        raise ValueError(f"wide_f32_dx: unknown mode {mode}")
    if wt.dim() != 2 or wt.shape[1] != n or not 0 <= row0 <= row0 + k <= wt.shape[0]:
        raise ValueError(f"wide_f32_dx: rows [{row0}, {row0 + k}) of a "
                         f"{tuple(wt.shape)} matrix against {n}-wide gradients")
    _check("wt", wt, F32, tuple(wt.shape))
    out = torch.empty((g.shape[0], k), dtype=F32, device=g.device)
    if k == 0:
        return out
    return wide_f32_gemm([g], wt[row0:row0 + k], k, mode, out, [0], mask=mask,
                         g_heads=g_heads, w_sigma=w_sigma)


# ------------------------------------------------------------------- heads


def wide_f32_heads_fwd(packed: PackedMLP, h: torch.Tensor, branch: Optional[torch.Tensor],
                       noise: Optional[torch.Tensor], train: bool = True,
                       out: Optional[torch.Tensor] = None):
    """The heads on CUDA tensors: from the last trunk output h (M, D) f32 and
    the branch (M, D / 2) f32 (None without it; h feeds the rgb head) ->
    with `train`, ((M, 4) f32 [rgb, sigma], (M, 4) f32 [rgb_pre, sigma_pre +
    noise]), noise (M,) f32 or None; without it the (M, 4) output alone
    (eval: no noise, no pre-activations), written into `out` when given."""
    from mega_nerf_tpu_torch.render.fused_train_wide import train_wide_heads_fwd_plain

    if not _device_rule("wide_f32_heads_fwd", h):
        res, pre = train_wide_heads_fwd_plain(packed, h, branch, noise)
        return (res, pre) if train else res
    m, d = h.shape[0], packed.config.layer_dim
    _check_weights("wide_f32_heads_fwd", packed, h.device)
    _check("h", h, F32, (m, d))
    if packed.has_branch:
        _check("branch", branch, F32, (m, d // 2))
    if noise is not None:
        if not train:
            raise ValueError("wide_f32_heads_fwd: eval takes no sigma noise")
        _check("noise", noise, F32, (m,))
    if out is None:
        out = torch.empty((m, 4), dtype=F32, device=h.device)
    _check("out", out, F32, (m, 4))
    pre = torch.empty((m, 4), dtype=F32, device=h.device) if train else None
    if m > 0:
        lib = _library()
        ptrs = [h.data_ptr(), branch.data_ptr() if packed.has_branch else 0,
                0 if noise is None else noise.data_ptr(), packed.sigma_w.data_ptr(),
                packed.sigma_b.data_ptr(), packed.rgb_w.data_ptr(), packed.rgb_b.data_ptr(),
                out.data_ptr(), pre.data_ptr() if train else 0]
        dims = [m, d, d // 2 if packed.has_branch else d,
                int(packed.config.shifted_softplus)]
        err = lib.wide_f32_heads_fwd_launch(_longs(ptrs), _ints(dims), _stream(h))
        wide_f32_heads_fwd.launches += 1
        _raise_if(lib, err, "wide_f32_heads_fwd")
    return (out, pre) if train else out


def wide_f32_heads_bwd(packed: PackedMLP, g: torch.Tensor, pre: torch.Tensor,
                       h: torch.Tensor, branch: Optional[torch.Tensor]):
    """-> (heads-gradient rows (M, HEADS_GRAD_WIDTH) f32: g_sigma at 0, g_rgb
    at HEADS_RGB_COL, d_pre f32: of the branch (M, D / 2), or of the last
    trunk layer (M, D) without it) from the cotangent g (M, 4) f32 and the
    forward's pre-activations."""
    from mega_nerf_tpu_torch.render.fused_train_wide import (
        HEADS_GRAD_WIDTH,
        HEADS_RGB_COL,
        train_wide_heads_bwd_plain,
    )

    if not _device_rule("wide_f32_heads_bwd", g):
        return train_wide_heads_bwd_plain(packed, g, pre, h, branch)
    m, d = g.shape[0], packed.config.layer_dim
    _check_weights("wide_f32_heads_bwd", packed, g.device)
    _check("g", g, F32, (m, 4))
    _check("pre", pre, F32, (m, 4))
    _check("h", h, F32, (m, d))
    if packed.has_branch:
        _check("branch", branch, F32, (m, d // 2))
    width = d // 2 if packed.has_branch else d
    rows = torch.empty((m, HEADS_GRAD_WIDTH), dtype=F32, device=g.device)
    d_pre = torch.empty((m, width), dtype=F32, device=g.device)
    if m == 0:
        return rows, d_pre
    lib = _library()
    ptrs = [g.data_ptr(), pre.data_ptr(),
            branch.data_ptr() if packed.has_branch else h.data_ptr(),
            packed.sigma_w.data_ptr(), packed.rgb_w.data_ptr(), rows.data_ptr(),
            d_pre.data_ptr()]
    dims = [m, width, int(packed.has_branch), int(packed.config.shifted_softplus),
            HEADS_GRAD_WIDTH, HEADS_RGB_COL]
    err = lib.wide_f32_heads_bwd_launch(_longs(ptrs), _ints(dims), _stream(g))
    wide_f32_heads_bwd.launches += 1
    _raise_if(lib, err, "wide_f32_heads_bwd")
    return rows, d_pre


# ------------------------------------------------------------ weight gradient


def wide_f32_dw(jobs, tensors: Dict[str, torch.Tensor], out: torch.Tensor) -> torch.Tensor:
    """One dW step of `fused_train_wide.train_wide_plan` (its `DwJob`s) on
    the f32 tensors it names: each job's dW and db into the flat f32 buffer
    `out`, one launch of the f32 weight-gradient kernel pair (split sums
    added in a fixed order: two launches give the same bits)."""
    from mega_nerf_tpu_torch.render.fused_train_wide import train_wide_dw_plain

    if not _device_rule("wide_f32_dw", out):
        return train_wide_dw_plain(jobs, tensors, out)
    return weight_grad_f32_jobs(
        [WgJob(tensors[j.d], tensors[j.x], j.d_col, j.n, 0, j.k, j.out_off, j.out_stride,
               j.bias_off) for j in jobs], out)


for _fn in (wide_f32_encode, wide_f32_gemm, wide_f32_heads_fwd, wide_f32_heads_bwd):
    _fn.launches = 0

WIDE_F32_KERNELS = ("wide_f32_encode", "wide_f32_gemm", "wide_f32_heads_fwd",
                    "wide_f32_heads_bwd")


def wide_f32_kernel_launches() -> int:
    """Launches of the four kernels of `csrc/wide_f32.cu`."""
    return (wide_f32_encode.launches + wide_f32_gemm.launches
            + wide_f32_heads_fwd.launches + wide_f32_heads_bwd.launches)


__all__ = [
    "wide_f32_encode", "wide_f32_gemm", "wide_f32_layer", "wide_f32_dx",
    "wide_f32_heads_fwd", "wide_f32_heads_bwd", "wide_f32_dw", "EPI_LAYER",
    "EPI_LAYER_RELU", "GEMM_TILE_M", "GEMM_TILE_N", "GEMM_K", "GEMM_STAGES",
    "GEMM_SMEM", "GEMM_CHAIN", "gemm_tiles", "gemm_grid", "gemm_walk", "gemm_wlo_shape",
    "gemm_plan_ints", "check_gemm_operands", "WIDE_F32_KERNELS",
    "wide_f32_kernel_launches",
]
