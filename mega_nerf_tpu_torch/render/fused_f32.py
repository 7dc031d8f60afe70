"""The f32-compute kernels of the fused MLP (`--compute_dtype float32`) to
layer width 512: plans and wrappers.

Counterparts of the JAX package's Pallas kernels in f32 compute
(`render/pallas_mlp.py::_mlp_kernel`, `render/pallas_train.py::
_train_fwd_kernel` and `::_train_bwd_kernel`, which run f32 to width 1024).
The hand-written Hopper kernels compute in f32: f32 operands and f32 sums,
every layer product as 3xTF32 split products on the tensor cores (each
operand x = hi + lo, lo the rest of x past its TF32 part, read as TF32;
hi*hi + hi*lo + lo*hi summed in f32), within ~2^-21 of each f32 product.
No single-pass TF32 and no bf16 product, so an f32 run gets the numbers of
the port's f32 eager module and of the JAX package's f32 kernels, to
summation order and ~2^-21.

- `csrc/eval_f32.cu` (`fused_nerf_eval_f32`): the eval forward.
- `csrc/train_f32.cu`: the training forward (`fused_nerf_train_fwd_f32`,
  the eval forward plus sigma noise, writing the f32 saved rows of
  `fused_train.act_layout`), backward-data (`train_bwd_data_f32`: f32
  gradient rows of `fused_train.grad_layout` and d_app) and the weight
  gradient (`weight_grad_f32`: dW and bias sums per job of
  `fused_train.weight_grad_jobs` on `mma.sync` through a `cp.async` ring,
  fixed-order split sums, no float atomics).
- Both forwards run one device path, `csrc/f32_forward.cuh` (`wgmma` over
  a TMA ring of W boxes read from the packed (N, Ktot) matrices beside the
  same boxes of W's TF32 rests, `w_rests`), so the eval kernel equals the
  training forward without noise bit for bit. The backward-data kernel
  runs its products through the same layer code, B the transposed (Ktot,
  N) matrices of `fused_train.transposed_weights` beside their rests
  (`t_rests`): TF32 `wgmma` takes B only K-major, and the backward reduces
  over N.

`fused_mlp.fused_nerf_eval` and the wrappers of `fused_train.py` call these
on CUDA tensors when the packed weights are f32; CPU tensors run the plain
versions there, for either dtype. Each wrapper here counts its launches in
`.launches` (apart from the bf16 kernels' counts); a failed build or
launch raises, nothing falls back.

`f32_fwd_plan(cfg)` and `f32_bwd_plan(cfg)` give a CTA's tile, its ring's
stages and shared memory (the kernels take them as launch arguments);
`f32_wg_plan(packed, m)` the weight gradient's output tiles and point
ranges, `f32_wg_job_rows` its job table with each operand's copy width
(`f32_wg_copy`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Tuple

import torch

from mega_nerf_tpu_torch.models.nerf import NeRFConfig
from mega_nerf_tpu_torch.render.fused_mlp import (
    MMA_K,
    PackedMLP,
    _raise_if,
    _round_up,
    is_wide,
    launch_tables,
    skip_mask,
    supports_fused_kernel,
)

F32_SMEM_LIMIT = 232_448  # shared memory one CTA may use on an H100
# The forward and backward-data kernels (f32_forward.cuh): 64 points a CTA
# written in place to width 256, 32 (the wgmma rows 32-63 zero) with two
# activation or gradient tiles past it; a ring stage = a B box of 128 rows
# x 32 columns and the same box of its TF32 rests (`w_rests`, `t_rests`).
F32_FWD_INPLACE_WIDTH = 256
F32_FWD_BOX = 128 * 32 * 4
F32_FWD_STAGE = 2 * F32_FWD_BOX
F32_FWD_STAGES = (4, 3, 2)  # the most that fit
F32_FWD_ALIGN = 1024  # the 128-byte swizzle's period; the ring's alignment
F32_WG_TILE = 128  # weight-gradient output tile: 128 (n) x 128 (k) (WG_T)
F32_WG_CHUNK = 64  # points of one stage of the weight gradient's ring (WG_P)
F32_WG_ELEMS = F32_WG_TILE * F32_WG_TILE + F32_WG_TILE
F32_WG_CTAS = 1024  # split the points until about this many CTAs
F32_WG_MIN_SPLIT = 2048  # points a split at least
WG_COPY_D16, WG_COPY_X16 = 1, 2  # the job's d / x rows by 16-byte copies (train_f32.cu)
_WIDE_WHY = "layer_dim past 512 (the f32 kernels take widths to 512)"


class F32Plan(NamedTuple):
    """The CTA of the f32 forward or backward-data kernel (f32_forward.cuh's
    ring and layer code): a tile of `tm` points, a ring of `stages`, byte
    `offsets` from a 1024-aligned base (the forward's ring, x, y, enc, dir,
    app, sig, bar; the backward's ring, x, y, heads, bar; x == y: each layer
    written in place) and `smem_bytes` in all (with the alignment's
    slack)."""
    tm: int
    stages: int
    offsets: Dict[str, int]
    smem_bytes: int


def _tiles(cfg: NeRFConfig, tm: int, stages: int) -> Tuple[Dict[str, int], int]:
    """The ring, then the x and y tiles of `layer_dim + 4` floats a point (x
    == y to F32_FWD_INPLACE_WIDTH)."""
    act = 4 * tm * (cfg.layer_dim + 4)
    o = {"ring": 0, "x": stages * F32_FWD_STAGE}
    o["y"] = o["x"] + (0 if cfg.layer_dim <= F32_FWD_INPLACE_WIDTH else act)
    return o, o["y"] + act


def _fwd_layout(cfg: NeRFConfig, tm: int, stages: int) -> Tuple[Dict[str, int], int]:
    ep = _round_up(cfg.enc_in, MMA_K)
    dp = _round_up(cfg.dir_in, MMA_K)
    ap = _round_up(cfg.appearance_dim, MMA_K)
    row = lambda width: 4 * tm * (width + 4) if width else 0  # noqa: E731
    o, end = _tiles(cfg, tm, stages)
    # dir_a's direction and appearance tiles take the encode's room once
    # the trunk is done with it.
    o["enc"] = o["dir"] = end
    o["app"] = o["dir"] + row(dp)
    o["sig"] = o["enc"] + _round_up(max(row(ep), row(dp) + row(ap)), 16)
    o["bar"] = o["sig"] + _round_up(4 * tm, 16)
    return o, o["bar"] + 2 * 8 * stages + F32_FWD_ALIGN


def _bwd_layout(cfg: NeRFConfig, tm: int, stages: int) -> Tuple[Dict[str, int], int]:
    o, end = _tiles(cfg, tm, stages)
    o["heads"] = end  # g_sigma, g_rgb a point
    o["bar"] = o["heads"] + 16 * tm
    return o, o["bar"] + 2 * 8 * stages + F32_FWD_ALIGN


def _ring_plan(cfg: NeRFConfig, kind: str, layout) -> F32Plan:
    ok, why = supports_fused_kernel(cfg, train=True)
    if not ok or is_wide(cfg):
        raise NotImplementedError(f"fused kernel does not cover: {why or _WIDE_WHY}")
    tm = 64 if cfg.layer_dim <= F32_FWD_INPLACE_WIDTH else 32
    for stages in F32_FWD_STAGES:
        offsets, total = layout(cfg, tm, stages)
        if total <= F32_SMEM_LIMIT:
            return F32Plan(tm, stages, offsets, total)
    raise ValueError(f"f32 {kind}: no ring fits {F32_SMEM_LIMIT} B of shared memory "
                     f"for {cfg}")


@functools.lru_cache(maxsize=None)
def f32_fwd_plan(cfg: NeRFConfig) -> F32Plan:
    """The f32 forward's CTA (eval and training forward): 64 points with
    each layer written in place to width 256, 32 with two activation tiles
    past it; the deepest ring of F32_FWD_STAGES that fits. Raises
    NotImplementedError where the kernels do not cover the architecture,
    ValueError where no ring fits."""
    return _ring_plan(cfg, "forward", _fwd_layout)


@functools.lru_cache(maxsize=None)
def f32_bwd_plan(cfg: NeRFConfig) -> F32Plan:
    """The f32 backward-data kernel's CTA: the forward's tiles (64 points,
    one gradient tile written in place, to width 256; 32 points with two
    past it), the heads' four derivatives a point, the deepest ring of
    F32_FWD_STAGES that fits. The branch rows and d_a live in the gradient
    tile: no tile of their own."""
    return _ring_plan(cfg, "backward", _bwd_layout)


class F32WgPlan(NamedTuple):
    """The f32 weight gradient's work: `jobs` (fused_train.weight_grad_jobs),
    `tiles` (job, n0, k0) of F32_WG_TILE x F32_WG_TILE outputs, each summed
    over `splits` point ranges of `split_len` (a multiple of F32_WG_CHUNK;
    the last ends at M), the partials added in range order."""
    jobs: List[Tuple[int, ...]]
    tiles: List[Tuple[int, int, int]]
    splits: int
    split_len: int


def f32_wg_tiles(sizes) -> List[Tuple[int, int, int]]:
    """(job, n0, k0) of every F32_WG_TILE x F32_WG_TILE output tile of jobs
    of `sizes` (n, k)."""
    return [(j, n0, k0) for j, (n, k) in enumerate(sizes)
            for n0 in range(0, n, F32_WG_TILE) for k0 in range(0, k, F32_WG_TILE)]


def f32_wg_split(ntiles: int, m: int) -> Tuple[int, int]:
    """(splits, split_len) of m points over `ntiles` tiles: about
    F32_WG_CTAS CTAs, at least F32_WG_MIN_SPLIT points a range, ranges of
    whole F32_WG_CHUNK chunks (the last may end early). It depends on the
    tiles and m only, so two launches sum alike."""
    splits = max(1, min(-(-F32_WG_CTAS // ntiles), -(-m // F32_WG_MIN_SPLIT)))
    split_len = _round_up(max(-(-m // splits), 1), F32_WG_CHUNK)
    return max(1, -(-m // split_len)), split_len


def f32_wg_copy(ptr: int, ld: int, col: int) -> int:
    """Bytes of each cp.async with which the weight gradient's ring reads an
    f32 operand whose rows start at byte address `ptr` and lie `ld` floats
    apart, from column `col` on: 16 where every row's first column sits on
    16 B, else 4. Raises ValueError where not even 4 B hold. (Tiles start
    at multiples of F32_WG_TILE columns, so the job's column decides.)"""
    if ptr % 4:
        raise ValueError(f"weight_grad_f32: an f32 operand at byte address {ptr} is "
                         "not on 4 B")
    return 16 if ptr % 16 == 0 and ld % 4 == 0 and col % 4 == 0 else 4


def f32_wg_plan(packed: PackedMLP, m: int) -> F32WgPlan:
    """Tiles and point ranges of one launch of the narrow route over m
    points (`f32_wg_tiles`, `f32_wg_split`)."""
    from mega_nerf_tpu_torch.render.fused_train import weight_grad_jobs

    jobs = weight_grad_jobs(packed)
    tiles = f32_wg_tiles([(job[1], job[3]) for job in jobs])
    return F32WgPlan(jobs, tiles, *f32_wg_split(len(tiles), m))


# ------------------------------------------------------------ kernel wrappers


def _library(name: str, exports):
    from mega_nerf_tpu_torch.render._build import load_library

    lib = load_library(name)
    if not getattr(lib, "_f32_bound", False):
        for fn, nargs in exports:
            getattr(lib, fn).argtypes = [ctypes.c_void_p] * nargs
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string = getattr(lib, f"{name}_error_string")
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib._f32_bound = True
    return lib


def _eval_lib():
    return _library("eval_f32", [("eval_f32_launch", 6)])


def _train_lib():
    return _library("train_f32", [("train_f32_fwd_launch", 8),
                                  ("train_f32_bwd_launch", 6),
                                  ("weight_grad_f32_launch", 3)])


def _ints(values) -> ctypes.Array:
    values = list(values)
    return (ctypes.c_int * max(len(values), 1))(*values)


def _ptrs(values) -> ctypes.Array:
    values = list(values)
    return (ctypes.c_longlong * len(values))(*values)


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_packed(packed: PackedMLP) -> None:
    if packed.config.dtype != torch.float32:
        raise ValueError("the f32 kernels take float32 packed weights, got "
                         f"{packed.config.compute_dtype}")
    for w in packed.mats:
        if w.dtype != torch.float32:
            raise ValueError("the f32 kernels take float32 packed weights")


def tf32_rest(w: torch.Tensor) -> torch.Tensor:
    """w - (w with its low 13 bits cleared): what the tensor cores leave of
    an f32 operand read as TF32, exact in f32 (f32_forward.cuh's
    `tf32_rest`, the split's lo)."""
    return w - (w.view(torch.int32) & -8192).view(torch.float32)


def _cached(packed: PackedMLP, attr: str, make):
    """`make()` kept on `packed` under `attr`, keyed by each packed matrix's
    storage and version: made once per set of packed weights, so the
    launches of a chunk and the views of a run share it, and made anew
    after an in-place update of the weights (which bumps the version)."""
    key = [(w.data_ptr(), w._version, tuple(w.shape)) for w in packed.mats]
    cached = getattr(packed, attr, None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, make())
        setattr(packed, attr, cached)
    return cached[1]


def w_rests(packed: PackedMLP) -> List[torch.Tensor]:
    """The TF32 rests of the packed matrices (`tf32_rest`, (N, Ktot) each),
    which the f32 forward reads beside W (`_cached`)."""
    return _cached(packed, "_f32_rests",
                   lambda: [tf32_rest(w).contiguous() for w in packed.mats])


def t_rests(packed: PackedMLP) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(the transposed matrices, their TF32 rests): `fused_train.
    transposed_weights` ((Ktot, N) each, dir_a's columns padded to
    `branch_k`), which the f32 backward-data kernel reads as B (`_cached`)."""
    from mega_nerf_tpu_torch.render.fused_train import transposed_weights

    def make():
        wts = transposed_weights(packed)
        return wts, [tf32_rest(w).contiguous() for w in wts]

    return _cached(packed, "_f32_t_rests", make)


def _fwd_plan_ints(plan: F32Plan) -> List[int]:
    o = plan.offsets
    return [plan.tm, plan.stages, o["ring"], o["x"], o["y"], o["enc"], o["dir"], o["app"],
            o["sig"], o["bar"], plan.smem_bytes]


def fused_nerf_eval_f32(packed: PackedMLP, xyz, dirs, app) -> torch.Tensor:
    """The f32 eval kernel (`csrc/eval_f32.cu`) on CUDA tensors -> (M, 4)
    f32 [rgb, sigma]; inputs as `fused_mlp.fused_nerf_eval` checks them."""
    _check_packed(packed)
    plan = f32_fwd_plan(packed.config)
    m = xyz.shape[0]
    out = torch.empty((m, 4), dtype=torch.float32, device=xyz.device)
    if m == 0:
        return out
    lib = _eval_lib()
    c_ptrs, c_dims = launch_tables(packed, xyz, dirs, app, out)
    shapes = [v for w in packed.mats for v in w.shape]
    rests = _ptrs(w.data_ptr() for w in w_rests(packed))
    err = lib.eval_f32_launch(c_ptrs, c_dims, _ints(_fwd_plan_ints(plan)),
                              _ints(shapes), rests, _stream(xyz))
    fused_nerf_eval_f32.launches += 1
    _raise_if(lib, err, "fused_nerf_eval_f32")
    return out


fused_nerf_eval_f32.launches = 0


def fused_nerf_train_fwd_f32(packed: PackedMLP, xyz, dirs, app, noise):
    """The f32 training forward (`csrc/train_f32.cu`) on CUDA tensors ->
    ((M, 4) f32, saved rows (M, act width) f32)."""
    from mega_nerf_tpu_torch.render.fused_train import act_layout

    _check_packed(packed)
    plan = f32_fwd_plan(packed.config)
    lay = act_layout(packed)
    m = xyz.shape[0]
    out = torch.empty((m, 4), dtype=torch.float32, device=xyz.device)
    act = torch.empty((m, lay["width"]), dtype=torch.float32, device=xyz.device)
    if m == 0:
        return out, act
    lib = _train_lib()
    c_ptrs, c_dims = launch_tables(packed, xyz, dirs, app, out)
    shapes = [v for w in packed.mats for v in w.shape]
    rests = _ptrs(w.data_ptr() for w in w_rests(packed))
    extra = [0 if noise is None else noise.data_ptr(), act.data_ptr()]
    cols = [lay["width"], lay["final"], lay["dir"], lay["app"], lay["branch"]]
    err = lib.train_f32_fwd_launch(c_ptrs, c_dims, _ints(_fwd_plan_ints(plan)),
                                   _ints(shapes), rests, _ptrs(extra), _ints(cols),
                                   _stream(xyz))
    fused_nerf_train_fwd_f32.launches += 1
    _raise_if(lib, err, "fused_nerf_train_fwd_f32")
    return out, act


fused_nerf_train_fwd_f32.launches = 0


def _bwd_plan_ints(plan: F32Plan) -> List[int]:
    o = plan.offsets
    return [plan.tm, plan.stages, o["ring"], o["x"], o["y"], o["heads"], o["bar"],
            plan.smem_bytes]


def train_bwd_data_f32(packed: PackedMLP, act, g, noise):
    """The f32 backward-data kernel (`csrc/train_f32.cu`) on CUDA tensors ->
    (gradient rows (M, grad width) f32, d_app (M, appearance_dim) f32 or
    None); inputs as `fused_train.train_bwd_data` checks them."""
    from mega_nerf_tpu_torch.render.fused_train import act_layout, branch_k, grad_layout

    _check_packed(packed)
    cfg = packed.config
    plan = f32_bwd_plan(cfg)
    al, gl = act_layout(packed), grad_layout(packed)
    m = act.shape[0]
    grad = torch.empty((m, gl["width"]), dtype=torch.float32, device=act.device)
    d_app = None
    if packed.ap:
        d_app = torch.empty((m, cfg.appearance_dim), dtype=torch.float32,
                            device=act.device)
    if m == 0:
        return grad, d_app
    lib = _train_lib()
    wts, rests = t_rests(packed)
    ptrs = [act.data_ptr(), grad.data_ptr(), g.data_ptr(),
            0 if noise is None else noise.data_ptr(),
            0 if d_app is None else d_app.data_ptr(),
            packed.sigma_w.data_ptr(), packed.sigma_b.data_ptr(),
            packed.rgb_w.data_ptr(), packed.rgb_b.data_ptr()]
    ptrs += [w.data_ptr() for w in wts]
    dims = [m, cfg.layer_dim, cfg.layers, int(packed.has_branch),
            int(cfg.shifted_softplus), cfg.appearance_dim, skip_mask(cfg), packed.ep,
            packed.dp, branch_k(cfg), al["width"], gl["width"], al["h0"],
            al["branch"] if packed.has_branch else 0,
            gl["dfinal"] if packed.has_branch else 0,
            gl["da"] if packed.has_branch else 0, gl["heads"]]
    shapes = [v for w in wts for v in w.shape]
    err = lib.train_f32_bwd_launch(_ptrs(ptrs), _ints(dims), _ints(_bwd_plan_ints(plan)),
                                   _ints(shapes), _ptrs(w.data_ptr() for w in rests),
                                   _stream(act))
    train_bwd_data_f32.launches += 1
    _raise_if(lib, err, "train_bwd_data_f32")
    return grad, d_app


train_bwd_data_f32.launches = 0


class WgJob(NamedTuple):
    """One product of the f32 weight gradient (train_f32.cu WG_JOB): dW[r][c]
    (at out_off + r * stride + c of the flat buffer) = sum_p d[p][d_col + r]
    x[p][x_col + c] for r < n, c < k, and db[r] (at bias_off, when >= 0) =
    sum_p d[p][d_col + r]; d and x are (M, width) f32 row-major views."""
    d: torch.Tensor
    x: torch.Tensor
    d_col: int
    n: int
    x_col: int
    k: int
    out_off: int
    stride: int
    bias_off: int


def f32_wg_job_rows(jobs: List[WgJob]) -> List[Tuple[int, ...]]:
    """The kernel's job table (train_f32.cu WG_JOB a row): d, x, d_ld, x_ld,
    d_col, n, x_col, k, out_off, stride, bias_off and the copy flags
    (WG_COPY_D16 | WG_COPY_X16 where `f32_wg_copy` gives 16 B)."""
    rows = []
    for j in jobs:
        d16 = f32_wg_copy(j.d.data_ptr(), j.d.stride(0), j.d_col) == 16
        x16 = f32_wg_copy(j.x.data_ptr(), j.x.stride(0), j.x_col) == 16
        rows.append((j.d.data_ptr(), j.x.data_ptr(), j.d.stride(0), j.x.stride(0), j.d_col,
                     j.n, j.x_col, j.k, j.out_off, j.stride, j.bias_off,
                     WG_COPY_D16 * d16 + WG_COPY_X16 * x16))
    return rows


def weight_grad_f32_jobs(jobs: List[WgJob], out: torch.Tensor) -> torch.Tensor:
    """The f32 weight-gradient kernel pair (`csrc/train_f32.cu`: 3xTF32 on
    `mma.sync`, then the fixed-order reduce) over `jobs`, one launch, on
    CUDA tensors: writes each job's dW and db into the flat f32 buffer
    `out`; counts in `weight_grad_f32.launches`. The narrow route
    (`weight_grad_f32`) and the wide f32 route (`fused_wide_f32.wide_f32_dw`)
    both launch it."""
    m = jobs[0].d.shape[0]
    for j in jobs:
        for name, t, col, width in (("d", j.d, j.d_col, j.n), ("x", j.x, j.x_col, j.k)):
            if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != m
                    or t.stride(1) != 1 or t.device != out.device
                    or col < 0 or col + width > t.shape[1]):
                raise ValueError(f"weight_grad_f32: job operand {name} must be an "
                                 f"(M, >= {col + width}) f32 row-major view on the "
                                 f"buffer's device, got {t.dtype} {tuple(t.shape)} "
                                 f"strides {t.stride()}")
        end = max(j.out_off + (j.n - 1) * j.stride + j.k, j.bias_off + j.n)
        if min(j.n, j.k) <= 0 or j.k > j.stride or end > out.numel():
            raise ValueError(f"weight_grad_f32: a job writes outside the buffer ({j.n} x "
                             f"{j.k} at {j.out_off}, stride {j.stride})")
    if out.dtype != torch.float32 or out.dim() != 1 or not out.is_contiguous():
        raise ValueError("weight_grad_f32: out must be a contiguous flat f32 buffer")
    if m == 0:
        for j in jobs:
            out[j.out_off:j.out_off + j.n * j.stride].view(j.n, j.stride)[:, :j.k] = 0
            if j.bias_off >= 0:
                out[j.bias_off:j.bias_off + j.n] = 0
        return out
    lib = _train_lib()
    tiles = f32_wg_tiles([(j.n, j.k) for j in jobs])
    splits, split_len = f32_wg_split(len(tiles), m)
    rows = [v for row in f32_wg_job_rows(jobs) for v in row]
    table = torch.tensor(rows + [v for t in tiles for v in t],
                         dtype=torch.int64).to(out.device)
    scratch = torch.empty(splits * len(tiles) * F32_WG_ELEMS, dtype=torch.float32,
                          device=out.device)
    ptrs = [out.data_ptr(), scratch.data_ptr(), table.data_ptr()]
    dims = [m, len(jobs), len(tiles), splits, split_len]
    err = lib.weight_grad_f32_launch(_ptrs(ptrs), _ints(dims), _stream(out))
    weight_grad_f32.launches += 1
    _raise_if(lib, err, "weight_grad_f32")
    return out


def weight_grad_f32(packed: PackedMLP, act, grad) -> torch.Tensor:
    """The f32 weight-gradient kernel (`csrc/train_f32.cu`) on CUDA tensors
    -> flat f32 gradients in `fused_train.packed_shapes` order: the jobs of
    `fused_train.weight_grad_jobs`, each reading the gradient rows and the
    saved rows."""
    from mega_nerf_tpu_torch.render.fused_train import (
        _offsets,
        act_layout,
        grad_layout,
        packed_shapes,
    )

    _check_packed(packed)
    if act.shape[1] != act_layout(packed)["width"] or \
            grad.shape[1] != grad_layout(packed)["width"]:
        raise ValueError("weight_grad_f32: act and grad must be the saved and "
                         "gradient rows of this model (act_layout, grad_layout)")
    out = torch.empty(_offsets(packed_shapes(packed))[-1], dtype=torch.float32,
                      device=act.device)
    jobs = [WgJob(grad, act, *job) for job in f32_wg_plan(packed, 1).jobs]
    return weight_grad_f32_jobs(jobs, out)


weight_grad_f32.launches = 0


F32_KERNELS = (fused_nerf_eval_f32, fused_nerf_train_fwd_f32, train_bwd_data_f32,
               weight_grad_f32)

__all__ = [
    "F32Plan", "F32WgPlan", "f32_fwd_plan", "f32_bwd_plan", "f32_wg_plan",
    "f32_wg_tiles", "f32_wg_split", "f32_wg_copy", "f32_wg_job_rows", "WgJob",
    "weight_grad_f32_jobs", "tf32_rest", "w_rests", "t_rests",
    "fused_nerf_eval_f32", "fused_nerf_train_fwd_f32", "train_bwd_data_f32",
    "weight_grad_f32", "F32_KERNELS",
]
