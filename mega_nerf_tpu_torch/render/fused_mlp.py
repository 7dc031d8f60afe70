"""Fused NeRF eval MLP: packing, the plain PyTorch version, the kernel wrapper.

Counterpart of the JAX package's `render/pallas_mlp.py`. The hand-written
Hopper kernel is `csrc/eval_fwd.cu` (it replaces
`mega_nerf_tpu/render/pallas_mlp.py::_mlp_kernel` to width 512 in bf16
compute): the training forward's `wgmma` layer chain without noise or
saved rows, one persistent CTA per SM walking the point tiles, its tile and
shared memory from `fused_train.py::train_fwd_plan`. In f32 compute to
width 512 the wrapper launches `csrc/eval_f32.cu` instead (`fused_f32.py`:
f32 sums, 3xTF32 split products on the tensor cores). Past width 512 eval runs the wide route,
`fused_wide.py` (one layer GEMM at a time: `csrc/eval_wide.cu` in bf16
compute, `csrc/wide_f32.cu` in f32 through `fused_wide_f32.py`), on the
same packed weights; training past 512 runs `fused_train_wide.py` on that
GEMM and the kernels of `csrc/train_wide.cu` (in f32 those of
`csrc/wide_f32.cu` and the f32 weight gradient of `csrc/train_f32.cu`).

- `supports_fused_kernel(cfg, train)` is the gate, as the JAX package's
  `supports_fused_kernels(cfg, train)`; `is_wide(cfg)` says whether an
  admitted architecture takes the wide route.

- `pack_params` lays a `NeRF` module's weights out for the kernel: one
  (out, in) matrix per matmul layer in the compute dtype, with zero columns
  padding each input segment to a multiple of 16 (the MMA depth), and f32
  biases. The 128-lane padding of the TPU layout is gone.
- `fused_nerf_eval_plain` repeats the kernel's arithmetic in PyTorch: the
  same encode form (cos as sin(x 2^k + pi/2)), operands rounded to the
  compute dtype, float32 accumulation and bias, rounding after each layer.
- `fused_nerf_eval` is the wrapper: on a CPU tensor it runs the plain
  version; on a CUDA tensor it launches the kernel of the compute dtype
  (bf16: `eval_fwd.cu`, f32: `fused_f32.fused_nerf_eval_f32`) or raises.
  Each counts
  its calls in a `launches` / `calls` attribute. `eval_plan` checks the
  packed weights against the plan; `eval_grid` says how many CTAs a launch
  has (CTA b walks tiles b, b + grid, ...).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mega_nerf_tpu_torch.models.nerf import NeRF, NeRFConfig

MMA_K = 16  # input segments pad to the wgmma depth (16 bf16)
# The widest layer whose tiles fit one CTA's shared memory in
# fused_train.py::train_fwd_plan (64 points, output columns split in two):
# the fused chain of eval_fwd.cu and the three training kernels.
MAX_LAYER_DIM = 512
# The wide eval route (fused_wide.py): the JAX eval gate's bf16 limit; the
# wide training route (fused_train_wide.py) and every route in another
# compute dtype than bf16: the JAX gate's limit for those.
WIDE_MAX_LAYER_DIM = 2048
WIDE_MAX_TRAIN_LAYER_DIM = 1024
WIDE_LAYER_MULTIPLE = 64
MAX_MATRICES = 16  # trunk layers + trunk_final + dir_a (the kernel's table)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _architecture_ok(cfg: NeRFConfig) -> Tuple[bool, str]:
    """The conditions every fused route shares, and `pack_params` needs."""
    if cfg.rgb_dim != 3:
        return False, "SH output head"
    if cfg.affine_appearance:
        return False, "affine appearance"
    if cfg.layer_dim % 16:
        return False, f"layer_dim {cfg.layer_dim} (needs a multiple of 16)"
    if 0 in cfg.skip_layers:
        return False, "skip connection at layer 0"
    if cfg.layers + 2 > MAX_MATRICES:
        return False, f"{cfg.layers} layers"
    return True, ""


def supports_fused_kernel(cfg: NeRFConfig, train: bool = False) -> Tuple[bool, str]:
    """Whether the fused kernels cover this architecture -> (ok, why); the
    port's counterpart of `pallas_mlp.py::supports_fused_kernels(cfg, train)`.

    - Every route: the rgb head, no affine appearance, no skip at layer 0,
      at most MAX_MATRICES - 2 layers, layer_dim a multiple of 16.
    - Eval: the fused chain (`eval_fwd.cu`) to width 512; past it the wide
      route (`fused_wide.py`) to 2048 in bf16 compute, with layer_dim a
      multiple of 64 (every hidden operand fills whole 64-column TMA boxes;
      every width in `configs/` does). The JAX gate asks a multiple of
      128 only for the TPU's lanes; at every multiple of 128 the two agree.
      Past 2048 the eager module runs, as JAX falls back to XLA.
    - Train: the three fused training kernels to width 512; past it the
      wide training route (`fused_train_wide.py`) to 1024, with layer_dim
      a multiple of 64, as the JAX gate trains through Pallas to 1024.
      Past 1024 the eager module trains, as JAX falls back to XLA.
    - f32 compute: to width 512 the f32 kernels (`fused_f32.py`, f32 sums
      of 3xTF32 split products) take eval and training; past it the wide route's f32
      kernels (`fused_wide_f32.py`) to 1024, eval and training alike, as
      the JAX gate keeps f32 (every compute dtype but bf16) at 1024 in
      eval: its resident f32 weights of a 2048-wide model would not fit.
      Past 1024 the eager module runs, as JAX falls back to XLA."""
    ok, why = _architecture_ok(cfg)
    if not ok or cfg.layer_dim <= MAX_LAYER_DIM:
        return ok, why
    d = cfg.layer_dim
    wide_eval = not train and cfg.dtype == torch.bfloat16
    limit = WIDE_MAX_LAYER_DIM if wide_eval else WIDE_MAX_TRAIN_LAYER_DIM
    if d > limit or d % WIDE_LAYER_MULTIPLE:
        route = ("eval" if not train else "training") + \
            ("" if cfg.dtype == torch.bfloat16 else f" ({cfg.compute_dtype})")
        return False, (f"layer_dim {d} (the wide {route} route needs a multiple of "
                       f"{WIDE_LAYER_MULTIPLE} <= {limit})")
    return True, ""


def is_wide(cfg: NeRFConfig) -> bool:
    """Whether an architecture the gate admits takes the wide route (eval:
    `fused_wide.py`, training: `fused_train_wide.py`)."""
    return cfg.layer_dim > MAX_LAYER_DIM


@dataclasses.dataclass
class PackedMLP:
    """Kernel-layout weights + static layout facts."""

    config: NeRFConfig
    ep: int  # padded position-encoding width
    dp: int  # padded direction-encoding width (0 without dirs)
    ap: int  # padded appearance width (0 without appearance)
    mats: List[torch.Tensor]  # (N, Ktot) per matmul layer, compute dtype
    biases: List[torch.Tensor]  # (N,) f32
    sigma_w: torch.Tensor  # (D,)
    sigma_b: torch.Tensor  # (1,) f32
    rgb_w: torch.Tensor  # (3, rgb_in)
    rgb_b: torch.Tensor  # (3,) f32

    @property
    def has_branch(self) -> bool:
        return self.config.uses_dir_branch


# (weight name, bias name, column pieces [(src, dst, n)]) per matmul layer:
# columns src .. src+n of the module's weight land at dst .. dst+n of the
# packed matrix, whose width is the last piece's end rounded up to 16.
MatLayout = List[Tuple[str, str, List[Tuple[int, int, int]]]]


def mat_layout(cfg: NeRFConfig) -> MatLayout:
    """Where each module weight sits in the kernel's packed matrices."""
    d = cfg.layer_dim
    ep = _round_up(cfg.enc_in, MMA_K)
    dp = _round_up(cfg.dir_in, MMA_K)
    out: MatLayout = []
    for i in range(cfg.layers):
        if i == 0:
            pieces = [(0, 0, cfg.enc_in)]
        elif i in cfg.skip_layers:
            pieces = [(0, 0, cfg.enc_in), (cfg.enc_in, ep, d)]
        else:
            pieces = [(0, 0, d)]
        out.append((f"xyz_encodings.{i}.0.weight", f"xyz_encodings.{i}.0.bias",
                    pieces))
    if cfg.uses_dir_branch:
        out.append(("xyz_encoding_final.weight", "xyz_encoding_final.bias",
                    [(0, 0, d)]))
        pieces = [(0, 0, d)]
        if cfg.dir_in:
            pieces.append((d, d, cfg.dir_in))
        if cfg.appearance_dim:
            pieces.append((d + cfg.dir_in, d + dp, cfg.appearance_dim))
        out.append(("dir_a_encoding.0.weight", "dir_a_encoding.0.bias", pieces))
    return out


def mlp_param_names(cfg: NeRFConfig) -> List[str]:
    """The module parameters the fused kernels read (all but the
    appearance table, whose rows the caller gathers)."""
    names = []
    for w, b, _ in mat_layout(cfg):
        names += [w, b]
    return names + ["sigma.weight", "sigma.bias", "rgb.weight", "rgb.bias"]


def pack_tensors(cfg: NeRFConfig, params: Dict[str, torch.Tensor]) -> PackedMLP:
    """Module parameters (by name) -> the kernel's layout, detached, on
    their device."""
    ok, why = _architecture_ok(cfg)
    if not ok:
        raise NotImplementedError(f"fused kernel does not cover: {why}")
    dt = cfg.dtype
    with torch.no_grad():
        mats, biases = [], []
        for wname, bname, pieces in mat_layout(cfg):
            w = params[wname].detach()
            width = _round_up(max(dst + n for _, dst, n in pieces), MMA_K)
            mat = w.new_zeros((w.shape[0], width), dtype=dt)
            for src, dst, n in pieces:
                mat[:, dst:dst + n] = w[:, src:src + n]
            mats.append(mat)
            biases.append(params[bname].detach().float().contiguous())
        return PackedMLP(
            config=cfg, ep=_round_up(cfg.enc_in, MMA_K),
            dp=_round_up(cfg.dir_in, MMA_K),
            ap=_round_up(cfg.appearance_dim, MMA_K),
            mats=mats, biases=biases,
            sigma_w=params["sigma.weight"].detach()[0].to(dt).contiguous(),
            sigma_b=params["sigma.bias"].detach().float().contiguous(),
            rgb_w=params["rgb.weight"].detach().to(dt).contiguous(),
            rgb_b=params["rgb.bias"].detach().float().contiguous(),
        )


def pack_params(module: NeRF) -> PackedMLP:
    """A `NeRF` module's weights -> the kernel's layout, on its device."""
    return pack_tensors(module.config, dict(module.named_parameters()))


def encode(x: torch.Tensor, num_freqs: int, width: int) -> torch.Tensor:
    """(M, d) -> (M, width) f32 [x, sin(2^0 x), cos(2^0 x), ..., zeros]
    in the kernel's form: cos columns are sin(x 2^k + pi/2)."""
    m, d = x.shape
    live = d * (1 + 2 * num_freqs)
    col = torch.arange(live, device=x.device)
    j = col // d
    trig = j > 0
    k = torch.clamp(j - 1, min=0) // 2
    scale = torch.where(trig, 2.0 ** k.float(), torch.ones_like(k, dtype=torch.float32))
    phase = torch.where(trig & ((j - 1) % 2 == 1),
                        torch.tensor(np.float32(np.pi / 2), device=x.device),
                        torch.tensor(0.0, device=x.device))
    xp = x.float()[:, col % d] * scale + phase
    enc = torch.where(trig, torch.sin(xp), xp)
    return F.pad(enc, (0, width - live))


@dataclasses.dataclass
class ForwardTrace:
    """The plain forward's intermediates, in the kernels' rounding."""

    enc: torch.Tensor  # (M, EP) compute dtype
    branch_in: Optional[torch.Tensor]  # (M, D + DP + AP) [final | dir enc | app]
    hs: List[torch.Tensor]  # trunk outputs, compute dtype
    sigma_pre: torch.Tensor  # (M,) f32, noise included
    branch: Optional[torch.Tensor]  # (M, D / 2) compute dtype
    rgb_pre: torch.Tensor  # (M, 3) f32

    def output(self, shifted_softplus: bool) -> torch.Tensor:
        """(M, 4) f32 [sigmoid rgb, activated sigma]."""
        s = self.sigma_pre
        sigma = F.softplus(s - 1.0) if shifted_softplus else torch.relu(s)
        return torch.cat([torch.sigmoid(self.rgb_pre), sigma[:, None]], -1)


def forward_trace(
    packed: PackedMLP,
    xyz: torch.Tensor,
    dirs: Optional[torch.Tensor],
    app: Optional[torch.Tensor],
    noise: Optional[torch.Tensor] = None,
    acc: torch.dtype = torch.float32,
) -> ForwardTrace:
    """The kernels' forward arithmetic in PyTorch: the same encode form
    (cos as sin(x 2^k + pi/2)), operands rounded to the compute dtype,
    float32 accumulation and bias, rounding after each layer; `noise`
    (M,) f32 is added to the sigma pre-activation. `acc=torch.float64`
    gives an f32 model's reference: the same f32 encode, weights and rows
    in, every product, sum and activation in f64."""
    cfg = packed.config
    dt = cfg.dtype if acc == torch.float32 else acc

    def lin(x, w, b):
        return x.to(acc) @ w.to(acc).T + b.to(acc)

    enc = encode(xyz, cfg.pos_xyz_dim, packed.ep).to(dt)
    h = enc
    hs = []
    for i, (w, b) in enumerate(zip(packed.mats[:cfg.layers], packed.biases)):
        inp = torch.cat([enc, h], -1) if i in cfg.skip_layers else h
        h = torch.relu(lin(inp, w, b)).to(dt)
        hs.append(h)

    sigma_pre = h.to(acc) @ packed.sigma_w.to(acc) + packed.sigma_b.to(acc)
    if noise is not None:
        sigma_pre = sigma_pre + noise.to(acc)

    branch_in = branch = None
    if packed.has_branch:
        final = lin(h, packed.mats[cfg.layers], packed.biases[cfg.layers]).to(dt)
        parts = [final]
        if packed.dp:
            parts.append(encode(dirs, cfg.pos_dir_dim, packed.dp).to(dt))
        if packed.ap:
            parts.append(F.pad(app.to(dt), (0, packed.ap - app.shape[1])))
        branch_in = torch.cat(parts, -1)
        branch = torch.relu(lin(branch_in, packed.mats[cfg.layers + 1],
                                packed.biases[cfg.layers + 1])).to(dt)
        h = branch
    rgb_pre = lin(h, packed.rgb_w, packed.rgb_b)
    return ForwardTrace(enc, branch_in, hs, sigma_pre, branch, rgb_pre)


def fused_nerf_eval_plain(
    packed: PackedMLP,
    xyz: torch.Tensor,  # (M, xyz_dim)
    dirs: Optional[torch.Tensor] = None,  # (M, 3) direction coordinates
    app: Optional[torch.Tensor] = None,  # (M, appearance_dim)
) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> (M, 4) f32 [rgb, sigma]."""
    fused_nerf_eval_plain.calls += 1
    trace = forward_trace(packed, xyz, dirs, app)
    return trace.output(packed.config.shifted_softplus)


fused_nerf_eval_plain.calls = 0


def _check(name: str, t: Optional[torch.Tensor], dtype, shape) -> None:
    if t is None:
        raise ValueError(f"{name} is required by this model")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def fused_nerf_eval(
    packed: PackedMLP,
    xyz: torch.Tensor,
    dirs: Optional[torch.Tensor] = None,
    app: Optional[torch.Tensor] = None,
    *,
    grid: Optional[int] = None,
) -> torch.Tensor:
    """(M, 4) f32 [rgb, sigma] for M points.

    xyz (M, xyz_dim) f32; dirs (M, 3) f32 direction coordinates (after the
    ref_packed_dirs swap) when the model reads directions; app
    (M, appearance_dim) per-point appearance rows when it has appearance.
    CPU tensors run `fused_nerf_eval_plain`; CUDA tensors launch the kernel
    of `csrc/eval_fwd.cu` in bf16 compute, of `csrc/eval_f32.cu`
    (`fused_f32.fused_nerf_eval_f32`) in f32, or raise. `grid` sets the
    number of CTAs of the bf16 kernel's persistent walk (tests only;
    default: as many as the card holds at once, at most one per tile)."""
    if xyz.device.type == "cpu":
        return fused_nerf_eval_plain(packed, xyz, dirs, app)
    if xyz.device.type != "cuda":
        raise ValueError(f"fused_nerf_eval: unsupported device {xyz.device}")
    m = xyz.shape[0]
    check_inputs(packed, xyz, dirs, app)
    if packed.config.dtype == torch.float32:
        from mega_nerf_tpu_torch.render.fused_f32 import fused_nerf_eval_f32

        return fused_nerf_eval_f32(packed, xyz, dirs, app)
    plan = eval_plan(packed)
    lib = _eval_library()
    out = torch.empty((m, 4), dtype=torch.float32, device=xyz.device)
    if m == 0:
        return out
    if grid is None:
        grid = launch_grid(packed, m, xyz.device)
    c_ptrs, c_dims = launch_tables(packed, xyz, dirs, app, out)
    o = plan.offsets
    ints = [plan.tm, plan.stages, plan.stage_bytes, o["enc"], o["dir"], o["app"],
            o["act"], o["ring"], o["bar"], o["sig"], plan.smem_bytes]
    shapes = [v for s in plan.mats for v in s]
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = lib.eval_fwd_launch(
        c_ptrs, c_dims, (ctypes.c_int * len(ints))(*ints),
        (ctypes.c_int * len(shapes))(*shapes), int(grid), ctypes.c_void_p(stream))
    fused_nerf_eval.launches += 1
    _raise_if(lib, err, "fused_nerf_eval")
    return out


def eval_plan(packed: PackedMLP):
    """The eval kernel's tile and shared memory: the training forward's
    plan (`fused_train.py::train_fwd_plan`; its saved-row fields are not
    used). Raises ValueError unless the packed matrices are the plan's."""
    from mega_nerf_tpu_torch.render.fused_train import train_fwd_plan

    plan = train_fwd_plan(packed.config)
    if plan.mats != [tuple(w.shape) for w in packed.mats]:
        raise ValueError("eval_fwd: packed matrices do not match the plan")
    return plan


def eval_grid(m: int, tm: int, resident: int) -> int:
    """CTAs of a persistent launch over m points: one per tile of tm
    points, at most as many as the card holds at once."""
    return max(1, min(-(-m // tm), resident))


def launch_grid(packed: PackedMLP, m: int, device: torch.device) -> int:
    """The grid `fused_nerf_eval` launches for m points on `device`."""
    plan = eval_plan(packed)
    return eval_grid(m, plan.tm, _resident_ctas(_eval_library(), device,
                                                plan.smem_bytes))


def check_inputs(packed: PackedMLP, xyz, dirs, app) -> None:
    """Raise unless the inputs are what the forward kernels take: bf16 or
    f32 compute, contiguous f32 xyz/dirs and appearance rows in the compute
    dtype, weights on the points' device."""
    cfg = packed.config
    if cfg.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"the fused kernels compute in bfloat16 or float32, not "
            f"{cfg.compute_dtype}; pass --no_pallas"
        )
    m = xyz.shape[0]
    _check("xyz", xyz, torch.float32, (m, cfg.xyz_dim))
    if packed.dp:
        _check("dirs", dirs, torch.float32, (m, 3))
    if packed.ap:
        _check("app", app, cfg.dtype, (m, cfg.appearance_dim))
    for t in packed.mats + packed.biases + [packed.sigma_w, packed.rgb_w]:
        if t.device != xyz.device:
            raise ValueError("packed weights live on another device than xyz")


def launch_tables(packed: PackedMLP, xyz, dirs, app, out):
    """The forward kernels' pointer and int tables (read by
    `eval_fwd_launch` in eval_fwd.cu and by `train_fwd_launch` in
    train_fwd.cu) as ctypes arrays."""
    cfg = packed.config
    ptrs = [xyz.data_ptr(), dirs.data_ptr() if packed.dp else 0,
            app.data_ptr() if packed.ap else 0, out.data_ptr(),
            packed.sigma_w.data_ptr(), packed.sigma_b.data_ptr(),
            packed.rgb_w.data_ptr(), packed.rgb_b.data_ptr()]
    for w, b in zip(packed.mats, packed.biases):
        ptrs += [w.data_ptr(), b.data_ptr()]
    dims = [xyz.shape[0], cfg.xyz_dim, cfg.pos_xyz_dim, cfg.pos_dir_dim,
            cfg.layers, cfg.layer_dim, cfg.appearance_dim, skip_mask(cfg),
            int(packed.has_branch), int(cfg.shifted_softplus),
            packed.ep, packed.dp, packed.ap]
    return ((ctypes.c_longlong * len(ptrs))(*ptrs),
            (ctypes.c_int * len(dims))(*dims))


def skip_mask(cfg: NeRFConfig) -> int:
    return sum(1 << i for i in cfg.skip_layers if i < cfg.layers)


fused_nerf_eval.launches = 0


def _eval_library() -> ctypes.CDLL:
    from mega_nerf_tpu_torch.render._build import load_library

    lib = load_library("eval_fwd")
    if not getattr(lib, "_eval_bound", False):
        vp = ctypes.c_void_p
        lib.eval_fwd_launch.argtypes = [vp, vp, vp, vp, ctypes.c_int, vp]
        lib.eval_fwd_launch.restype = ctypes.c_int
        lib.eval_fwd_resident_ctas.argtypes = [ctypes.c_int, vp]
        lib.eval_fwd_resident_ctas.restype = ctypes.c_int
        lib.error_string = lib.eval_fwd_error_string
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib._eval_bound = True
    return lib


def _raise_if(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.error_string(err).decode())


_RESIDENT: Dict[Tuple[str, int, int], int] = {}


def _resident_ctas(lib: ctypes.CDLL, device: torch.device, smem: int,
                   query: str = "eval_fwd_resident_ctas") -> int:
    """CTAs of a persistent kernel with `smem` bytes of shared memory that
    the card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
    SMs, the library's `query` export), cached per query, device and
    shared-memory size."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (query, index, smem)
    if key not in _RESIDENT:
        ctas = ctypes.c_int(0)
        with torch.cuda.device(index):
            _raise_if(lib, getattr(lib, query)(smem, ctypes.byref(ctas)), query)
        if ctas.value < 1:
            raise RuntimeError(f"{query}: no CTA with {smem} B of shared "
                               "memory fits an SM")
        _RESIDENT[key] = ctas.value
    return _RESIDENT[key]


def flops_per_point(cfg: NeRFConfig) -> int:
    """Multiply-adds x 2 of one point's forward at the live (unpadded)
    widths: the work the bound counts."""
    d = cfg.layer_dim
    macs = 0
    for i in range(cfg.layers):
        k = cfg.enc_in if i == 0 else (cfg.enc_in + d if i in cfg.skip_layers else d)
        macs += k * d
    macs += d  # sigma head
    if cfg.uses_dir_branch:
        macs += d * d + (d + cfg.dir_in + cfg.appearance_dim) * (d // 2)
        macs += (d // 2) * 3
    else:
        macs += d * 3
    return 2 * macs


def io_bytes_per_point(cfg: NeRFConfig) -> int:
    """Bytes one point moves at the kernel's boundary: xyz, dirs and
    appearance (in the compute dtype) read once, (rgb, sigma) written
    once."""
    b = 4 * cfg.xyz_dim + 16
    if cfg.pos_dir_dim > 0:
        b += 12
    b += cfg.dtype.itemsize * cfg.appearance_dim
    return b


__all__ = [
    "PackedMLP", "pack_params", "pack_tensors", "mat_layout",
    "mlp_param_names", "supports_fused_kernel", "is_wide", "encode", "forward_trace",
    "fused_nerf_eval", "fused_nerf_eval_plain", "eval_plan", "eval_grid",
    "launch_grid", "flops_per_point", "io_bytes_per_point",
]
