"""Fused NeRF eval MLP: packing, the plain PyTorch version, the kernel wrapper.

Counterpart of the JAX package's `render/pallas_mlp.py`. The hand-written
Hopper kernel is `csrc/fused_mlp.cu` (it replaces
`mega_nerf_tpu/render/pallas_mlp.py::_mlp_kernel`).

- `pack_params` lays a `NeRF` module's weights out for the kernel: one
  (out, in) matrix per matmul layer in the compute dtype, with zero columns
  padding each input segment to a multiple of 16 (the MMA depth), and f32
  biases. The 128-lane padding of the TPU layout is gone.
- `fused_nerf_eval_plain` repeats the kernel's arithmetic in PyTorch: the
  same encode form (cos as sin(x 2^k + pi/2)), operands rounded to the
  compute dtype, float32 accumulation and bias, rounding after each layer.
- `fused_nerf_eval` is the wrapper: on a CPU tensor it runs the plain
  version; on a CUDA tensor it launches the kernel or raises. Each counts
  its calls in a `launches` / `calls` attribute.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mega_nerf_tpu_torch.models.nerf import NeRF, NeRFConfig

MMA_K = 16  # input segments pad to the mma.sync depth
MAX_LAYER_DIM = 512  # 2 x 64 x 520 bf16 activation tiles: ~161 KB of shared memory
MAX_MATRICES = 16  # trunk layers + trunk_final + dir_a (the kernel's table)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def supports_fused_kernel(cfg: NeRFConfig) -> Tuple[bool, str]:
    """Whether the fused eval kernel covers this architecture -> (ok, why)."""
    if cfg.rgb_dim != 3:
        return False, "SH output head"
    if cfg.affine_appearance:
        return False, "affine appearance"
    if cfg.layer_dim % 16 or cfg.layer_dim > MAX_LAYER_DIM:
        return False, f"layer_dim {cfg.layer_dim} (needs a multiple of 16 <= {MAX_LAYER_DIM})"
    if 0 in cfg.skip_layers:
        return False, "skip connection at layer 0"
    if cfg.layers + 2 > MAX_MATRICES:
        return False, f"{cfg.layers} layers"
    return True, ""


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
    ok, why = supports_fused_kernel(cfg)
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
) -> ForwardTrace:
    """The kernels' forward arithmetic in PyTorch: the same encode form
    (cos as sin(x 2^k + pi/2)), operands rounded to the compute dtype,
    float32 accumulation and bias, rounding after each layer; `noise`
    (M,) f32 is added to the sigma pre-activation."""
    cfg = packed.config
    dt = cfg.dtype

    def lin(x, w, b):
        return x.float() @ w.float().T + b

    enc = encode(xyz, cfg.pos_xyz_dim, packed.ep).to(dt)
    h = enc
    hs = []
    for i, (w, b) in enumerate(zip(packed.mats[:cfg.layers], packed.biases)):
        inp = torch.cat([enc, h], -1) if i in cfg.skip_layers else h
        h = torch.relu(lin(inp, w, b)).to(dt)
        hs.append(h)

    sigma_pre = h.float() @ packed.sigma_w.float() + packed.sigma_b
    if noise is not None:
        sigma_pre = sigma_pre + noise.float()

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
) -> torch.Tensor:
    """(M, 4) f32 [rgb, sigma] for M points.

    xyz (M, xyz_dim) f32; dirs (M, 3) f32 direction coordinates (after the
    ref_packed_dirs swap) when the model reads directions; app
    (M, appearance_dim) per-point appearance rows when it has appearance.
    CPU tensors run `fused_nerf_eval_plain`; CUDA tensors launch the kernel
    (bf16 compute only) or raise."""
    if xyz.device.type == "cpu":
        return fused_nerf_eval_plain(packed, xyz, dirs, app)
    if xyz.device.type != "cuda":
        raise ValueError(f"fused_nerf_eval: unsupported device {xyz.device}")
    m = xyz.shape[0]
    check_inputs(packed, xyz, dirs, app)

    from mega_nerf_tpu_torch.render._build import load_library

    lib = load_library("fused_mlp")
    _bind(lib)
    out = torch.empty((m, 4), dtype=torch.float32, device=xyz.device)
    if m == 0:
        return out
    c_ptrs, c_dims = launch_tables(packed, xyz, dirs, app, out)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = lib.fused_nerf_eval_launch(c_ptrs, c_dims, ctypes.c_void_p(stream))
    fused_nerf_eval.launches += 1
    if err != 0:
        raise RuntimeError(
            "fused_nerf_eval kernel launch failed: "
            + lib.fused_nerf_eval_error_string(err).decode()
        )
    return out


def check_inputs(packed: PackedMLP, xyz, dirs, app) -> None:
    """Raise unless the inputs are what the forward kernels take: bf16
    compute, contiguous f32 xyz/dirs and bf16 appearance rows, weights on
    the points' device."""
    cfg = packed.config
    if cfg.dtype != torch.bfloat16:
        raise NotImplementedError(
            "the fused kernels compute in bfloat16; pass "
            "--compute_dtype bfloat16 or --no_pallas"
        )
    m = xyz.shape[0]
    _check("xyz", xyz, torch.float32, (m, cfg.xyz_dim))
    if packed.dp:
        _check("dirs", dirs, torch.float32, (m, 3))
    if packed.ap:
        _check("app", app, torch.bfloat16, (m, cfg.appearance_dim))
    for t in packed.mats + packed.biases + [packed.sigma_w, packed.rgb_w]:
        if t.device != xyz.device:
            raise ValueError("packed weights live on another device than xyz")


def launch_tables(packed: PackedMLP, xyz, dirs, app, out):
    """The forward kernels' pointer and int tables (read by
    `fused_nerf_eval_launch` in fused_mlp.cu and by `fill_params` in
    fused_train.cu) as ctypes arrays."""
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


def _bind(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_fused_bound", False):
        return
    lib.fused_nerf_eval_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.fused_nerf_eval_launch.restype = ctypes.c_int
    lib.fused_nerf_eval_error_string.argtypes = [ctypes.c_int]
    lib.fused_nerf_eval_error_string.restype = ctypes.c_char_p
    lib._fused_bound = True


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
    appearance read once, (rgb, sigma) written once."""
    b = 4 * cfg.xyz_dim + 16
    if cfg.pos_dir_dim > 0:
        b += 12
    b += 2 * cfg.appearance_dim
    return b


__all__ = [
    "PackedMLP", "pack_params", "pack_tensors", "mat_layout",
    "mlp_param_names", "supports_fused_kernel", "encode", "forward_trace",
    "fused_nerf_eval", "fused_nerf_eval_plain", "flops_per_point",
    "io_bytes_per_point",
]
