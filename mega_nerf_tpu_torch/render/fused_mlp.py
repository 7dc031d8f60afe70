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
from typing import List, Optional, Tuple

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


def pack_params(module: NeRF) -> PackedMLP:
    """A `NeRF` module's weights -> the kernel's layout, on its device."""
    cfg = module.config
    ok, why = supports_fused_kernel(cfg)
    if not ok:
        raise NotImplementedError(f"fused eval kernel does not cover: {why}")
    dt = cfg.dtype
    d = cfg.layer_dim
    ep = _round_up(cfg.enc_in, MMA_K)
    dp = _round_up(cfg.dir_in, MMA_K)
    ap = _round_up(cfg.appearance_dim, MMA_K)

    def place(w: torch.Tensor, pieces) -> torch.Tensor:
        """Copy column ranges of w into a zero matrix: [(src0, dst0, n)]."""
        width = max(dst + n for _, dst, n in pieces)
        out = w.new_zeros((w.shape[0], _round_up(width, MMA_K)))
        for src, dst, n in pieces:
            out[:, dst:dst + n] = w[:, src:src + n]
        return out

    with torch.no_grad():
        mats, biases = [], []
        for i, layer in enumerate(module.xyz_encodings):
            w = layer[0].weight.float()
            if i == 0:
                w = place(w, [(0, 0, cfg.enc_in)])
            elif i in cfg.skip_layers:
                w = place(w, [(0, 0, cfg.enc_in), (cfg.enc_in, ep, d)])
            mats.append(w)
            biases.append(layer[0].bias.float())
        if cfg.uses_dir_branch:
            mats.append(module.xyz_encoding_final.weight.float())
            biases.append(module.xyz_encoding_final.bias.float())
            w = module.dir_a_encoding[0].weight.float()
            pieces = [(0, 0, d)]
            if cfg.dir_in:
                pieces.append((d, d, cfg.dir_in))
            if cfg.appearance_dim:
                pieces.append((d + cfg.dir_in, d + dp, cfg.appearance_dim))
            mats.append(place(w, pieces))
            biases.append(module.dir_a_encoding[0].bias.float())
        return PackedMLP(
            config=cfg, ep=ep, dp=dp, ap=ap,
            mats=[m.detach().to(dt).contiguous() for m in mats],
            biases=[b.detach().contiguous() for b in biases],
            sigma_w=module.sigma.weight[0].detach().to(dt).contiguous(),
            sigma_b=module.sigma.bias.detach().float().contiguous(),
            rgb_w=module.rgb.weight.detach().to(dt).contiguous(),
            rgb_b=module.rgb.bias.detach().float().contiguous(),
        )


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


def fused_nerf_eval_plain(
    packed: PackedMLP,
    xyz: torch.Tensor,  # (M, xyz_dim)
    dirs: Optional[torch.Tensor] = None,  # (M, 3) direction coordinates
    app: Optional[torch.Tensor] = None,  # (M, appearance_dim)
) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> (M, 4) f32 [rgb, sigma]."""
    fused_nerf_eval_plain.calls += 1
    cfg = packed.config
    dt = cfg.dtype

    def lin(x, w, b):
        return x.float() @ w.float().T + b

    enc = encode(xyz, cfg.pos_xyz_dim, packed.ep).to(dt)
    h = enc
    for i, (w, b) in enumerate(zip(packed.mats[:cfg.layers], packed.biases)):
        inp = torch.cat([enc, h], -1) if i in cfg.skip_layers else h
        h = torch.relu(lin(inp, w, b)).to(dt)

    sigma = h.float() @ packed.sigma_w.float() + packed.sigma_b
    sigma = F.softplus(sigma - 1.0) if cfg.shifted_softplus else torch.relu(sigma)

    if packed.has_branch:
        final = lin(h, packed.mats[cfg.layers], packed.biases[cfg.layers]).to(dt)
        parts = [final]
        if packed.dp:
            parts.append(encode(dirs, cfg.pos_dir_dim, packed.dp).to(dt))
        if packed.ap:
            parts.append(F.pad(app.to(dt), (0, packed.ap - app.shape[1])))
        h = torch.relu(lin(torch.cat(parts, -1), packed.mats[cfg.layers + 1],
                           packed.biases[cfg.layers + 1])).to(dt)
    rgb = torch.sigmoid(lin(h, packed.rgb_w, packed.rgb_b))
    return torch.cat([rgb, sigma[:, None]], -1)


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
    cfg = packed.config
    if cfg.dtype != torch.bfloat16:
        raise NotImplementedError(
            "the fused eval kernel computes in bfloat16; pass "
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

    from mega_nerf_tpu_torch.render._build import load_library

    lib = load_library("fused_mlp")
    _bind(lib)
    out = torch.empty((m, 4), dtype=torch.float32, device=xyz.device)
    if m == 0:
        return out
    ptrs = [xyz.data_ptr(), dirs.data_ptr() if packed.dp else 0,
            app.data_ptr() if packed.ap else 0, out.data_ptr(),
            packed.sigma_w.data_ptr(), packed.sigma_b.data_ptr(),
            packed.rgb_w.data_ptr(), packed.rgb_b.data_ptr()]
    for w, b in zip(packed.mats, packed.biases):
        ptrs += [w.data_ptr(), b.data_ptr()]
    skip_mask = sum(1 << i for i in cfg.skip_layers if i < cfg.layers)
    dims = [m, cfg.xyz_dim, cfg.pos_xyz_dim, cfg.pos_dir_dim, cfg.layers,
            cfg.layer_dim, cfg.appearance_dim, skip_mask,
            int(packed.has_branch), int(cfg.shifted_softplus),
            packed.ep, packed.dp, packed.ap]
    c_ptrs = (ctypes.c_longlong * len(ptrs))(*ptrs)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = lib.fused_nerf_eval_launch(c_ptrs, c_dims, ctypes.c_void_p(stream))
    fused_nerf_eval.launches += 1
    if err != 0:
        raise RuntimeError(
            "fused_nerf_eval kernel launch failed: "
            + lib.fused_nerf_eval_error_string(err).decode()
        )
    return out


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
    "PackedMLP", "pack_params", "supports_fused_kernel", "encode",
    "fused_nerf_eval", "fused_nerf_eval_plain", "flops_per_point",
    "io_bytes_per_point",
]
