"""The core NeRF MLP as an eager `nn.Module`.

Counterpart of the JAX package's `models/nerf.py` (`NeRFConfig`, `NeRF`):
frequency encoding in float32, a skip-connection trunk, a shifted-softplus
density head, and a view/appearance branch feeding the rgb head. Parameter
names follow the reference torch module (`xyz_encodings.{i}.0.*`,
`sigma.*`, `xyz_encoding_final.*`, `dir_a_encoding.0.*`, `rgb.*`,
`embedding_a.weight`, `affine.*`), so a reference `{iter}.pt` loads with
`load_state_dict`.

Precision follows the JAX module's dense layer: operands are rounded to the
compute dtype, products accumulate in float32, the float32 bias is added,
and the result is rounded to the compute dtype again. bf16 values are exact
in float32, so a float32 matmul of the rounded operands is that arithmetic
exactly (TF32 stays off for float32 matmuls by default).

The SH output head (`rgb_dim` = 3 (sh_deg + 1)^2) returns raw
coefficients, which the renderer turns into rgb with `ops/sh.py::eval_sh`.
Affine appearance maps the embedding to a 3x4 colour transform applied to
the rgb pre-activation, in the compute dtype, and keeps the embedding out
of the view branch. The coarse/fine cascade holds two of these modules
(`models/cascade.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def frequency_encode(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """x -> [x, sin(2^0 x), cos(2^0 x), ..., sin(2^k x), cos(2^k x)]
    (per frequency a sin block then a cos block, each of width d)."""
    if num_freqs == 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]  # (..., F, d)
    enc = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1)  # (..., F, 2d)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Static architecture description (mirror of the JAX `NeRFConfig`)."""

    pos_xyz_dim: int = 12
    pos_dir_dim: int = 4
    layers: int = 8
    skip_layers: Tuple[int, ...] = (4,)
    layer_dim: int = 256
    appearance_dim: int = 48
    affine_appearance: bool = False
    appearance_count: int = 1
    rgb_dim: int = 3
    xyz_dim: int = 3
    shifted_softplus: bool = True
    compute_dtype: str = "float32"
    # The reference reads view dirs at x[:, -4:-1] of its packed input,
    # which for appearance-less models is [xyz_last, dir_x, dir_y].
    ref_packed_dirs: bool = False

    def __post_init__(self):
        if self.rgb_dim > 3:
            assert self.pos_dir_dim == 0, "SH output head requires pos_dir_dim == 0"
        object.__setattr__(self, "skip_layers", tuple(self.skip_layers))

    @property
    def uses_dir_branch(self) -> bool:
        return self.pos_dir_dim > 0 or (
            self.appearance_dim > 0 and not self.affine_appearance
        )

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def enc_in(self) -> int:
        return self.xyz_dim * (1 + 2 * self.pos_xyz_dim)

    @property
    def dir_in(self) -> int:
        return 3 * (1 + 2 * self.pos_dir_dim) if self.pos_dir_dim > 0 else 0


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """Linear layer in `dtype` operands with float32 accumulation and bias."""
    y = F.linear(x.to(dtype).float(), layer.weight.to(dtype).float(), layer.bias)
    return y.to(dtype)


def direction_coords(cfg: NeRFConfig, xyz: torch.Tensor,
                     dirs: torch.Tensor) -> torch.Tensor:
    """The coordinates the direction encoding reads (see ref_packed_dirs)."""
    if cfg.ref_packed_dirs and cfg.appearance_dim == 0:
        return torch.cat([xyz[..., -1:], dirs[..., :2]], dim=-1)
    return dirs


class NeRF(nn.Module):
    """Skip-connection MLP emitting (rgb or SH coefficients, sigma).

    forward(xyz (..., xyz_dim), dirs (..., 3) or None, image_indices (...,)
    int or None, sigma_noise (...,) f32 or None) -> (..., rgb_dim + 1):
    sigmoid rgb (raw SH coefficients when rgb_dim > 3) and shifted-softplus
    sigma; the training noise is added to the sigma pre-activation."""

    def __init__(self, config: NeRFConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        d = cfg.layer_dim
        layers = []
        for i in range(cfg.layers):
            if i == 0:
                fan_in = cfg.enc_in
            elif i in cfg.skip_layers:
                fan_in = cfg.enc_in + d
            else:
                fan_in = d
            layers.append(nn.Sequential(nn.Linear(fan_in, d), nn.ReLU()))
        self.xyz_encodings = nn.ModuleList(layers)
        self.sigma = nn.Linear(d, 1)
        if cfg.appearance_dim > 0:
            self.embedding_a = nn.Embedding(
                cfg.appearance_count, cfg.appearance_dim
            )
        if cfg.affine_appearance:
            if cfg.appearance_dim == 0:
                raise ValueError("affine appearance needs appearance_dim > 0")
            self.affine = nn.Linear(cfg.appearance_dim, 12)
        if cfg.uses_dir_branch:
            # Affine appearance keeps the embedding out of the branch.
            branch_app = 0 if cfg.affine_appearance else cfg.appearance_dim
            self.xyz_encoding_final = nn.Linear(d, d)
            self.dir_a_encoding = nn.Sequential(
                nn.Linear(d + cfg.dir_in + branch_app, d // 2),
                nn.ReLU(),
            )
            self.rgb = nn.Linear(d // 2, cfg.rgb_dim)
        else:
            self.rgb = nn.Linear(d, cfg.rgb_dim)

    def appearance(self, image_indices: torch.Tensor) -> torch.Tensor:
        """Embedding rows in the compute dtype; out-of-range indices clamp
        to the nearest row (like the JAX package's take(mode="clip")). The
        rows are gathered from the f32 table and then rounded, so the
        gradient scatter into the table adds in f32."""
        table = self.embedding_a.weight
        idx = torch.clamp(image_indices.long(), 0, table.shape[0] - 1)
        return table[idx].to(self.config.dtype)

    def forward(
        self,
        xyz: torch.Tensor,
        dirs: Optional[torch.Tensor] = None,
        image_indices: Optional[torch.Tensor] = None,
        sigma_noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        x_in = frequency_encode(xyz.float(), cfg.pos_xyz_dim).to(dt)
        h = x_in
        for i, layer in enumerate(self.xyz_encodings):
            if i in cfg.skip_layers:
                h = torch.cat([x_in, h], dim=-1)
            h = torch.relu(dense(h, layer[0], dt))

        sigma = dense(h, self.sigma, dt).float()
        if sigma_noise is not None:
            sigma = sigma + sigma_noise.float()[..., None]
        if cfg.shifted_softplus:
            sigma = F.softplus(sigma - 1.0)
        else:
            sigma = torch.relu(sigma)

        app = None
        if cfg.appearance_dim > 0:
            if image_indices is None:
                raise ValueError("appearance model needs image indices")
            app = self.appearance(image_indices)
        if cfg.uses_dir_branch:
            branch_in = [dense(h, self.xyz_encoding_final, dt)]
            if cfg.pos_dir_dim > 0:
                if dirs is None:
                    raise ValueError("view-dependent model needs directions")
                dir_in = direction_coords(cfg, xyz, dirs)
                branch_in.append(
                    frequency_encode(dir_in.float(), cfg.pos_dir_dim).to(dt)
                )
            if app is not None and not cfg.affine_appearance:
                branch_in.append(app)
            branch = torch.relu(
                dense(torch.cat(branch_in, dim=-1), self.dir_a_encoding[0], dt)
            )
            rgb = dense(branch, self.rgb, dt)
        else:
            rgb = dense(h, self.rgb, dt)
        if cfg.affine_appearance:
            # rgb <- A[:, :3] rgb + A[:, 3], rounded to the compute dtype
            # after the product and after the sum, as the JAX module's
            # einsum and add in that dtype.
            affine = dense(app, self.affine, dt).reshape(*app.shape[:-1], 3, 4)
            mixed = (affine[..., :3].float() @ rgb.float()[..., None])[..., 0]
            rgb = mixed.to(dt) + affine[..., 3]
        rgb = rgb.float()
        if cfg.rgb_dim == 3:
            rgb = torch.sigmoid(rgb)
        return torch.cat([rgb, sigma], dim=-1)


# The standard deviation of a unit normal truncated to [-2, 2].
TRUNCATED_NORMAL_STD = 0.87962566103423978


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with the JAX package's distributions (flax's
    defaults): weights LeCun normal as `nn.initializers.lecun_normal` draws
    it (a normal truncated at two standard deviations, scaled to variance
    1/fan_in), zero biases, appearance embedding rows normal with variance
    1/dim (`nn.Embed`'s default). The draws are the generator's, not JAX's."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
                continue
            if "embedding_a" in name:
                noise = torch.randn(p.shape, generator=generator, dtype=p.dtype)
            else:
                noise = nn.init.trunc_normal_(torch.empty(p.shape, dtype=p.dtype),
                                              generator=generator) / TRUNCATED_NORMAL_STD
            p.copy_(noise / p.shape[-1] ** 0.5)
