"""A TorchScript-scriptable NeRF for the viewer's container format.

The Mega-NeRF viewer reads a merged model as a TorchScript module whose
`sub_module_{i}` / `bg_sub_module_{i}` children take one packed input
`[xyz | dirs? | image index?]` and return `[rgb, sigma]`. The port's own
`NeRF` takes its inputs apart and holds its config in a dataclass, which
TorchScript cannot script, so this module is the export shim: the same
network in float32, scriptable, under the reference's parameter names
(`xyz_encodings.{i}.0.*`, `sigma.*`, `xyz_encoding_final.*`,
`dir_a_encoding.0.*`, `rgb.*`, `embedding_a.weight`, `affine.*`), so a
submodule's state dict is a reference state dict.

Parts the architecture does not use are registered as (1, 1) placeholders,
as TorchScript needs every attribute a branch names; loaders read only the
keys the architecture has (`models/weights.py::_entries`). Counterpart of
the JAX package's `models/torch_nerf.py`, whose mirror uses its own names
(`trunk.{i}.*`, ...), which `weights.normalize_torchscript_keys` maps back.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from mega_nerf_tpu_torch.models.nerf import NeRFConfig


class TorchNeRF(nn.Module):
    def __init__(self, pos_xyz_dim: int, pos_dir_dim: int, layers: int,
                 skip_layers: List[int], layer_dim: int, appearance_dim: int,
                 affine_appearance: bool, appearance_count: int, rgb_dim: int,
                 xyz_dim: int, shifted_softplus: bool, ref_packed_dirs: bool = False):
        super().__init__()
        self.xyz_dim = xyz_dim
        self.pos_xyz_dim = pos_xyz_dim
        self.pos_dir_dim = pos_dir_dim
        self.skip_layers = skip_layers
        self.shifted_softplus = shifted_softplus
        self.affine_appearance = affine_appearance
        self.rgb_dim = rgb_dim
        self.has_appearance = appearance_dim > 0
        # Columns of the view direction in the packed input: right after
        # xyz, or one column left under the reference's packing quirk for
        # appearance-less models (NeRFConfig.ref_packed_dirs).
        self.dir_start = xyz_dim - 1 if ref_packed_dirs and appearance_dim == 0 else xyz_dim

        in_xyz = xyz_dim * (1 + 2 * pos_xyz_dim)
        trunk = []
        for i in range(layers):
            fan_in = in_xyz if i == 0 else layer_dim + (in_xyz if i in skip_layers else 0)
            trunk.append(nn.Sequential(nn.Linear(fan_in, layer_dim), nn.ReLU()))
        self.xyz_encodings = nn.ModuleList(trunk)
        self.sigma = nn.Linear(layer_dim, 1)

        self.use_dir_branch = pos_dir_dim > 0 or (appearance_dim > 0 and not affine_appearance)
        in_dir = 3 * (1 + 2 * pos_dir_dim) if pos_dir_dim > 0 else 0
        branch_app = appearance_dim if self.has_appearance and not affine_appearance else 0
        if self.use_dir_branch:
            self.xyz_encoding_final = nn.Linear(layer_dim, layer_dim)
            self.dir_a_encoding = nn.Sequential(
                nn.Linear(layer_dim + in_dir + branch_app, layer_dim // 2), nn.ReLU())
            self.rgb = nn.Linear(layer_dim // 2, rgb_dim)
        else:
            self.xyz_encoding_final = nn.Linear(1, 1)
            self.dir_a_encoding = nn.Sequential(nn.Linear(1, 1), nn.ReLU())
            self.rgb = nn.Linear(layer_dim, rgb_dim)
        self.embedding_a = nn.Embedding(appearance_count if self.has_appearance else 1,
                                        appearance_dim if self.has_appearance else 1)
        self.affine = nn.Linear(appearance_dim, 12) if affine_appearance else nn.Linear(1, 1)

    def _encode(self, x: torch.Tensor, num_freqs: int) -> torch.Tensor:
        out = [x]
        for k in range(num_freqs):
            f = float(2 ** k)
            out.append(torch.sin(f * x))
            out.append(torch.cos(f * x))
        return torch.cat(out, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, xyz_dim [+ 3] [+ 1]) packed as [xyz | dirs | image index]
        -> (N, rgb_dim + 1) [rgb, sigma]."""
        enc = self._encode(x[:, :self.xyz_dim], self.pos_xyz_dim)
        h = enc
        for i, layer in enumerate(self.xyz_encodings):
            if i in self.skip_layers:
                h = torch.cat([enc, h], -1)
            h = layer(h)

        sigma = self.sigma(h)
        if self.shifted_softplus:
            sigma = F.softplus(sigma - 1)
        else:
            sigma = F.relu(sigma)

        if self.use_dir_branch:
            branch = [self.xyz_encoding_final(h)]
            if self.pos_dir_dim > 0:
                branch.append(self._encode(x[:, self.dir_start:self.dir_start + 3],
                                           self.pos_dir_dim))
            if self.has_appearance and not self.affine_appearance:
                branch.append(self.embedding_a(x[:, -1].long()))
            rgb = self.rgb(self.dir_a_encoding(torch.cat(branch, -1)))
        else:
            rgb = self.rgb(h)
        if self.affine_appearance and self.has_appearance:
            t = self.affine(self.embedding_a(x[:, -1].long())).view(-1, 3, 4)
            rgb = (t[:, :, :3] @ rgb.unsqueeze(-1) + t[:, :, 3:]).squeeze(-1)
        if self.rgb_dim == 3:
            rgb = torch.sigmoid(rgb)
        return torch.cat([rgb, sigma], -1)


def torch_nerf_from_state(cfg: NeRFConfig, state: Dict) -> TorchNeRF:
    """A TorchNeRF of `cfg` holding a reference-named state dict (numpy
    arrays or tensors); every key of `state` must land."""
    model = TorchNeRF(cfg.pos_xyz_dim, cfg.pos_dir_dim, cfg.layers, list(cfg.skip_layers),
                      cfg.layer_dim, cfg.appearance_dim, cfg.affine_appearance,
                      cfg.appearance_count, cfg.rgb_dim, cfg.xyz_dim,
                      cfg.shifted_softplus, cfg.ref_packed_dirs)
    tensors = {k: torch.as_tensor(v, dtype=torch.float32).clone() for k, v in state.items()}
    _, unexpected = model.load_state_dict(tensors, strict=False)
    if unexpected:
        raise ValueError(f"keys outside the architecture: {unexpected}")
    return model.eval()
