"""Weight carry-over between the JAX package's Flax params and the port.

The port's `NeRF` uses the reference torch naming; the JAX package names
its Flax modules `trunk_{i}`, `sigma`, `trunk_final`, `dir_a`, `rgb` and
`appearance` (and `affine`). torch `Linear` stores weight as (out, in), a
Flax Dense kernel as (in, out): kernels are transposed on the way through.
Embedding tables agree on (count, dim). A cascade's Flax tree holds the
two levels under "coarse" and "fine", its state dict under the `coarse.` /
`fine.` prefixes. The entry table is the port's own copy of the one in the
JAX package's `models/torch_interop.py`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from mega_nerf_tpu_torch.models.nerf import NeRFConfig

# (flax_module, flax_param, torch_key, transpose)
_Entry = Tuple[str, str, str, bool]


def _entries(cfg: NeRFConfig) -> List[_Entry]:
    entries: List[_Entry] = []
    for i in range(cfg.layers):
        entries.append((f"trunk_{i}", "kernel", f"xyz_encodings.{i}.0.weight", True))
        entries.append((f"trunk_{i}", "bias", f"xyz_encodings.{i}.0.bias", False))
    entries.append(("sigma", "kernel", "sigma.weight", True))
    entries.append(("sigma", "bias", "sigma.bias", False))
    if cfg.uses_dir_branch:
        entries.append(("trunk_final", "kernel", "xyz_encoding_final.weight", True))
        entries.append(("trunk_final", "bias", "xyz_encoding_final.bias", False))
        entries.append(("dir_a", "kernel", "dir_a_encoding.0.weight", True))
        entries.append(("dir_a", "bias", "dir_a_encoding.0.bias", False))
    entries.append(("rgb", "kernel", "rgb.weight", True))
    entries.append(("rgb", "bias", "rgb.bias", False))
    if cfg.appearance_dim > 0:
        entries.append(("appearance", "embedding", "embedding_a.weight", False))
    if cfg.affine_appearance:
        entries.append(("affine", "kernel", "affine.weight", True))
        entries.append(("affine", "bias", "affine.bias", False))
    return entries


def state_keys(cfg: NeRFConfig) -> List[str]:
    """The reference state-dict keys of one NeRF of `cfg`."""
    return [key for _, _, key, _ in _entries(cfg)]


_LEVELS = ("coarse", "fine")


def flax_param_paths(cfg: NeRFConfig, cascade: bool = False) -> Dict[str, str]:
    """'/'-joined path of each leaf of the Flax params tree of one NeRF of
    `cfg` (or of its cascade) -> the state-dict key it maps to."""
    if cascade:
        return {f"{level}/{path}": f"{level}.{key}" for level in _LEVELS
                for path, key in flax_param_paths(cfg).items()}
    return {f"{mod}/{name}": key for mod, name, key, _ in _entries(cfg)}


def state_from_flax_params(
    cfg: NeRFConfig, params_np: Dict, cascade: bool = False
) -> Dict[str, torch.Tensor]:
    """Flax params tree (numpy leaves) -> the port's state dict; with
    `cascade`, the tree's "coarse" / "fine" subtrees -> `coarse.` / `fine.`
    keys."""
    if cascade:
        return {f"{level}.{k}": v for level in _LEVELS
                for k, v in state_from_flax_params(cfg, params_np[level]).items()}
    state: Dict[str, torch.Tensor] = {}
    for mod, name, key, transpose in _entries(cfg):
        arr = np.asarray(params_np[mod][name], dtype=np.float32)
        if transpose:
            arr = arr.T
        state[key] = torch.from_numpy(np.array(arr, copy=True))
    return state


def flax_params_from_state(
    cfg: NeRFConfig, state: Dict[str, torch.Tensor], cascade: bool = False
) -> Dict:
    """The port's state dict -> Flax params tree of numpy arrays; with
    `cascade`, `coarse.` / `fine.` keys -> "coarse" / "fine" subtrees."""
    if cascade:
        return {level: flax_params_from_state(
            cfg, {k[len(level) + 1:]: v for k, v in state.items()
                  if k.startswith(level + ".")}) for level in _LEVELS}
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for mod, name, key, transpose in _entries(cfg):
        arr = state[key].detach().cpu().float().numpy()
        if transpose:
            arr = arr.T
        params.setdefault(mod, {})[name] = np.ascontiguousarray(arr)
    return params


def strip_module_prefix(state: Dict) -> Dict:
    """Drop DDP's 'module.' prefix from state-dict keys."""
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state.items()
    }


def appearance_count_from_state(state: Dict) -> int:
    """Rows of the appearance table in a reference-named state dict (0
    without one)."""
    for key in ("embedding_a.weight", "coarse.embedding_a.weight"):
        if key in state:
            return int(state[key].shape[0])
    return 0


# The names the JAX package's TorchScript mirror gives the reference
# modules (`mega_nerf_tpu/models/torch_nerf.py`), back to reference names.
_MIRROR_HEADS = {
    "sigma_head": "sigma",
    "trunk_final": "xyz_encoding_final",
    "rgb_head": "rgb",
    "appearance": "embedding_a",
    "affine": "affine",
}


def normalize_torchscript_keys(state: Dict) -> Dict:
    """A submodule state dict read from a TorchScript container -> reference
    names: the JAX package's mirror writes `trunk.{i}.*`, `sigma_head.*`,
    `dir_a.*`, ...; reference-named states pass through unchanged."""
    if not any(k.startswith("trunk.") for k in state):
        return state
    out = {}
    for k, v in state.items():
        if k.startswith("trunk."):
            _, i, p = k.split(".")
            out[f"xyz_encodings.{i}.0.{p}"] = v
        elif k.startswith("dir_a."):
            out[k.replace("dir_a.", "dir_a_encoding.0.")] = v
        else:
            head = k.split(".")[0]
            out[k.replace(head, _MIRROR_HEADS[head], 1)] = v
    return out
