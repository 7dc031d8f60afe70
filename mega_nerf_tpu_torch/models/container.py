"""Merged Mega-NeRF container: save and load, in two formats.

Counterpart of the JAX package's `models/container.py`. A container holds K
foreground (and optionally K background) submodule state dicts under the
reference's parameter names, with the routing metadata: centroids,
grid_dim, min/max position, need_viewdir, need_appearance_embedding,
cluster_2d.

- **Native**: `torch.save` of a dict of numpy arrays tagged with
  `NATIVE_FORMAT`, the same string and layout as the JAX package's, so a
  container written by either package loads in the other.
- **TorchScript**: the viewer's format (`torch.jit.save` of a module with
  `sub_module_{i}` / `bg_sub_module_{i}` children and the metadata as
  attributes). The port writes its children as `models/torch_nerf.py`
  mirrors under reference names; it reads reference-named children and the
  JAX package's mirror names (`weights.normalize_torchscript_keys`).

`load_container` sniffs the format; `container_to_bundles` builds the fg
and bg mixtures (`ModelBundle` with K NeRFs) holding the weights.
"""

from __future__ import annotations

import dataclasses
import zipfile
from argparse import Namespace
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mega_nerf_tpu_torch.models.factory import (
    ModelBundle,
    nerf_config_from_hparams,
)
from mega_nerf_tpu_torch.models.nerf import NeRF, NeRFConfig
from mega_nerf_tpu_torch.models.torch_nerf import torch_nerf_from_state
from mega_nerf_tpu_torch.models.weights import (
    appearance_count_from_state,
    normalize_torchscript_keys,
    state_keys,
)

NATIVE_FORMAT = "mega_nerf_tpu_container_v1"


@dataclasses.dataclass
class ContainerData:
    centroids: np.ndarray  # (K, 3)
    grid_dim: Tuple[int, int]
    min_position: np.ndarray
    max_position: np.ndarray
    need_viewdir: bool
    need_appearance_embedding: bool
    cluster_2d: bool
    fg_states: List[Dict[str, np.ndarray]]  # reference-named numpy state dicts
    bg_states: List[Dict[str, np.ndarray]]


def save_native_container(path, data: ContainerData) -> None:
    payload = {
        "format": NATIVE_FORMAT,
        "centroids": np.asarray(data.centroids, np.float32),
        "grid_dim": list(data.grid_dim),
        "min_position": np.asarray(data.min_position, np.float32),
        "max_position": np.asarray(data.max_position, np.float32),
        "need_viewdir": data.need_viewdir,
        "need_appearance_embedding": data.need_appearance_embedding,
        "cluster_2d": data.cluster_2d,
        "fg_states": data.fg_states,
        "bg_states": data.bg_states,
    }
    torch.save(payload, Path(path))


def mixture_config(data: ContainerData, hparams: Namespace, states, xyz_dim: int,
                   layer_dim: int) -> NeRFConfig:
    """The submodules' architecture: the command line's, with the
    container's appearance table size, and without view directions or
    appearance where the container says it has none (its own flags win
    over the command line's defaults)."""
    count = max((appearance_count_from_state(s) for s in states), default=0)
    cfg = nerf_config_from_hparams(hparams, count or 1, layer_dim, xyz_dim)
    overrides = {}
    if not data.need_viewdir and cfg.pos_dir_dim > 0:
        overrides["pos_dir_dim"] = 0
    if not data.need_appearance_embedding and cfg.appearance_dim > 0:
        overrides["appearance_dim"] = 0
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _sides(data: ContainerData, hparams: Namespace):
    """(child name prefix, reference-named states, xyz_dim, layer_dim) of
    the fg and the bg submodules."""
    return (("sub_module_", [normalize_torchscript_keys(s) for s in data.fg_states], 3,
             getattr(hparams, "layer_dim", 256)),
            ("bg_sub_module_", [normalize_torchscript_keys(s) for s in data.bg_states], 4,
             getattr(hparams, "bg_layer_dim", 256)))


def save_torchscript_container(path, data: ContainerData, hparams: Namespace) -> None:
    """The viewer's format: one scripted module whose children are
    `TorchNeRF` mirrors of the submodules."""
    centroids = torch.from_numpy(np.asarray(data.centroids, np.float32))
    min_position = torch.from_numpy(np.asarray(data.min_position, np.float32))
    max_position = torch.from_numpy(np.asarray(data.max_position, np.float32))

    class Container(nn.Module):
        def __init__(self):
            super().__init__()
            for prefix, states, xyz_dim, width in _sides(data, hparams):
                if not states:
                    continue
                cfg = mixture_config(data, hparams, states, xyz_dim, width)
                for i, st in enumerate(states):
                    own = {key: st[key] for key in state_keys(cfg)}
                    setattr(self, f"{prefix}{i}", torch_nerf_from_state(cfg, own))
            self.centroids = centroids
            self.grid_dim = torch.IntTensor(list(data.grid_dim))
            self.min_position = min_position
            self.max_position = max_position
            self.need_viewdir = data.need_viewdir
            self.need_appearance_embedding = data.need_appearance_embedding
            self.cluster_2d = data.cluster_2d

    torch.jit.save(torch.jit.script(Container().eval()), str(path))


def _is_torchscript(path: Path) -> bool:
    """A TorchScript archive is a zip holding `constants.pkl`, which a
    `torch.save` file does not."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as zf:
        return any(name.endswith("/constants.pkl") for name in zf.namelist())


def load_container(path) -> ContainerData:
    """Load a native or a TorchScript container."""
    path = Path(path)
    if not _is_torchscript(path):
        payload = torch.load(path, map_location="cpu", weights_only=False)
        if not (isinstance(payload, dict) and payload.get("format") == NATIVE_FORMAT):
            raise ValueError(f"{path} is not a merged container")
        return ContainerData(
            centroids=np.asarray(payload["centroids"], np.float32),
            grid_dim=tuple(payload["grid_dim"]),
            min_position=np.asarray(payload["min_position"], np.float32),
            max_position=np.asarray(payload["max_position"], np.float32),
            need_viewdir=bool(payload["need_viewdir"]),
            need_appearance_embedding=bool(payload["need_appearance_embedding"]),
            cluster_2d=bool(payload["cluster_2d"]),
            fg_states=payload["fg_states"],
            bg_states=payload["bg_states"],
        )

    container = torch.jit.load(str(path), map_location="cpu")
    k = container.centroids.shape[0]

    def states(prefix: str) -> List[Dict[str, np.ndarray]]:
        out = []
        for i in range(k):
            if not hasattr(container, f"{prefix}{i}"):
                break
            module = getattr(container, f"{prefix}{i}")
            out.append({key: val.detach().numpy()
                        for key, val in module.state_dict().items()})
        return out

    return ContainerData(
        centroids=container.centroids.numpy(),
        grid_dim=tuple(int(x) for x in container.grid_dim),
        min_position=container.min_position.numpy(),
        max_position=container.max_position.numpy(),
        need_viewdir=bool(container.need_viewdir),
        need_appearance_embedding=bool(container.need_appearance_embedding),
        cluster_2d=bool(container.cluster_2d),
        fg_states=states("sub_module_"),
        bg_states=states("bg_sub_module_"),
    )


def container_to_bundles(data: ContainerData, hparams: Namespace
                         ) -> Tuple[ModelBundle, Optional[ModelBundle]]:
    """ContainerData -> (fg mixture, bg mixture or None), each a
    `ModelBundle` of K NeRFs holding the container's weights. The
    container's own need_viewdir / need_appearance_embedding win over the
    command line's defaults."""
    routing = getattr(hparams, "mega_routing", "auto")

    bundles = []
    for _, states, xyz_dim, layer_dim in _sides(data, hparams):
        if not states:
            bundles.append(None)
            continue
        cfg = mixture_config(data, hparams, states, xyz_dim, layer_dim)
        subs = nn.ModuleList()
        for s in states:
            sub = NeRF(cfg)
            sub.load_state_dict({key: torch.tensor(np.asarray(s[key], np.float32))
                                 for key in state_keys(cfg)})
            subs.append(sub.eval())
        bundles.append(ModelBundle(
            module=subs, config=cfg,
            centroids=torch.as_tensor(np.asarray(data.centroids, np.float32)),
            boundary_margin=getattr(hparams, "boundary_margin", 1.15),
            cluster_dim_start=1 if data.cluster_2d else 0,
            xyz_real=xyz_dim == 4, routing=routing,
            routing_max_experts=getattr(hparams, "routing_max_experts", 4)))
    return bundles[0], bundles[1]
