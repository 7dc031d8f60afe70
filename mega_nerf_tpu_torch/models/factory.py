"""Model factory: build foreground/background NeRF bundles from hparams.

Counterpart of the JAX package's `models/factory.py`: a single NeRF, the
coarse/fine cascade (`--use_cascade`, `models/cascade.py`), a merged
Mega-NeRF mixture loaded from `--container_path` (`models/container.py`),
or the mixture of `--train_mega_nerf` (its centroid metadata on
`hparams._mega_centroid_metadata`: K fresh NeRFs, hard assignment, trained
jointly). A mixture blends its K NeRFs by `models/mega.py`: densely, per
point routed (`--mega_routing routed`, and `auto` past 32 submodules) or per
ray routed (`--mega_routing ray`, where the Runner gives per-ray supports).
"""

from __future__ import annotations

import dataclasses
from argparse import Namespace
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from mega_nerf_tpu_torch.models.cascade import Cascade
from mega_nerf_tpu_torch.models.nerf import NeRF, NeRFConfig


def nerf_config_from_hparams(
    hparams: Namespace, appearance_count: int, layer_dim: int, xyz_dim: int
) -> NeRFConfig:
    sh_deg = getattr(hparams, "sh_deg", None)
    rgb_dim = 3 * ((sh_deg + 1) ** 2) if sh_deg is not None else 3
    return NeRFConfig(
        pos_xyz_dim=getattr(hparams, "pos_xyz_dim", 12),
        pos_dir_dim=getattr(hparams, "pos_dir_dim", 4),
        layers=getattr(hparams, "layers", 8),
        skip_layers=tuple(getattr(hparams, "skip_layers", (4,))),
        layer_dim=layer_dim,
        appearance_dim=getattr(hparams, "appearance_dim", 48),
        affine_appearance=getattr(hparams, "affine_appearance", False),
        appearance_count=appearance_count,
        rgb_dim=rgb_dim,
        xyz_dim=xyz_dim,
        shifted_softplus=getattr(hparams, "shifted_softplus", True),
        compute_dtype=getattr(hparams, "compute_dtype", "float32"),
        ref_packed_dirs=getattr(hparams, "ref_packed_dirs", False),
    )


# `--mega_routing auto` routes mixtures of more submodules than this per
# point, as the JAX package's `ModelBundle.use_routed` does.
AUTO_ROUTED_ABOVE = 32


@dataclasses.dataclass
class ModelBundle:
    """A NeRF module, a coarse/fine `Cascade` of two, or a Mega-NeRF
    mixture of K NeRFs (`module` an `nn.ModuleList`, `centroids` set), with
    their static config (each submodule's)."""

    module: Union[NeRF, Cascade, nn.ModuleList]
    config: NeRFConfig
    cascade: bool = False
    # Kernel-layout weights (render/fused_mlp.PackedMLP) by level or
    # submodule, packed by the renderer on first use
    # (render/rendering.py::packed_params); reset to None after changing the
    # weights outside the optimizer.
    packed: Optional[Dict[Any, Any]] = None
    # Mixture routing: (K, 3) centroids, the blend margin (1 = one-hot),
    # 1 to route on the two horizontal axes only (cluster_2d), and whether
    # the input carries the real-world routing coordinates first
    # (xyz_real: [routing xyz (3) | model input]; the background's).
    centroids: Optional[torch.Tensor] = None
    boundary_margin: float = 1.0
    cluster_dim_start: int = 0
    xyz_real: bool = False
    routing: str = "auto"
    routing_max_experts: int = 4
    # Rows each submodule evaluated in each routed pass (points, or rays
    # under ray routing), appended while this is a list.
    route_log: Optional[List[List[int]]] = None

    @property
    def is_mega(self) -> bool:
        return self.centroids is not None

    @property
    def use_routed(self) -> bool:
        """Per-point routed blend (`mega_apply_routed`): `routed`, or `auto`
        past `AUTO_ROUTED_ABOVE` submodules."""
        if not self.is_mega:
            return False
        if self.routing == "auto":
            return int(self.centroids.shape[0]) > AUTO_ROUTED_ABOVE
        return self.routing == "routed"

    @property
    def use_ray_routed(self) -> bool:
        """Ray-routed serving (`mega_apply_ray_routed`): the Runner builds
        the per-ray supports; elsewhere the blend stays dense."""
        return self.is_mega and self.routing == "ray"

    @property
    def max_experts(self) -> int:
        """Submodules a point keeps under the routed blend: 1 at margin 1."""
        return 1 if self.boundary_margin == 1 else int(self.routing_max_experts)

    @property
    def eval_submodule_cost(self) -> int:
        """MLP evaluations per point at query time: min(M, K) routed, else K."""
        if not self.is_mega:
            return 1
        k = int(self.centroids.shape[0])
        return min(self.max_experts, k) if self.use_routed else k

    def to(self, device) -> "ModelBundle":
        """Move the module, and a mixture's centroids (read by every routed
        or blended pass), to `device`."""
        self.module.to(device)
        if self.centroids is not None:
            self.centroids = self.centroids.to(device)
        return self

    def level(self, typ: str) -> NeRF:
        """The module that evaluates sampling level `typ` ("coarse" or
        "fine"): that level's under the cascade, else the one NeRF."""
        if self.is_mega:
            raise ValueError("a mixture has one NeRF per submodule (module[k])")
        return self.module.level(typ) if self.cascade else self.module


def _make_bundle(hparams: Namespace, appearance_count: int, layer_dim: int,
                 xyz_dim: int) -> ModelBundle:
    cfg = nerf_config_from_hparams(hparams, appearance_count, layer_dim, xyz_dim)
    meta = getattr(hparams, "_mega_centroid_metadata", None)
    if meta is not None:
        # Joint mixture training (--train_mega_nerf): K NeRFs, hard
        # assignment; a background mixture routes on the real-world
        # coordinates its input carries first.
        centroids = torch.as_tensor(np.asarray(meta["centroids"], np.float32))
        return ModelBundle(
            module=nn.ModuleList(NeRF(cfg) for _ in range(centroids.shape[0])),
            config=cfg, centroids=centroids, boundary_margin=1.0,
            cluster_dim_start=1 if bool(meta["cluster_2d"]) else 0,
            xyz_real=xyz_dim == 4, routing=getattr(hparams, "mega_routing", "auto"),
            routing_max_experts=getattr(hparams, "routing_max_experts", 4))
    if getattr(hparams, "use_cascade", False):
        return ModelBundle(module=Cascade(cfg), config=cfg, cascade=True)
    return ModelBundle(module=NeRF(cfg), config=cfg)


def container_bundles(hparams: Namespace):
    """The (fg, bg or None) mixtures of `--container_path`, loaded once and
    cached on hparams."""
    cached = getattr(hparams, "_container_bundles", None)
    if cached is None:
        from mega_nerf_tpu_torch.models.container import (
            container_to_bundles,
            load_container,
        )

        cached = container_to_bundles(load_container(hparams.container_path), hparams)
        hparams._container_bundles = cached
    return cached


def make_nerf(hparams: Namespace, appearance_count: int) -> ModelBundle:
    """Foreground model (xyz_dim 3), or the container's fg mixture."""
    if getattr(hparams, "container_path", None) is not None:
        return container_bundles(hparams)[0]
    return _make_bundle(
        hparams, appearance_count, getattr(hparams, "layer_dim", 256), 3
    )


def make_bg_nerf(hparams: Namespace, appearance_count: int) -> ModelBundle:
    """NeRF++ background model: xyz_dim 4 (unit-sphere point + inverse
    depth), or the container's bg mixture."""
    if getattr(hparams, "container_path", None) is not None:
        bg = container_bundles(hparams)[1]
        if bg is None:
            raise ValueError("container has no background submodules")
        return bg
    return _make_bundle(
        hparams, appearance_count, getattr(hparams, "bg_layer_dim", 256), 4
    )
