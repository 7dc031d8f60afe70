"""Model factory: build foreground/background NeRF bundles from hparams.

Counterpart of the JAX package's `models/factory.py`: a single NeRF, the
coarse/fine cascade (`--use_cascade`, `models/cascade.py`), or a merged
Mega-NeRF mixture loaded from `--container_path` (`models/container.py`;
K NeRFs blended densely by `models/mega.py`, eval only). Joint mixture
training (`--train_mega_nerf`) and the routed mixture forms
(`--mega_routing routed|ray`, and `auto` past 32 submodules, where the JAX
package routes) raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from argparse import Namespace
from typing import Any, Dict, Optional, Union

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


# Mixtures of more submodules than this are routed by the JAX package under
# `--mega_routing auto` (its `ModelBundle.use_routed`).
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

    @property
    def is_mega(self) -> bool:
        return self.centroids is not None

    @property
    def eval_submodule_cost(self) -> int:
        """MLP evaluations per point at query time: K for the dense blend."""
        return int(self.centroids.shape[0]) if self.is_mega else 1

    def level(self, typ: str) -> NeRF:
        """The module that evaluates sampling level `typ` ("coarse" or
        "fine"): that level's under the cascade, else the one NeRF."""
        if self.is_mega:
            raise ValueError("a mixture has one NeRF per submodule (module[k])")
        return self.module.level(typ) if self.cascade else self.module


def check_mixture_route(routing: str, submodules: int) -> None:
    """Raise for the mixture forms the port does not run: the JAX package's
    routed forms can differ from the dense blend (they keep at most
    `routing_max_experts` submodules a point), so none runs dense here."""
    if routing in ("routed", "ray") or (routing == "auto"
                                        and submodules > AUTO_ROUTED_ABOVE):
        raise NotImplementedError(
            f"--mega_routing {routing} with {submodules} submodules: the routed "
            "mixture forms are not ported yet (ROADMAP.md A.3, routed mixtures); "
            "--mega_routing dense runs the dense blend")


def _make_bundle(hparams: Namespace, appearance_count: int, layer_dim: int,
                 xyz_dim: int) -> ModelBundle:
    if getattr(hparams, "train_mega_nerf", None) is not None:
        raise NotImplementedError(
            "--train_mega_nerf: joint mixture training is not ported yet "
            "(ROADMAP.md A.3, joint mixture training)")
    cfg = nerf_config_from_hparams(hparams, appearance_count, layer_dim, xyz_dim)
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
