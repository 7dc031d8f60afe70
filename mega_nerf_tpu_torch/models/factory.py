"""Model factory: build foreground/background NeRF bundles from hparams.

Counterpart of the JAX package's `models/factory.py` for a single NeRF or
the coarse/fine cascade (`--use_cascade`, `models/cascade.py`). Mega
mixtures (`--train_mega_nerf`, `--container_path`) are not ported yet and
raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from argparse import Namespace
from typing import Any, Dict, Optional, Union

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


@dataclasses.dataclass
class ModelBundle:
    """A NeRF module, or a coarse/fine `Cascade` of two, with their static
    config."""

    module: Union[NeRF, Cascade]
    config: NeRFConfig
    cascade: bool = False
    # Kernel-layout weights (render/fused_mlp.PackedMLP) by level, packed by
    # the renderer on first use (render/rendering.py::packed_params); reset
    # to None after changing the weights outside the optimizer.
    packed: Optional[Dict[str, Any]] = None

    def level(self, typ: str) -> NeRF:
        """The module that evaluates sampling level `typ` ("coarse" or
        "fine"): that level's under the cascade, else the one NeRF."""
        return self.module.level(typ) if self.cascade else self.module


def _make_bundle(hparams: Namespace, appearance_count: int, layer_dim: int,
                 xyz_dim: int) -> ModelBundle:
    for flag in ("container_path", "train_mega_nerf"):
        if getattr(hparams, flag, None) is not None:
            raise NotImplementedError(f"--{flag} (mega mixtures) is not ported yet")
    cfg = nerf_config_from_hparams(hparams, appearance_count, layer_dim, xyz_dim)
    if getattr(hparams, "use_cascade", False):
        return ModelBundle(module=Cascade(cfg), config=cfg, cascade=True)
    return ModelBundle(module=NeRF(cfg), config=cfg)


def make_nerf(hparams: Namespace, appearance_count: int) -> ModelBundle:
    """Foreground model (xyz_dim 3)."""
    return _make_bundle(
        hparams, appearance_count, getattr(hparams, "layer_dim", 256), 3
    )


def make_bg_nerf(hparams: Namespace, appearance_count: int) -> ModelBundle:
    """NeRF++ background model: xyz_dim 4 (unit-sphere point + inverse
    depth)."""
    return _make_bundle(
        hparams, appearance_count, getattr(hparams, "bg_layer_dim", 256), 4
    )
