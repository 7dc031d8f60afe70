"""Model layer: the NeRF MLP, the cascade, the Mega-NeRF mixture, their
factory and weight carry-over (merged containers: `models/container.py`)."""

from mega_nerf_tpu_torch.models.cascade import Cascade
from mega_nerf_tpu_torch.models.factory import (
    ModelBundle,
    make_bg_nerf,
    make_nerf,
    nerf_config_from_hparams,
)
from mega_nerf_tpu_torch.models.mega import (
    cluster_weights,
    mega_apply,
    mega_apply_ray_routed,
    mega_apply_routed,
    ray_route_capacity,
    ray_route_plan,
)
from mega_nerf_tpu_torch.models.nerf import (
    NeRF,
    NeRFConfig,
    frequency_encode,
    init_weights,
)
from mega_nerf_tpu_torch.models.weights import (
    flax_params_from_state,
    state_from_flax_params,
    strip_module_prefix,
)

__all__ = [
    "Cascade",
    "ModelBundle",
    "cluster_weights",
    "mega_apply",
    "mega_apply_ray_routed",
    "mega_apply_routed",
    "ray_route_capacity",
    "ray_route_plan",
    "make_bg_nerf",
    "make_nerf",
    "nerf_config_from_hparams",
    "NeRF",
    "NeRFConfig",
    "frequency_encode",
    "init_weights",
    "flax_params_from_state",
    "state_from_flax_params",
    "strip_module_prefix",
]
