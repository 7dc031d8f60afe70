"""Coarse/fine cascade: two independent NeRF MLPs sharing one architecture.

Counterpart of the JAX package's `models/cascade.py` (`Cascade`). The two
levels are registered coarse first, so the state dict carries the
reference's `coarse.*` then `fine.*` keys and `parameters()` runs in that
order, the order in which the JAX package reads a torch Adam state
(`models/torch_interop.py::adam_state_from_torch_opt(..., cascade=True)`).
The renderer calls a level's module directly (`level(typ)`).
"""

from __future__ import annotations

import torch.nn as nn

from mega_nerf_tpu_torch.models.nerf import NeRF, NeRFConfig


class Cascade(nn.Module):
    def __init__(self, config: NeRFConfig):
        super().__init__()
        self.config = config
        self.coarse = NeRF(config)
        self.fine = NeRF(config)

    def level(self, typ: str) -> NeRF:
        """The module of sampling level `typ` ("coarse" or "fine")."""
        return {"coarse": self.coarse, "fine": self.fine}[typ]
