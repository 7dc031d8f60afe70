"""Training checkpoints in the reference `{iter}.pt` layout.

`model_state_dict`, `bg_model_state_dict` (with a background model),
`iteration` and `optimizers: {"nerf", "bg_nerf"}` holding torch Adam state
dicts, as the reference trainer writes them. The JAX package reads this
layout (weights and Adam moments) and ignores any other key; the port's
`eval` reads its weights.

Two extra keys let a resumed run continue exactly where the saved one
was: `dataset_state: {"epoch", "batch_index"}` (the JAX package's names:
the epoch, which for the filesystem dataset is the chunk position, and the
last batch of it consumed) and `generator_state`, the sample generator's
`torch.Generator.get_state()`.
Written atomically: a temporary file in the same directory, then a rename.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import torch


def save_checkpoint(path, fg: torch.nn.Module, bg: Optional[torch.nn.Module],
                    optimizers: Dict, iteration: int, dataset_state: Dict[str, int],
                    generator_state: torch.Tensor) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = {
        "model_state_dict": fg.state_dict(),
        "iteration": int(iteration),
        "optimizers": optimizers,
        "dataset_state": {k: int(v) for k, v in dataset_state.items()},
        "generator_state": generator_state,
    }
    if bg is not None:
        state["bg_model_state_dict"] = bg.state_dict()
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path) -> Dict:
    """The saved dict, tensors on the CPU."""
    return torch.load(Path(path), map_location="cpu", weights_only=False)
