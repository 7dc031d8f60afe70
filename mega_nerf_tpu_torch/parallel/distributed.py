"""The processes of a multi-process run: `torch.distributed` set up from
torchrun's environment.

Counterpart of the process queries the JAX package spreads over
`parallel/mesh.py` and `runtime/logging.py` (`jax.process_index()`,
`jax.process_count()`, `is_master`, `main_print`, `sync_processes`). The
port has one device per process, not a device mesh:

- `init_from_env(device)` reads `RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
  `MASTER_ADDR` and `MASTER_PORT` (what `torchrun` sets) and joins the
  process group. Without `WORLD_SIZE` above 1 there is one process and no
  group, and every function here answers for one process.
- A rank's device is `cuda:{LOCAL_RANK % device_count}` (the CPU under
  `--device cpu`). NCCL refuses two ranks on one card, so NCCL is the
  backend only when every local rank has a card of its own; ranks that
  share a card, or run on the CPU, use gloo. gloo reduces and broadcasts
  CUDA tensors but gathers none: gathers here go through pickled objects.
- `cell_groups(C, D)` makes the C groups of D consecutive ranks of a cell x
  data layout (every rank takes part in making every group) and returns
  this rank's.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_backend: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Group:
    """A set of ranks that reduce together: `handle` is the process group
    (None: the whole world), `index` this rank's place in it."""

    handle: Any
    size: int
    index: int


def init_from_env(device: str = "cuda") -> torch.device:
    """Join the process group torchrun's environment describes (once a
    process); -> this rank's device for `device` ('cuda' or 'cpu')."""
    global _backend
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        rank_ = int(os.environ["RANK"])
        if "MASTER_PORT" not in os.environ:
            raise RuntimeError(
                f"WORLD_SIZE={world} without MASTER_PORT: start the ranks with "
                "torchrun, or set MASTER_ADDR and MASTER_PORT")
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ["MASTER_PORT"]
        kind = torch.device(device).type
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if kind == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda was asked for but no CUDA device is available "
                "(pass --device cpu to run on the CPU)")
        own_card = kind == "cuda" and local_world <= torch.cuda.device_count()
        _backend = "nccl" if own_card else "gloo"
        if kind == "cuda":
            torch.cuda.set_device(rank_device(device))
        dist.init_process_group(_backend, init_method=f"tcp://{addr}:{port}",
                                world_size=world, rank=rank_)
        atexit.register(dist.destroy_process_group)
        main_print(f"torch.distributed: {world} ranks, backend {_backend}"
                   + ("" if own_card or kind != "cuda" else
                      f" ({local_world} ranks share "
                      f"{torch.cuda.device_count()} card(s))"))
    return rank_device(device)


def backend() -> Optional[str]:
    """The process group's backend (None with one process)."""
    return _backend if dist.is_initialized() else None


def rank_device(name: str) -> torch.device:
    """`name` -> this rank's device: a bare 'cuda' becomes
    `cuda:{LOCAL_RANK % device_count}`."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        device = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return device


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", rank())))


def is_master() -> bool:
    return rank() == 0


def main_print(*args) -> None:
    if is_master():
        print(*args, flush=True)


def barrier(tag: str) -> None:
    """Every rank reaches `tag` before any goes on (no-op with one
    process); used around rank-0-only filesystem work."""
    del tag  # names the call site for the reader
    if dist.is_initialized():
        dist.barrier()


def all_gather_object(obj) -> List:
    """-> every rank's `obj`, in rank order."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj, src: int = 0):
    """-> rank `src`'s `obj` on every rank."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def rank_seed(seed: int, rank: int) -> int:
    """Rank `rank`'s sample-generator seed: `seed` itself on rank 0 (a
    one-process run's), a 63-bit draw of (seed, rank) on the others, so no
    two ranks draw the same perturbation and noise for their rows."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence((seed, rank)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def world_group() -> Optional[Group]:
    """The data group of a data-parallel run: every rank (None with one
    process)."""
    if world_size() == 1:
        return None
    return Group(None, world_size(), rank())


def cell_groups(cell_axis: int, data_axis: int) -> Optional[Group]:
    """Make the `cell_axis` groups of `data_axis` consecutive ranks (group g
    holds ranks g*D .. g*D + D-1) -> this rank's, or None when it has one
    rank. Every rank must call this, with the same layout."""
    if world_size() != cell_axis * data_axis:
        raise ValueError(f"{cell_axis} x {data_axis} groups need {cell_axis * data_axis} "
                         f"ranks, not {world_size()}")
    mine = None
    for g in range(cell_axis):
        ranks = list(range(g * data_axis, (g + 1) * data_axis))
        handle = dist.new_group(ranks) if dist.is_initialized() else None
        if rank() in ranks:
            mine = Group(handle, data_axis, rank() - ranks[0])
    return mine if data_axis > 1 else None


def all_reduce_(tensor: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Sum `tensor` in place over `group` (the world when its handle is
    None); -> tensor."""
    if group is not None and group.size > 1:
        dist.all_reduce(tensor, group=group.handle)
    return tensor


def broadcast_tensors_(tensors: Sequence[torch.Tensor], src: int) -> None:
    """Overwrite `tensors` on every rank with rank `src`'s (world group)."""
    if not dist.is_initialized():
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src)
