"""Training checkpoints in the reference `{iter}.pt` layout, and the JAX
package's `.ckpt` read into that layout.

`model_state_dict`, `bg_model_state_dict` (with a background model),
`iteration` and `optimizers: {"nerf", "bg_nerf"}` holding torch Adam state
dicts, as the reference trainer writes them. The JAX package reads this
layout (weights and Adam moments) and ignores any other key; the port's
`eval` reads its weights.

Two extra keys let a resumed run continue exactly where the saved one
was: `dataset_state: {"epoch", "batch_index"}` (the JAX package's names:
the epoch, which for the filesystem dataset is the chunk position, and the
last batch of it consumed) and `generator_state`, the sample generator's
`torch.Generator.get_state()`. A cell of a grid run also records
`cell_index`, `num_cells` and `exp_prefix`.
Written atomically: a temporary file in the same directory, then a rename.

The JAX package's own format (`MNTPU001`: the magic, a `<QQ` header of the
two payload lengths, a flax msgpack tree of arrays, a pickled aux dict) is
read by `read_jax_checkpoint` with the small msgpack decoder below, which
covers the types flax writes for a train state (maps, arrays, strings,
bytes, numbers, nil, booleans; ext 1 ndarray and 3 numpy scalar; arrays
past 2^30 bytes split into chunks). `read_jax_train_state` maps its train
state into the `{iter}.pt` layout, so every entry point that takes
`--ckpt_path` resumes or evaluates from it:
- `fg_params` / `bg_params` -> the state dicts, through the reference
  names (`models/weights.py`): a cascade's two levels, a
  `--train_mega_nerf` mixture's K stacked submodules under `0.`, `1.`, ...;
- `fg_opt` / `bg_opt`, the state of optax's `adam(exponential_decay)`
  (`(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))`) ->
  torch Adam state dicts: mu and nu through the same names to `exp_avg`
  and `exp_avg_sq`, the count to every parameter's `step`. Each side keeps
  its own count (a skipped background step leaves the bg count behind
  fg's), and its schedule resumes at that count;
- the aux's `iteration` and `dataset_state`, and a grid cell's
  `cell_index`, `num_cells` and `exp_prefix`.
The run's flags give the models' structure: a leaf that is missing, extra,
or of another shape than they make raises a ValueError naming it. The
train state's jax PRNG `key` and the aux's numpy generator state have no
torch counterpart: a run resumed from a `.ckpt` draws its samples from a
generator seeded as in a fresh run.
"""

from __future__ import annotations

import os
import pickle
import struct
from argparse import Namespace
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from mega_nerf_tpu_torch.models.factory import ModelBundle, make_bg_nerf, make_nerf
from mega_nerf_tpu_torch.models.weights import flax_param_paths, state_from_flax_params
from mega_nerf_tpu_torch.parallel.cell_parallel import mixture_states_from_flax
from mega_nerf_tpu_torch.parallel.train_step import ADAM_BETAS, ADAM_EPS

JAX_CHECKPOINT_MAGIC = b"MNTPU001"
# What a `.ckpt` holds that a port run cannot take, for the line the
# runners print when they read one.
JAX_STATE_NOT_CARRIED = ("its jax PRNG key and numpy generator state do not "
                         "transfer: the sample generator starts from the seed")
_CELL_KEYS = ("cell_index", "num_cells", "exp_prefix")


def save_checkpoint(path, fg: torch.nn.Module, bg: Optional[torch.nn.Module],
                    optimizers: Dict, iteration: int, dataset_state: Dict[str, int],
                    generator_state: torch.Tensor,
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    """`extra` entries are stored as further top-level keys."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = {
        "model_state_dict": fg.state_dict(),
        "iteration": int(iteration),
        "optimizers": optimizers,
        "dataset_state": {k: int(v) for k, v in dataset_state.items()},
        "generator_state": generator_state,
        **(extra or {}),
    }
    if bg is not None:
        state["bg_model_state_dict"] = bg.state_dict()
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path, hparams: Optional[Namespace] = None,
                    appearance_count: Optional[int] = None) -> Dict:
    """The saved dict, tensors on the CPU. The JAX package's `.ckpt` comes
    back in the same layout (`read_jax_train_state`), which needs the run's
    `hparams`."""
    if is_jax_checkpoint(path):
        if hparams is None:
            raise ValueError(f"{path} is the JAX package's checkpoint: reading it "
                             "needs the run's flags, which give its models' structure")
        return read_jax_train_state(path, hparams, appearance_count)
    return torch.load(Path(path), map_location="cpu", weights_only=False)


def is_jax_checkpoint(path) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(JAX_CHECKPOINT_MAGIC)) == JAX_CHECKPOINT_MAGIC
    except OSError:
        return False


def read_jax_checkpoint(path) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A `.ckpt` of the JAX package -> (array tree as nested dicts of numpy
    arrays, aux dict). The train state's fields are top-level keys
    (`fg_params`, `bg_params`, `fg_opt`, ...)."""
    with open(path, "rb") as f:
        if f.read(len(JAX_CHECKPOINT_MAGIC)) != JAX_CHECKPOINT_MAGIC:
            raise ValueError(f"not a JAX package checkpoint: {path}")
        n_packed, n_aux = struct.unpack("<QQ", f.read(16))
        packed = f.read(n_packed)
        aux = f.read(n_aux)
    return _unchunk(msgpack_decode(packed, ext_hook=_flax_ext)), pickle.loads(aux)


def read_jax_train_state(path, hparams: Namespace,
                         appearance_count: Optional[int] = None) -> Dict:
    """A `.ckpt` -> the `{iter}.pt` layout (module docstring). `hparams` give
    the models (widths, heads, cascade; a `--train_mega_nerf` mixture's K
    from `hparams._mega_centroid_metadata`), with `appearance_count`
    embedding rows (default: the checkpoint's own); a background model is
    read where the checkpoint has one and the flags keep it."""
    arrays, aux = read_jax_checkpoint(path)
    if appearance_count is None:
        appearance_count = _embedding_rows(arrays["fg_params"])
    out: Dict[str, Any] = {
        "iteration": int(aux.get("iteration", 0)),
        "dataset_state": {k: int(v) for k, v in (aux.get("dataset_state") or {}).items()},
        "optimizers": {},
        **{k: aux[k] for k in _CELL_KEYS if k in aux},
    }
    sides = [("fg", "model_state_dict", "nerf", make_nerf)]
    if arrays.get("bg_params") is not None and getattr(hparams, "bg_nerf", True):
        sides.append(("bg", "bg_model_state_dict", "bg_nerf", make_bg_nerf))
    for side, state_key, opt_name, make in sides:
        with torch.device("meta"):  # the structure only: no weights allocated
            bundle = make(hparams, appearance_count)
        out[state_key] = _state_dict(arrays[f"{side}_params"], bundle,
                                     f"{path}: {side}_params")
        if arrays.get(f"{side}_opt") is not None:
            out["optimizers"][opt_name] = _adam_state_dict(
                arrays[f"{side}_opt"], bundle, hparams, f"{path}: {side}_opt")
    return out


def _embedding_rows(fg_params: Mapping) -> int:
    """Rows of the appearance table of a (cascade's fine, or stacked) fg
    params tree; 1 without one."""
    table = (fg_params.get("appearance") or fg_params.get("fine", {}).get("appearance")
             or {}).get("embedding")
    return 1 if table is None else int(np.shape(table)[-2])


def _leaves(tree, prefix: str = "") -> Dict[str, Any]:
    """'/'-joined path -> leaf of a nested mapping."""
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _state_dict(params: Mapping, bundle: ModelBundle, what: str) -> Dict[str, torch.Tensor]:
    """A Flax params tree (or a moment tree of the same layout) -> the
    bundle's state dict, in its order; raises a ValueError naming the
    first leaf that the bundle's structure or shapes do not take."""
    cfg = bundle.config
    paths = flax_param_paths(cfg, bundle.cascade)
    leaves = _leaves(params)
    hint = ("check that the model flags (--layers, --skip_layers, --layer_dim, "
            "--bg_layer_dim, --pos_xyz_dim, --pos_dir_dim, --appearance_dim, "
            "--affine_appearance, --use_cascade, --sh_deg, --train_mega_nerf) "
            "match the checkpoint")
    for path in paths:
        if path not in leaves:
            raise ValueError(f"{what} lack {path} ({paths[path]}), which this run's "
                             f"model has: {hint}")
    for path in leaves:
        if path not in paths:
            raise ValueError(f"{what} hold {path}, which this run's model has not: {hint}")
    if bundle.is_mega:
        k = len(bundle.module)
        for path, leaf in leaves.items():
            if np.ndim(leaf) == 0 or np.shape(leaf)[0] != k:
                raise ValueError(f"{what}: {path} ({paths[path]}) has shape "
                                 f"{np.shape(leaf)}, not {k} stacked submodules: {hint}")
        state = {f"{i}.{key}": v for i, sub in enumerate(
            mixture_states_from_flax(cfg, params, k, bundle.cascade)) for key, v in sub.items()}
    else:
        state = state_from_flax_params(cfg, params, bundle.cascade)
    want = bundle.module.state_dict()
    for key, value in want.items():
        if state[key].shape != value.shape:
            raise ValueError(f"{what}: {key} has shape {tuple(state[key].shape)}, this "
                             f"run's model {tuple(value.shape)}: {hint}")
    return {key: state[key] for key in want}


def _adam_state_dict(opt: Mapping, bundle: ModelBundle, hparams: Namespace,
                     what: str) -> Dict[str, Any]:
    """optax `adam(exponential_decay)` state, as flax serialises it
    (`{"0": {"count", "mu", "nu"}, "1": {"count"}}`) -> a torch Adam state
    dict over the bundle's parameters, in `named_parameters` order."""
    parts = list(opt.values()) if isinstance(opt, Mapping) else []
    adam = [p for p in parts if isinstance(p, Mapping) and {"count", "mu", "nu"} <= set(p)]
    if len(adam) != 1:
        raise ValueError(f"{what} is not the state of optax's adam: {sorted(opt)}")
    adam = adam[0]
    count = int(adam["count"])
    for part in parts:
        if isinstance(part, Mapping) and set(part) == {"count"} and int(part["count"]) != count:
            raise ValueError(f"{what}: the schedule's count {int(part['count'])} differs "
                             f"from Adam's {count}; a torch schedule follows Adam's step")
    names = [name for name, _ in bundle.module.named_parameters()]
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    if count > 0:  # torch keeps no state before an optimizer's first step
        mu = _state_dict(adam["mu"], bundle, f"{what} mu")
        nu = _state_dict(adam["nu"], bundle, f"{what} nu")
        state = {i: {"step": torch.tensor(float(count), dtype=torch.float32),
                     "exp_avg": mu[name], "exp_avg_sq": nu[name]}
                 for i, name in enumerate(names)}
    # This torch version's Adam hyperparameter keys, as a port run saves them.
    group = torch.optim.Adam([torch.zeros(1, requires_grad=True)], lr=hparams.lr,
                             betas=ADAM_BETAS, eps=ADAM_EPS).state_dict()["param_groups"][0]
    group.update(params=list(range(len(names))), initial_lr=hparams.lr,
                 lr=hparams.lr * hparams.lr_decay_factor ** (count / hparams.train_iterations))
    return {"state": state, "param_groups": [group]}


# ------------------------------------------------------------------ msgpack

def msgpack_decode(data: bytes, ext_hook=None) -> Any:
    """Decode one msgpack object; `ext_hook(code, payload)` decodes ext
    types (else they come back as (code, payload))."""
    obj, end = _decode(memoryview(data), 0, ext_hook)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} trailing bytes")
    return obj


_FIXED = {  # tag -> (struct format, size)
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}


def _decode(buf: memoryview, pos: int, ext_hook):
    tag = buf[pos]
    pos += 1
    if tag <= 0x7f:
        return tag, pos
    if tag >= 0xe0:
        return tag - 0x100, pos
    if 0x80 <= tag <= 0x8f:
        return _map(buf, pos, tag & 0x0f, ext_hook)
    if 0x90 <= tag <= 0x9f:
        return _array(buf, pos, tag & 0x0f, ext_hook)
    if 0xa0 <= tag <= 0xbf:
        return _str(buf, pos, tag & 0x1f)
    if tag == 0xc0:
        return None, pos
    if tag in (0xc2, 0xc3):
        return tag == 0xc3, pos
    if tag in _FIXED:
        fmt, size = _FIXED[tag]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if tag in (0xc4, 0xc5, 0xc6, 0xd9, 0xda, 0xdb, 0xdc, 0xdd, 0xde, 0xdf):
        size = {0xc4: 1, 0xc5: 2, 0xc6: 4, 0xd9: 1, 0xda: 2, 0xdb: 4,
                0xdc: 2, 0xdd: 4, 0xde: 2, 0xdf: 4}[tag]
        n = struct.unpack_from(_LENGTH[size], buf, pos)[0]
        pos += size
        if tag <= 0xc6:
            return bytes(buf[pos:pos + n]), pos + n
        if tag <= 0xdb:
            return _str(buf, pos, n)
        if tag <= 0xdd:
            return _array(buf, pos, n, ext_hook)
        return _map(buf, pos, n, ext_hook)
    if 0xd4 <= tag <= 0xd8 or tag in (0xc7, 0xc8, 0xc9):
        if tag >= 0xd4:
            n = 1 << (tag - 0xd4)
        else:
            size = {0xc7: 1, 0xc8: 2, 0xc9: 4}[tag]
            n = struct.unpack_from(_LENGTH[size], buf, pos)[0]
            pos += size
        code = struct.unpack_from(">b", buf, pos)[0]
        payload = bytes(buf[pos + 1:pos + 1 + n])
        pos += 1 + n
        return (ext_hook(code, payload) if ext_hook else (code, payload)), pos
    raise ValueError(f"msgpack: unknown tag 0x{tag:02x}")


def _str(buf, pos, n):
    return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n


def _array(buf, pos, n, ext_hook):
    out = []
    for _ in range(n):
        item, pos = _decode(buf, pos, ext_hook)
        out.append(item)
    return out, pos


def _map(buf, pos, n, ext_hook):
    out = {}
    for _ in range(n):
        key, pos = _decode(buf, pos, ext_hook)
        value, pos = _decode(buf, pos, ext_hook)
        out[key] = value
    return out, pos


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's ndarray payload: msgpack (shape, dtype name, C-order bytes)."""
    shape, dtype_name, buffer = msgpack_decode(payload)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def _flax_ext(code: int, payload: bytes):
    if code == 1:
        return _ndarray(payload)
    if code == 3:
        return _ndarray(payload)[()]
    raise ValueError(f"msgpack: ext type {code} is not one flax writes for a train state")


def _unchunk(tree):
    """flax splits arrays past 2^30 bytes into `__msgpack_chunked_array__`
    maps; join them back."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}
