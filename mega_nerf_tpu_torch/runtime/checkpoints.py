"""Training checkpoints in the reference `{iter}.pt` layout, and a reader
for the weights of the JAX package's `.ckpt`.

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
past 2^30 bytes split into chunks).
Only its weights are used (`scripts/merge_submodules.py`): resuming
training from it needs its optax Adam state mapped to torch's.
"""

from __future__ import annotations

import os
import pickle
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

JAX_CHECKPOINT_MAGIC = b"MNTPU001"


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


def load_checkpoint(path) -> Dict:
    """The saved dict, tensors on the CPU. The JAX package's `.ckpt`
    raises: the port reads only its weights (`read_jax_checkpoint`)."""
    if is_jax_checkpoint(path):
        raise NotImplementedError(
            f"{path} is the JAX package's checkpoint: resuming or evaluating "
            "from it needs its optax Adam state mapped to torch's (ROADMAP.md "
            "A.5); scripts/merge_submodules.py reads its weights")
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
