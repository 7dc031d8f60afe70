"""torch-file IO: the dataset interchange formats are torch.save files.

The reference stores `coordinates.pt`, per-image metadata, cluster params
and masks as torch-serialized dicts and tensors. Loaded values are turned
into numpy at this boundary: host-side scene setup works in numpy, and the
renderer moves what it needs to its device explicitly.

Masks are single-entry zip archives whose member name equals the file name,
holding a torch-saved bool HxW tensor.
"""

from __future__ import annotations

import io
import zipfile
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch


def _to_numpy(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _to_torch(obj: Any) -> Any:
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj))
    if isinstance(obj, dict):
        return {k: _to_torch(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_torch(v) for v in obj)
    return obj


def load_pt(path) -> Any:
    """Load a torch.save file, converting all tensors to numpy."""
    return _to_numpy(torch.load(Path(path), map_location="cpu", weights_only=False))


def save_pt(obj: Any, path) -> None:
    """torch.save an object, converting numpy arrays to tensors first."""
    torch.save(_to_torch(obj), Path(path))


def load_mask_zip(path) -> np.ndarray:
    """Read a zip-compressed boolean mask tensor -> (H, W) bool numpy."""
    path = Path(path)
    with zipfile.ZipFile(path) as zf:
        with zf.open(path.name) as f:
            data = f.read()
    t = torch.load(io.BytesIO(data), map_location="cpu", weights_only=False)
    return t.numpy().astype(bool)


def save_mask_zip(mask: np.ndarray, path) -> None:
    """Write an (H, W) bool mask in the reference's zip(torch) format."""
    path = Path(path)
    buf = io.BytesIO()
    torch.save(torch.from_numpy(np.ascontiguousarray(mask)), buf)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(path.name, buf.getvalue())


def load_coordinates(dataset_path) -> Dict[str, Any]:
    """`coordinates.pt` -> {origin_drb: (3,) f64, pose_scale_factor: float}."""
    info = load_pt(Path(dataset_path) / "coordinates.pt")
    return {
        "origin_drb": np.asarray(info["origin_drb"], dtype=np.float64),
        "pose_scale_factor": float(info["pose_scale_factor"]),
    }
