"""LPIPS perceptual distance (vgg16 / alexnet / squeezenet1_1), network code
only.

Port of the JAX package's `ops/lpips.py`, on torch convolutions:

    x in [0,1] -> 2x-1 -> ScalingLayer -> backbone features at the standard
    tap points -> channel-unit-normalize -> squared diff -> learned 1x1
    non-negative linear head per tap -> spatial mean -> sum over taps.

Weights load from one `.npz` per net, in the JAX package's format: keys are
the torchvision backbone state-dict names (`features.0.weight`, ...) plus
the LPIPS heads (`lin.{i}.weight`), shapes as `expected_keys(net)` says.
They come from `$MEGA_NERF_TPU_LPIPS_WEIGHTS`, else from this package's
`ops/lpips_weights/`. No pretrained weights ship with the repo; without a
file `load_available` finds none and `metrics.lpips` returns {}.

Backbone tap channels (match the lpips package):
    vgg:     relu1_2..relu5_3      -> [64, 128, 256, 512, 512]
    alex:    relu1..relu5          -> [64, 192, 384, 256, 256]
    squeeze: relu1 + fire outputs  -> [64, 128, 256, 384, 384, 512, 512]
"""

from __future__ import annotations

import os
import pickle
import warnings
import zipfile
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NETS = ("vgg", "alex", "squeeze")

# ScalingLayer constants from LPIPS (applied to images in [-1, 1]).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# Layer programs: ("conv", key, stride, pad), ("relu",), ("pool", k, s,
# ceil_mode), ("fire", prefix), ("tap",).
_VGG_PROGRAM: List[Tuple] = []
_relus = 0
for _idx in (0, 2, "pool", 5, 7, "pool", 10, 12, 14, "pool", 17, 19, 21,
             "pool", 24, 26, 28):
    if _idx == "pool":
        _VGG_PROGRAM.append(("pool", 2, 2, False))
        continue
    _VGG_PROGRAM += [("conv", f"features.{_idx}", 1, 1), ("relu",)]
    _relus += 1
    if _relus in (2, 4, 7, 10, 13):  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
        _VGG_PROGRAM.append(("tap",))

_ALEX_PROGRAM: List[Tuple] = [
    ("conv", "features.0", 4, 2), ("relu",), ("tap",),
    ("pool", 3, 2, False),
    ("conv", "features.3", 1, 2), ("relu",), ("tap",),
    ("pool", 3, 2, False),
    ("conv", "features.6", 1, 1), ("relu",), ("tap",),
    ("conv", "features.8", 1, 1), ("relu",), ("tap",),
    ("conv", "features.10", 1, 1), ("relu",), ("tap",),
]

_SQUEEZE_PROGRAM: List[Tuple] = [
    ("conv", "features.0", 2, 0), ("relu",), ("tap",),
    ("pool", 3, 2, True),
    ("fire", "features.3"), ("fire", "features.4"), ("tap",),
    ("pool", 3, 2, True),
    ("fire", "features.6"), ("fire", "features.7"), ("tap",),
    ("pool", 3, 2, True),
    ("fire", "features.9"), ("tap",),
    ("fire", "features.10"), ("tap",),
    ("fire", "features.11"), ("tap",),
    ("fire", "features.12"), ("tap",),
]

PROGRAMS: Dict[str, List[Tuple]] = {
    "vgg": _VGG_PROGRAM, "alex": _ALEX_PROGRAM, "squeeze": _SQUEEZE_PROGRAM,
}
TAP_CHANNELS: Dict[str, List[int]] = {
    "vgg": [64, 128, 256, 512, 512],
    "alex": [64, 192, 384, 256, 256],
    "squeeze": [64, 128, 256, 384, 384, 512, 512],
}


def _conv(x, weights, key: str, stride: int = 1, pad: int = 0):
    return F.conv2d(x, weights[f"{key}.weight"], weights[f"{key}.bias"],
                    stride=stride, padding=pad)


def _fire(x, weights, prefix: str):
    """SqueezeNet Fire: squeeze 1x1 -> relu -> [expand1x1, expand3x3] -> relu."""
    s = F.relu(_conv(x, weights, f"{prefix}.squeeze"))
    e1 = F.relu(_conv(s, weights, f"{prefix}.expand1x1"))
    e3 = F.relu(_conv(s, weights, f"{prefix}.expand3x3", pad=1))
    return torch.cat([e1, e3], dim=1)


def _features(net: str, weights, x) -> List[torch.Tensor]:
    """Run the backbone program on (B, 3, H, W) scaled images -> the taps."""
    taps = []
    for op in PROGRAMS[net]:
        if op[0] == "conv":
            x = _conv(x, weights, op[1], op[2], op[3])
        elif op[0] == "relu":
            x = F.relu(x)
        elif op[0] == "pool":
            x = F.max_pool2d(x, op[1], op[2], ceil_mode=op[3])
        elif op[0] == "fire":
            x = _fire(x, weights, op[1])
        else:
            taps.append(x)
    return taps


def _unit_normalize(x, eps: float = 1e-10):
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


def lpips_distance(net: str, weights: Dict[str, torch.Tensor],
                   img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """LPIPS(img0, img1) -> (B,); images are (B, 3, H, W) in [0, 1]. The
    convolutions run in float32 (cuDNN's TF32 mode off)."""
    shift = torch.tensor(_SHIFT, dtype=img0.dtype, device=img0.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, dtype=img0.dtype, device=img0.device).reshape(1, 3, 1, 1)
    with torch.backends.cudnn.flags(allow_tf32=False):
        taps0 = _features(net, weights, (2.0 * img0 - 1.0 - shift) / scale)
        taps1 = _features(net, weights, (2.0 * img1 - 1.0 - shift) / scale)
    total = torch.zeros(img0.shape[0], dtype=img0.dtype, device=img0.device)
    for i, (t0, t1) in enumerate(zip(taps0, taps1)):
        diff = (_unit_normalize(t0) - _unit_normalize(t1)) ** 2
        lin = weights[f"lin.{i}.weight"].reshape(1, -1, 1, 1)  # non-negative
        total = total + torch.mean(torch.sum(diff * lin, dim=1), dim=(1, 2))
    return total


# --------------------------------------------------------------------- weights

def expected_keys(net: str) -> Dict[str, Tuple[int, ...]]:
    """The key -> shape contract of a `{net}.npz` file: torchvision
    state-dict names plus the LPIPS heads."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def conv(key, o, i, k):
        shapes[f"{key}.weight"] = (o, i, k, k)
        shapes[f"{key}.bias"] = (o,)

    if net == "vgg":
        for idx, o, i in [(0, 64, 3), (2, 64, 64), (5, 128, 64), (7, 128, 128),
                          (10, 256, 128), (12, 256, 256), (14, 256, 256),
                          (17, 512, 256), (19, 512, 512), (21, 512, 512),
                          (24, 512, 512), (26, 512, 512), (28, 512, 512)]:
            conv(f"features.{idx}", o, i, 3)
    elif net == "alex":
        conv("features.0", 64, 3, 11)
        conv("features.3", 192, 64, 5)
        conv("features.6", 384, 192, 3)
        conv("features.8", 256, 384, 3)
        conv("features.10", 256, 256, 3)
    elif net == "squeeze":
        conv("features.0", 64, 3, 3)
        for idx, cin, sq, ex in [(3, 64, 16, 64), (4, 128, 16, 64),
                                 (6, 128, 32, 128), (7, 256, 32, 128),
                                 (9, 256, 48, 192), (10, 384, 48, 192),
                                 (11, 384, 64, 256), (12, 512, 64, 256)]:
            conv(f"features.{idx}.squeeze", sq, cin, 1)
            conv(f"features.{idx}.expand1x1", ex, sq, 1)
            conv(f"features.{idx}.expand3x3", ex, sq, 3)
    else:
        raise ValueError(net)

    for i, c in enumerate(TAP_CHANNELS[net]):
        shapes[f"lin.{i}.weight"] = (1, c, 1, 1)
    return shapes


def validate_weights(net: str, weights: Dict[str, torch.Tensor]) -> None:
    expected = expected_keys(net)
    missing = sorted(set(expected) - set(weights))
    if missing:
        raise ValueError(f"{net} weights missing keys: {missing[:5]}...")
    for k, shape in expected.items():
        if tuple(weights[k].shape) != shape:
            raise ValueError(f"{net} {k}: expected {shape}, got "
                             f"{tuple(weights[k].shape)}")


def default_weights_dir() -> Path:
    env = os.environ.get("MEGA_NERF_TPU_LPIPS_WEIGHTS")
    if env:
        return Path(env)
    return Path(__file__).parent / "lpips_weights"


class LPIPS:
    """LPIPS for one backbone, its weights on one device."""

    def __init__(self, net: str, weights: Dict[str, torch.Tensor]):
        validate_weights(net, weights)
        self.net = net
        self._weights = weights

    @classmethod
    def from_npz(cls, net: str, path, device=None) -> "LPIPS":
        with np.load(path) as z:
            weights = {k: torch.as_tensor(z[k], dtype=torch.float32, device=device)
                       for k in z.files}
        return cls(net, weights)

    def __call__(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """img0/img1: (H, W, 3) or (B, H, W, 3) in [0, 1] -> scalar or (B,)."""
        squeeze = img0.ndim == 3
        if squeeze:
            img0, img1 = img0[None], img1[None]
        with torch.no_grad():
            out = lpips_distance(self.net, self._weights,
                                 img0.float().permute(0, 3, 1, 2),
                                 img1.float().permute(0, 3, 1, 2))
        return out[0] if squeeze else out


def load_available(device=None) -> Dict[str, LPIPS]:
    """net -> LPIPS for every net whose `{net}.npz` is in
    `default_weights_dir()`. A corrupt or stale-contract file is skipped
    with a warning, so a long run keeps its other metrics."""
    d = default_weights_dir()
    out: Dict[str, LPIPS] = {}
    for net in NETS:
        path = d / f"{net}.npz"
        if not path.exists():
            continue
        try:
            out[net] = LPIPS.from_npz(net, path, device)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile,
                pickle.UnpicklingError, EOFError) as e:
            warnings.warn(f"lpips-{net} weights unusable ({type(e).__name__}: "
                          f"{e}); skipping this net")
    return out
