"""Analytic scenes written in the reference's dataset layout.

Counterpart of the JAX package's `tests/synthetic.py` scene builders, which
the convergence workflows (`scripts/convergence_run.py`,
`scripts/cell_convergence_run.py`, `scripts/cell_diagnostics.py`) train on
and score against:

- the ring: two opaque balls inside a colored shell, photographed by
  cameras on a ring around them (`make_synthetic_dataset`,
  `scene_density_color`);
- the drone survey: a textured ground plane with box "buildings", seen by
  a jittered lattice of oblique cameras above it (`make_drone_dataset`,
  `drone_density_color`), the geometry Mega-NeRF targets.

Each view is rendered from the analytic density and color with the port's
ray model (`ops/rays.py`) and compositing (`ops/compositing.py`), on
`device` (the card unless the caller passes "cpu"). The files are
`coordinates.pt`, `{train,val}/metadata/*.pt` and `{train,val}/rgbs/*.png`;
`coordinates.pt` is written last, as the marker of a built dataset.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from mega_nerf_tpu_torch.data.torch_io import save_pt
from mega_nerf_tpu_torch.ops.compositing import composite_weights
from mega_nerf_tpu_torch.ops.rays import get_ray_directions, get_rays
from mega_nerf_tpu_torch.runtime.runner import resolve_device

BALL_RADIUS = 0.35
BALL_COLOR = (0.85, 0.3, 0.1)
BALL2_CENTER = (0.15, 0.3, 0.0)
BALL2_RADIUS = 0.18
BALL2_COLOR = (0.2, 0.5, 0.9)
# Enclosing opaque shell: every ray ends on colored geometry, as in a
# photographed scene (a mostly black void lets a small NeRF settle at zero
# density).
SHELL_RADIUS = 1.8

SceneFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def look_at_drb(position: np.ndarray) -> np.ndarray:
    """c2w (3, 4) for a camera at `position` looking at the origin.

    DRB world: x down. Camera frame: x right, y up, z backward (-z forward).
    """
    return _look_at_drb_from(position, -position)


def scene_density_color(pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ring scene (two balls inside a colored shell): points (..., 3)
    -> (sigma (...), rgb (..., 3))."""
    d1 = torch.linalg.norm(pts, dim=-1)
    d2 = torch.linalg.norm(pts - _const(BALL2_CENTER, pts), dim=-1)
    in1 = d1 < BALL_RADIUS
    in2 = d2 < BALL2_RADIUS
    in_shell = d1 > SHELL_RADIUS
    sigma = torch.where(in1 | in2 | in_shell, 1e4, 0.0).to(pts.dtype)
    # A smooth position-dependent shell color, so every view is informative.
    shell_rgb = 0.55 + 0.35 * torch.sin(pts * _const((2.0, 3.0, 5.0), pts)
                                        + _const((0.0, 1.0, 2.0), pts))
    rgb = torch.where(
        in2[..., None], _const(BALL2_COLOR, pts),
        torch.where(in1[..., None], _const(BALL_COLOR, pts), shell_rgb))
    return sigma, rgb


def render_gt_image(c2w: np.ndarray, w: int, h: int, intrinsics, near: float,
                    far: float, samples: int = 256, scene_fn: Optional[SceneFn] = None,
                    device="cuda") -> np.ndarray:
    """One view of an analytic scene, composited over `samples` evenly
    spaced depths from `near` to `far` -> (h, w, 3) float32."""
    scene_fn = scene_fn or scene_density_color
    device = resolve_device(str(device))
    dirs = get_ray_directions(w, h, *[float(x) for x in intrinsics], True, device=device)
    rays = get_rays(dirs, torch.as_tensor(np.asarray(c2w, np.float32), device=device),
                    near, far).reshape(-1, 8)
    o, d = rays[:, :3], rays[:, 3:6]
    z = torch.from_numpy(
        near + (far - near) * np.linspace(0, 1, samples, dtype=np.float32)).to(device)
    pts = o[:, None] + d[:, None] * z[None, :, None]
    sigma, rgb = scene_fn(pts)
    cw = composite_weights(sigma, z.expand(sigma.shape),
                           torch.full(sigma.shape[:1], 1e10, device=device))
    img = torch.sum(cw.weights[..., None] * rgb, dim=1)
    return img.cpu().numpy().reshape(h, w, 3)


def _write_view(root: Path, split: str, i: int, w: int, h: int,
                intrinsics: np.ndarray, c2w: np.ndarray, img: np.ndarray) -> None:
    from PIL import Image

    (root / split / "metadata").mkdir(parents=True, exist_ok=True)
    (root / split / "rgbs").mkdir(parents=True, exist_ok=True)
    stem = f"{i:06d}"
    save_pt({"W": w, "H": h, "intrinsics": intrinsics, "c2w": c2w},
            root / split / "metadata" / f"{stem}.pt")
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
        root / split / "rgbs" / f"{stem}.png")


def _write_coordinates(root: Path) -> None:
    """coordinates.pt, written last: callers take it as the marker of a
    built dataset, so a run killed mid-build leaves none."""
    save_pt({"origin_drb": np.zeros(3, np.float64), "pose_scale_factor": 1.0},
            root / "coordinates.pt")


def make_synthetic_dataset(root, n_train: int = 6, n_val: int = 1, hw=(24, 24),
                           camera_distance: float = 1.5, device="cuda") -> Path:
    """The ring scene: `n_train + n_val` cameras on a ring at
    `camera_distance`, the last `n_val` held out."""
    root = Path(root)
    h, w = hw
    focal = 0.9 * w
    intrinsics = np.array([focal, focal, w / 2, h / 2], np.float32)
    near, far = 0.5, 3.5
    root.mkdir(parents=True, exist_ok=True)

    n_total = n_train + n_val
    for i in range(n_total):
        theta = 2 * np.pi * i / n_total
        pos = camera_distance * np.array([-0.35, np.sin(theta) * 0.9, np.cos(theta) * 0.9])
        c2w = look_at_drb(pos)
        img = render_gt_image(c2w, w, h, intrinsics, near, far, device=device)
        _write_view(root, "val" if i >= n_train else "train", i, w, h, intrinsics, c2w, img)
    _write_coordinates(root)
    return root


# ---------------------------------------------------------------------------
# The drone survey: a textured ground plane with box "buildings" under a
# lattice of oblique cameras, the geometry of Mega-NeRF's scenes (Mill 19,
# UrbanScene3D). A grid split over the ground footprint gives each cell its
# own well-observed region, where the ring's cameras see the whole volume.
# ---------------------------------------------------------------------------

GROUND_X = 0.5  # DRB: x points down; larger x = lower altitude
# (y, z, half_width, height, r, g, b) of each box "building"
_BOXES = np.array([
    [-0.85, -0.45, 0.16, 0.55, 0.85, 0.25, 0.20],
    [-0.80, 0.50, 0.13, 0.35, 0.20, 0.55, 0.85],
    [-0.30, -0.55, 0.14, 0.45, 0.90, 0.75, 0.20],
    [-0.25, 0.35, 0.17, 0.60, 0.25, 0.80, 0.45],
    [0.25, -0.40, 0.15, 0.30, 0.70, 0.30, 0.75],
    [0.30, 0.55, 0.12, 0.50, 0.95, 0.55, 0.15],
    [0.80, -0.50, 0.16, 0.40, 0.35, 0.70, 0.80],
    [0.85, 0.40, 0.14, 0.65, 0.60, 0.90, 0.30],
    [0.00, 0.00, 0.20, 0.25, 0.80, 0.80, 0.80],
], np.float32)


def drone_density_color(pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The drone scene (an opaque ground and box buildings): points
    (..., 3) -> (sigma (...), rgb (..., 3))."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    below_ground = x > GROUND_X
    boxes = torch.from_numpy(_BOXES).to(pts.device)
    by, bz, hwd, hgt = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    inside = ((torch.abs(y[..., None] - by) < hwd)
              & (torch.abs(z[..., None] - bz) < hwd)
              & (x[..., None] > GROUND_X - hgt)
              & (x[..., None] <= GROUND_X + 0.01))  # (..., B)
    in_any = torch.any(inside, dim=-1)
    sigma = torch.where(below_ground | in_any, 1e4, 0.0).to(pts.dtype)

    # The ground: a smooth color field and a checker, so every view is
    # informative.
    checker = torch.remainder(torch.floor(y * 4.0) + torch.floor(z * 4.0), 2.0)
    ground_rgb = torch.stack([
        0.35 + 0.25 * checker + 0.15 * torch.sin(3.0 * y),
        0.45 + 0.20 * checker + 0.15 * torch.cos(2.0 * z),
        0.30 + 0.15 * checker,
    ], dim=-1)
    # Overlapping boxes average their colors; shaded by height.
    wsel = inside.to(torch.float32)
    wsel = wsel / torch.clamp(wsel.sum(-1, keepdim=True), min=1.0)
    shade = 0.7 + 0.3 * torch.clamp((GROUND_X - x) / 0.7, 0.0, 1.0)[..., None]
    box_rgb = (wsel @ boxes[:, 4:7]) * shade
    rgb = torch.where(in_any[..., None], box_rgb, ground_rgb)
    return sigma, rgb


def make_drone_dataset(root, n_train: int = 24, n_val: int = 2, hw=(24, 24),
                       altitude: float = -1.1, seed: int = 0, device="cuda") -> Path:
    """The drone survey: cameras on a jittered lattice at `altitude` (DRB
    x, negative = up), each looking obliquely at a ground point beneath it;
    the val cameras spread evenly over the lattice."""
    root = Path(root)
    h, w = hw
    focal = 0.9 * w
    intrinsics = np.array([focal, focal, w / 2, h / 2], np.float32)
    near, far = 0.5, 4.0
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)

    n_total = n_train + n_val
    gy = int(np.ceil(np.sqrt(n_total * 1.5)))
    gz = int(np.ceil(n_total / gy))
    ys = np.linspace(-1.1, 1.1, gy)
    zs = np.linspace(-0.85, 0.85, gz)
    lattice = [(yy, zz) for yy in ys for zz in zs][:n_total]
    # Evenly spaced held-out viewpoints (the lattice's tail would put them
    # all in one corner of the footprint).
    val_idx = set(int(round(j * (n_total - 1) / max(n_val, 1)))
                  for j in range(1, n_val + 1))
    backfill = (i for i in range(n_total) if i not in val_idx)
    while len(val_idx) < n_val:  # rounding collisions
        val_idx.add(next(backfill))

    for i, (yy, zz) in enumerate(lattice):
        jy, jz = rng.uniform(-0.08, 0.08, 2)
        pos = np.array([altitude + rng.uniform(-0.05, 0.05), yy + jy, zz + jz])
        # An oblique look at a ground point pulled toward the footprint's
        # center, so edge cameras look inward (a nadir view would make the
        # up vector degenerate).
        target = np.array([GROUND_X, 0.55 * (yy + jy), 0.55 * (zz + jz)])
        c2w = _look_at_drb_from(pos, target - pos)
        img = render_gt_image(c2w, w, h, intrinsics, near, far,
                              scene_fn=drone_density_color, device=device)
        _write_view(root, "val" if i in val_idx else "train", i, w, h, intrinsics, c2w, img)
    _write_coordinates(root)
    return root


def _look_at_drb_from(position: np.ndarray, forward: np.ndarray) -> np.ndarray:
    """c2w (3, 4) for a camera at `position` facing along `forward` (DRB)."""
    forward = forward / np.linalg.norm(forward)
    z_axis = -forward
    up = np.array([-1.0, 0.0, 0.0])  # world up = -x (x points down)
    x_axis = np.cross(up, z_axis)
    if np.linalg.norm(x_axis) < 1e-6:
        up = np.array([0.0, 1.0, 0.0])
        x_axis = np.cross(up, z_axis)
    x_axis = x_axis / np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    return np.stack([x_axis, y_axis, z_axis, position], axis=1).astype(np.float32)
