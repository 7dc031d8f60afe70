#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs every phase, in order:
1. build    - compile every CUDA kernel of the port for sm_90a from the
              sources in this checkout (one nvcc per source, all at once).
2. compare  - each kernel against its plain PyTorch version on the same
              seeded inputs at the serving path's shapes (fused eval MLP:
              ~1M points, paper fg and bg widths, bf16), plus smaller
              variants without dirs / appearance and at other widths.
              Tolerance: rgb <= 1e-2 absolute, sigma <= 1e-2 * (1 + |sigma|).
3. serve    - the serving path end to end: a small dataset in the reference
              layout (one 128x128 val view), a paper-config fg+bg
              checkpoint with seeded random weights, then
              `mega_nerf_tpu_torch.eval.main` on cuda. Checks finite
              PSNR/SSIM, that the fused kernel launched (4 launches per
              16,384-ray chunk) and the plain version never ran, and renders
              one chunk again through the plain version for comparison.
4. time     - kernel ms per launch at the fg-fine shape (16,384 x 512
              points), the plain version's ms, the bound, and the serving
              path's s/view and rays/s, with the card's name and power limit.

Prints a `{"kernels": [...]}` line, the nvidia-smi name/power-limit line,
and as its last line `{"ok": true, "device": {...}}`. Exits non-zero, with
no result line, when a phase fails, when CUDA is unavailable, or when the
port is not beside this script.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
TOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def paper_hparams(extra=()):
    from mega_nerf_tpu_torch.eval import get_eval_opts

    return get_eval_opts([
        "--exp_name", "unused", "--dataset_path", "unused",
        "--pos_xyz_dim", "12", "--pos_dir_dim", "4", "--layers", "8",
        "--skip_layers", "4", "--layer_dim", "256", "--bg_layer_dim", "256",
        "--appearance_dim", "48", "--compute_dtype", "bfloat16",
        "--coarse_samples", "256", "--fine_samples", "512", *extra,
    ])


def seeded_bundle(hp, appearance_count: int, bg: bool, seed: int, device):
    import torch

    from mega_nerf_tpu_torch.models import init_weights, make_bg_nerf, make_nerf

    bundle = (make_bg_nerf if bg else make_nerf)(hp, appearance_count)
    gen = torch.Generator().manual_seed(seed)
    init_weights(bundle.module, gen)
    with torch.no_grad():  # small random biases so no layer starts dead
        for name, p in bundle.module.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    bundle.module.to(device).eval()
    return bundle


def mlp_inputs(cfg, m: int, seed: int, device):
    """Seeded points in the ranges the renderer feeds: fg xyz inside the
    unit ellipsoid, bg = unit-sphere point + inverse depth; unit dirs."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    if cfg.xyz_dim == 3:
        xyz = 1.5 * (2 * torch.rand((m, 3), generator=gen) - 1)
    else:
        p = torch.randn((m, 3), generator=gen)
        xyz = torch.cat([p / p.norm(dim=-1, keepdim=True),
                         torch.rand((m, 1), generator=gen)], -1)
    d = torch.randn((m, 3), generator=gen)
    dirs = d / d.norm(dim=-1, keepdim=True) if cfg.pos_dir_dim else None
    idx = torch.randint(0, max(cfg.appearance_count, 1), (m,), generator=gen)
    to = lambda t: None if t is None else t.to(device).contiguous()  # noqa: E731
    return to(xyz), to(dirs), to(idx)


def phase_build(device, report):
    from mega_nerf_tpu_torch.render import _build

    logs = _build.build_all()
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")
    return True


def compare_case(name, hp, bg, m, seed, device):
    """Kernel vs plain on one configuration -> (max_abs_err, ok)."""
    import torch

    from mega_nerf_tpu_torch.render import fused_mlp

    bundle = seeded_bundle(hp, 16, bg, seed, device)
    packed = fused_mlp.pack_params(bundle.module)
    xyz, dirs, idx = mlp_inputs(bundle.config, m, seed + 1, device)
    app = (bundle.module.appearance(idx).contiguous()
           if bundle.config.appearance_dim else None)
    with torch.no_grad():
        got = fused_mlp.fused_nerf_eval(packed, xyz, dirs, app)
        torch.cuda.synchronize()
        want = fused_mlp.fused_nerf_eval_plain(packed, xyz, dirs, app)
    err = (got - want).abs()
    rgb_err = err[:, :3].max().item()
    sig_ratio = (err[:, 3] / (1 + want[:, 3].abs())).max().item()
    finite = bool(torch.isfinite(got).all())
    ok = finite and rgb_err <= TOL and sig_ratio <= TOL
    log(f"  {name}: M={m} rgb max|err|={rgb_err:.3e} "
        f"sigma max|err|/(1+|s|)={sig_ratio:.3e} sigma range "
        f"[{want[:, 3].min().item():.3g}, {want[:, 3].max().item():.3g}] "
        f"finite={finite} -> {'ok' if ok else 'FAIL'}")
    return err.max().item(), ok


def phase_compare(device, report):
    cases = [
        ("fg paper", paper_hparams(), False, 1_000_003),
        ("bg paper", paper_hparams(), True, 1_000_003),
        ("fg 64-wide, dirs, no appearance",
         paper_hparams(["--layer_dim", "64", "--appearance_dim", "0"]), False, 4_097),
        ("fg 48-wide, no dirs, no appearance",
         paper_hparams(["--layer_dim", "48", "--appearance_dim", "0",
                        "--pos_dir_dim", "0", "--layers", "6",
                        "--skip_layers", "3"]), False, 1_000),
        ("bg 128-wide, appearance, dirs",
         paper_hparams(["--bg_layer_dim", "128"]), True, 70_001),
    ]
    worst = 0.0
    all_ok = True
    for i, (name, hp, bg, m) in enumerate(cases):
        err, ok = compare_case(name, hp, bg, m, 100 + i, device)
        worst = max(worst, err)
        all_ok &= ok
    report["max_abs_err"] = worst
    return all_ok


def write_dataset(root: Path, hw: int, n_train: int, seed: int):
    """Reference dataset layout: coordinates.pt, {train,val}/metadata/*.pt,
    {train,val}/rgbs/*.png. Cameras sit on a lattice above a ground plane
    (DRB: x down), looking obliquely down; images are a seeded pattern."""
    import numpy as np
    import torch
    from PIL import Image

    rng = np.random.default_rng(seed)
    focal = 0.9 * hw
    intrinsics = torch.tensor([focal, focal, hw / 2, hw / 2], dtype=torch.float32)
    positions = [(-1.0, y, z) for y in (-0.6, 0.0, 0.6) for z in (-0.4, 0.4)]
    for i, pos in enumerate(positions[: n_train + 1]):
        split = "val" if i == 2 else "train"
        (root / split / "metadata").mkdir(parents=True, exist_ok=True)
        (root / split / "rgbs").mkdir(parents=True, exist_ok=True)
        pos = np.asarray(pos, np.float64)
        fwd = np.array([0.5, 0.5 * pos[1], 0.5 * pos[2]]) - pos
        fwd /= np.linalg.norm(fwd)
        z_axis = -fwd
        x_axis = np.cross(np.array([-1.0, 0.0, 0.0]), z_axis)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        c2w = np.stack([x_axis, y_axis, z_axis, pos], 1).astype(np.float32)
        torch.save({"W": hw, "H": hw, "intrinsics": intrinsics,
                    "c2w": torch.from_numpy(c2w)},
                   root / split / "metadata" / f"{i:06d}.pt")
        img = rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / split / "rgbs" / f"{i:06d}.png")
    torch.save({"origin_drb": torch.zeros(3, dtype=torch.float64),
                "pose_scale_factor": 1.0}, root / "coordinates.pt")


def phase_serve(device, report, tmp: Path):
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch.render import fused_mlp, rendering
    from mega_nerf_tpu_torch.runtime.runner import Runner

    ds = tmp / "dataset"
    write_dataset(ds, hw=128, n_train=4, seed=7)
    n_items = 5
    extra = ["--dataset_path", str(ds), "--exp_name", str(tmp / "exp"),
             "--ray_altitude_range", "-1.3", "0.6", "--near", "0.05",
             "--val_scale_factor", "1", "--device", "cuda"]
    hp = paper_hparams(extra)
    fg = seeded_bundle(hp, n_items, False, 1, "cpu")
    bg = seeded_bundle(hp, n_items, True, 2, "cpu")
    ckpt = tmp / "0.pt"
    torch.save({"model_state_dict": fg.module.state_dict(),
                "bg_model_state_dict": bg.module.state_dict(),
                "iteration": 0}, ckpt)
    hp.ckpt_path = str(ckpt)

    fused_mlp.fused_nerf_eval.launches = 0
    fused_mlp.fused_nerf_eval_plain.calls = 0
    t0 = time.perf_counter()
    metrics = port_eval.main(hp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_mlp.fused_nerf_eval.launches
    plain_calls = fused_mlp.fused_nerf_eval_plain.calls
    log(f"  eval.main: {metrics} in {wall:.2f} s; kernel launches {launches}, "
        f"plain calls {plain_calls}")
    report["launches"] = launches
    ok = (all(np.isfinite(v) for v in metrics.values())
          and {"val/psnr", "val/ssim"} <= set(metrics)
          and launches >= 4 and launches % 4 == 0 and plain_calls == 0)

    # One chunk again, kernel vs plain MLP path, same weights and rays.
    hp.exp_name = str(tmp / "exp_cmp")
    runner = Runner(hp, set_experiment_path=False)
    runner.make_eval_state()
    meta = runner.val_items[0]
    from mega_nerf_tpu_torch.ops.rays import generate_image_rays

    rays = generate_image_rays(meta, runner.near, runner.far,
                               runner.ray_altitude_range, True,
                               device=device)[:4096]
    idx = torch.full((rays.shape[0],), meta.image_index, device=device)
    settings = runner.render_settings()
    args = (runner.fg, runner.bg, rays, idx, settings,
            runner.sphere_center, runner.sphere_radius)
    kern = rendering.render_rays(*args)
    saved = rendering.fused_nerf_eval
    rendering.fused_nerf_eval = fused_mlp.fused_nerf_eval_plain
    try:
        plain = rendering.render_rays(*args)
    finally:
        rendering.fused_nerf_eval = saved
    diff = (kern["rgb_fine"] - plain["rgb_fine"]).abs().max().item()
    dd = ((kern["depth_fine"] - plain["depth_fine"]).abs()
          / (1 + plain["depth_fine"].abs())).max().item()
    log(f"  one 4096-ray chunk, kernel vs plain MLP path: rgb_fine max|diff|="
        f"{diff:.3e}, depth_fine max|diff|/(1+|d|)={dd:.3e}")
    report["render_rgb_diff"] = diff
    ok = ok and diff <= TOL and bool(torch.isfinite(kern["rgb_fine"]).all())
    report["runner"] = runner
    return ok


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_time(device, report):
    import torch

    from mega_nerf_tpu_torch.render import fused_mlp

    hp = paper_hparams()
    bundle = seeded_bundle(hp, 16, False, 11, device)
    cfg = bundle.config
    packed = fused_mlp.pack_params(bundle.module)
    m = 16384 * 512
    xyz, dirs, idx = mlp_inputs(cfg, m, 12, device)
    app = bundle.module.appearance(idx).contiguous()
    with torch.no_grad():
        saved = fused_mlp.fused_nerf_eval.launches
        ms = cuda_ms(lambda: fused_mlp.fused_nerf_eval(packed, xyz, dirs, app), 10)
        fused_mlp.fused_nerf_eval.launches = saved
        plain_ms = cuda_ms(
            lambda: fused_mlp.fused_nerf_eval_plain(packed, xyz, dirs, app), 3, 1)
    flops = fused_mlp.flops_per_point(cfg) * m
    nbytes = fused_mlp.io_bytes_per_point(cfg) * m
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    report.update(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                  bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"  fused eval kernel at {m} points (fg fine, 16384 x 512): "
        f"{ms:.3f} ms/launch = {flops / ms / 1e9:.1f} TFLOP/s; plain "
        f"{plain_ms:.3f} ms; bound {report['bound_ms']:.3f} ms "
        f"({report['bound_by']}: {flops:.4g} FLOP, {nbytes:.4g} B)")

    runner = report["runner"]
    meta = runner.val_items[0]
    runner.render_image(meta)  # warm
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        runner.render_image(meta)
    torch.cuda.synchronize()
    s_view = (time.perf_counter() - t0) / reps
    rays = meta.W * meta.H
    report.update(s_per_view=s_view, rays_per_s=rays / s_view)
    log(f"  serving path: {meta.W}x{meta.H} view, {s_view:.4f} s/view, "
        f"{rays / s_view:.1f} rays/s (paper fg+bg, 256+512 samples)")
    return True


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import mega_nerf_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    device = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    log(f"device: {torch.cuda.get_device_name(0)} ({smi_line}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    report = {}
    ok = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phases = (
            ("build", lambda: phase_build(device, report)),
            ("compare", lambda: phase_compare(device, report)),
            ("serve", lambda: phase_serve(device, report, Path(tmp))),
            ("time", lambda: phase_time(device, report)),
        )
        for phase, run in phases:
            log(f"[{phase}]")
            t0 = time.perf_counter()
            good = run()
            log(f"[{phase}] {'ok' if good else 'FAILED'} in "
                f"{time.perf_counter() - t0:.1f} s")
            ok &= good
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1

    kernel = {
        "name": "fused_nerf_eval",
        "route": "cuda",
        "source": "mega_nerf_tpu_torch/render/csrc/fused_mlp.cu",
        "replaces": "mega_nerf_tpu/render/pallas_mlp.py:401",
        "launches": report["launches"],
        "max_abs_err": report["max_abs_err"],
        "ms": report["ms"],
        "plain_ms": report["plain_ms"],
        "bound_ms": report["bound_ms"],
        "bound_by": report["bound_by"],
        "library_ms": None,
    }
    serving = {k: report[k] for k in ("s_per_view", "rays_per_s",
                                      "render_rgb_diff")}
    log(json.dumps({"serving": serving}))
    log(json.dumps({"kernels": [kernel]}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
