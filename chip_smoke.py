#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs every phase, in order:
1. build    - compile every CUDA kernel of the port for sm_90a from the
              sources in this checkout (one nvcc per source, all at once).
2. compare  - each kernel against its plain PyTorch version on the same
              seeded inputs at the main paths' shapes (~1M points, paper fg
              and bg widths, bf16), plus narrower variants, variants without
              dirs / appearance and M not a multiple of the 64-point tile.
              Forward kernels (eval, train with sigma noise): rgb <= 1e-2
              absolute, sigma <= 1e-2 * (1 + |sigma|). Backward-data (from
              the forward kernel's saved rows) and weight-gradient (from the
              backward-data kernel's rows): relative norm <= 1e-2 per
              layer's gradient rows, d_app and every gradient tensor (bf16
              operands, another summation order).
3. serve    - the serving path end to end: a small dataset in the reference
              layout (one 128x128 val view), a paper-config fg+bg
              checkpoint with seeded random weights, then
              `mega_nerf_tpu_torch.eval.main` on cuda. Checks finite
              PSNR/SSIM, that the fused kernel launched (4 launches per
              16,384-ray chunk) and the plain version never ran, and renders
              one chunk again through the plain version for comparison.
4. train    - the training path end to end: `mega_nerf_tpu_torch.train.main`
              on cuda at the paper config (1024-ray batches, fg + bg 8x256,
              256 + 512 samples, Adam with per-step decay), 120 steps on a
              generated 128x128 dataset with a smooth pattern. Checks finite
              metrics, a falling loss (mean of the last 10 steps below the
              first 10), 4 launches per step of each training kernel and no
              plain call, and a finite-PSNR `eval.main` on the final
              `{iter}.pt`; then one step from the same weights and batch
              through the kernels and through the plain versions.
5. time     - eval kernel ms per launch at the fg-fine eval shape (16,384 x
              512 points); training kernels ms per launch at each of the
              step's four shapes (fg-fine: 1024 x 512 points); the plain
              versions' ms and the bounds at the fg-fine shapes (each
              kernel's FLOP - forward, dX or dW products - at 989 TFLOP/s
              against the training function's boundary bytes at 3.35 TB/s;
              the saved rows the kernels pass each other are printed
              beside it as the design's own cost); the serving
              path's s/view and rays/s; train step ms and rays/s over 20
              chained steps; the card's name and power limit beside them.

Prints `{"serving": ...}` and `{"training": ...}` lines, a
`{"kernels": [...]}` line, the nvidia-smi name/power-limit line,
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
# (name, source, the TPU kernel it replaces)
KERNELS = (
    ("fused_nerf_eval", "mega_nerf_tpu_torch/render/csrc/fused_mlp.cu",
     "mega_nerf_tpu/render/pallas_mlp.py:401"),
    ("fused_nerf_train_fwd", "mega_nerf_tpu_torch/render/csrc/fused_train.cu",
     "mega_nerf_tpu/render/pallas_train.py:138"),
    ("train_bwd_data", "mega_nerf_tpu_torch/render/csrc/fused_train.cu",
     "mega_nerf_tpu/render/pallas_train.py:171"),
    ("weight_grad", "mega_nerf_tpu_torch/render/csrc/fused_train.cu",
     "mega_nerf_tpu/render/pallas_train.py:171"),
)


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
            if ("registers" in line or "spill" in line or "error" in line
                    or "Function properties for" in line):
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


def rel_err(a, b) -> float:
    """||a - b|| / ||b||."""
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def compare_train_case(name, hp, bg, m, seed, device):
    """Training kernels vs their plain versions on one configuration ->
    ({kernel: max_abs_err}, ok)."""
    import torch

    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    bundle = seeded_bundle(hp, 16, bg, seed, device)
    cfg = bundle.config
    packed = fused_mlp.pack_params(bundle.module)
    xyz, dirs, idx = mlp_inputs(cfg, m, seed + 1, device)
    app = bundle.module.appearance(idx).float() if cfg.appearance_dim else None
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    noise = torch.rand((m,), generator=gen, device=device)
    noise = noise.to(torch.bfloat16).float()
    g = torch.randn((m, 4), generator=gen, device=device)
    with torch.no_grad():
        out, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
        want, p_act = ft.fused_nerf_train_fwd_plain(packed, xyz, dirs, app, noise)
        torch.cuda.synchronize()
        err = (out - want).abs()
        fwd_rgb = err[:, :3].max().item()
        fwd_sig = (err[:, 3] / (1 + want[:, 3].abs())).max().item()
        act_rel = rel_err(act, p_act)
        fwd_err = err.max().item()
        del p_act
        grad, d_app = ft.train_bwd_data(packed, act, g, noise)
        p_grad, p_d_app = ft.train_bwd_data_plain(packed, act, g, noise)
        torch.cuda.synchronize()
        d = cfg.layer_dim
        rows_rel = max(rel_err(grad[:, i * d:(i + 1) * d], p_grad[:, i * d:(i + 1) * d])
                       for i in range(cfg.layers))
        rows_rel = max(rows_rel, rel_err(grad, p_grad))
        if p_d_app is not None:
            rows_rel = max(rows_rel, rel_err(d_app, p_d_app))
        bwd_err = (grad.float() - p_grad.float()).abs().max().item()
        del p_grad
        flat = ft.weight_grad(packed, act, grad)
        p_flat = ft.weight_grad_plain(packed, act, grad)
        torch.cuda.synchronize()
        offs = ft._offsets(ft.packed_shapes(packed))
        w_rel = max(rel_err(flat[offs[i]:offs[i + 1]], p_flat[offs[i]:offs[i + 1]])
                    for i in range(len(offs) - 1))
        wg_err = (flat - p_flat).abs().max().item()
    finite = bool(torch.isfinite(out).all() and torch.isfinite(flat).all())
    ok = (finite and fwd_rgb <= TOL and fwd_sig <= TOL and act_rel <= TOL
          and rows_rel <= TOL and w_rel <= TOL)
    log(f"  train {name}: M={m} fwd rgb max|err|={fwd_rgb:.3e} sigma "
        f"max|err|/(1+|s|)={fwd_sig:.3e} rows rel={act_rel:.3e}; bwd-data "
        f"worst rel={rows_rel:.3e}; weight-grad worst rel={w_rel:.3e}; "
        f"finite={finite} -> {'ok' if ok else 'FAIL'}")
    del act, grad, flat, p_flat
    torch.cuda.empty_cache()
    return {"fused_nerf_train_fwd": fwd_err, "train_bwd_data": bwd_err,
            "weight_grad": wg_err}, ok


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
    kernels = report["kernels"]
    worst = 0.0
    all_ok = True
    for i, (name, hp, bg, m) in enumerate(cases):
        err, ok = compare_case(name, hp, bg, m, 100 + i, device)
        worst = max(worst, err)
        all_ok &= ok
    kernels["fused_nerf_eval"]["max_abs_err"] = worst
    for i, (name, hp, bg, m) in enumerate(cases):
        errs, ok = compare_train_case(name, hp, bg, m, 200 + i, device)
        for k, v in errs.items():
            kernels[k]["max_abs_err"] = max(kernels[k].get("max_abs_err", 0.0), v)
        all_ok &= ok
    return all_ok


def write_dataset(root: Path, hw: int, n_train: int, seed: int,
                  smooth: bool = False):
    """Reference dataset layout: coordinates.pt, {train,val}/metadata/*.pt,
    {train,val}/rgbs/*.png. Cameras sit on a lattice above a ground plane
    (DRB: x down), looking obliquely down; images are seeded noise, or with
    `smooth` a low-frequency colour pattern a model can fit."""
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
        if smooth:
            yy, xx = np.mgrid[0:hw, 0:hw] / hw
            img = np.stack([0.5 + 0.35 * np.sin(2 * np.pi * (xx + 0.1 * i)),
                            0.5 + 0.35 * np.cos(3 * np.pi * yy),
                            0.5 + 0.3 * np.sin(2 * np.pi * (xx + yy))], -1)
            img = (img * 255).astype(np.uint8)
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
    report["kernels"]["fused_nerf_eval"]["launches"] = launches
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
    with torch.no_grad():
        kern, _ = rendering.render_rays(*args)
        saved = rendering.fused_nerf_eval
        rendering.fused_nerf_eval = fused_mlp.fused_nerf_eval_plain
        try:
            plain, _ = rendering.render_rays(*args)
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


TRAIN_STEPS = 120


def train_counters():
    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    return {
        "fused_nerf_train_fwd": ft.fused_nerf_train_fwd.launches,
        "train_bwd_data": ft.train_bwd_data.launches,
        "weight_grad": ft.weight_grad.launches,
        "plain": (ft.fused_nerf_train_fwd_plain.calls
                  + ft.train_bwd_data_plain.calls + ft.weight_grad_plain.calls
                  + fused_mlp.fused_nerf_eval_plain.calls),
    }


def zero_train_counters() -> None:
    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    for fn in (ft.fused_nerf_train_fwd, ft.train_bwd_data, ft.weight_grad):
        fn.launches = 0
    for fn in (ft.fused_nerf_train_fwd_plain, ft.train_bwd_data_plain,
               ft.weight_grad_plain, fused_mlp.fused_nerf_eval_plain):
        fn.calls = 0


def train_hparams(ds: Path, exp: Path, extra=()):
    from mega_nerf_tpu_torch.train import get_train_opts

    return get_train_opts([
        "--dataset_path", str(ds), "--exp_name", str(exp),
        "--dataset_type", "memory", "--device", "cuda",
        "--pos_xyz_dim", "12", "--pos_dir_dim", "4", "--layers", "8",
        "--skip_layers", "4", "--layer_dim", "256", "--bg_layer_dim", "256",
        "--appearance_dim", "48", "--compute_dtype", "bfloat16",
        "--coarse_samples", "256", "--fine_samples", "512",
        "--batch_size", "1024", "--lr", "5e-4", "--lr_decay_factor", "0.1",
        "--train_iterations", str(TRAIN_STEPS), "--ckpt_interval", "100000",
        "--val_interval", "100000", "--ray_altitude_range", "-1.3", "0.6",
        "--near", "0.05", "--val_scale_factor", "1", *extra,
    ])


def phase_train(device, report, tmp: Path):
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch import train as port_train
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render import fused_train as ft
    from mega_nerf_tpu_torch.render.rendering import RenderSettings
    from mega_nerf_tpu_torch.runtime.runner import Runner

    ds = tmp / "train_dataset"
    write_dataset(ds, hw=128, n_train=4, seed=11, smooth=True)
    hp = train_hparams(ds, tmp / "train_exp")

    losses = []
    step_call = TrainStep.__call__

    def recording_call(self, batch, generator=None):
        metrics = step_call(self, batch, generator)
        losses.append(metrics["loss"])
        return metrics

    TrainStep.__call__ = recording_call
    zero_train_counters()
    t0 = time.perf_counter()
    try:
        val = port_train.main(hp)
        torch.cuda.synchronize()
    finally:
        TrainStep.__call__ = step_call
    wall = time.perf_counter() - t0
    counts = train_counters()
    loss = torch.stack(losses).float().cpu().numpy()
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    log(f"  train.main: {TRAIN_STEPS} steps + final validation in {wall:.2f} s; "
        f"loss first 10 {first:.5f} -> last 10 {last:.5f}; val {val}; "
        f"launches {counts}")
    for name in ("fused_nerf_train_fwd", "train_bwd_data", "weight_grad"):
        report["kernels"][name]["launches"] = counts[name]
    ok = (len(loss) == TRAIN_STEPS and np.isfinite(loss).all() and last < first
          and all(counts[k] == 4 * TRAIN_STEPS for k in
                  ("fused_nerf_train_fwd", "train_bwd_data", "weight_grad"))
          and counts["plain"] == 0
          and all(np.isfinite(v) for v in val.values()))
    ckpt = tmp / "train_exp" / "0" / "models" / f"{TRAIN_STEPS}.pt"
    e_hp = paper_hparams(["--dataset_path", str(ds), "--exp_name",
                          str(tmp / "train_eval"), "--ckpt_path", str(ckpt),
                          "--ray_altitude_range", "-1.3", "0.6", "--near", "0.05",
                          "--val_scale_factor", "1", "--device", "cuda"])
    e_metrics = port_eval.main(e_hp)
    log(f"  eval.main on {ckpt.name}: {e_metrics}")
    ok = ok and ckpt.exists() and np.isfinite(e_metrics["val/psnr"])

    # One step from the trained weights and one batch, kernels vs plain.
    runner = Runner(train_hparams(ds, tmp / "unused"), set_experiment_path=False)
    runner._load_weights(ckpt)
    step = TrainStep(runner.fg, runner.bg, RenderSettings.from_hparams(runner.hparams),
                     5e-4, 0.1, TRAIN_STEPS, runner.sphere_center,
                     runner.sphere_radius)
    dataset = runner._make_dataset()
    batches = []
    for host in dataset.batches(1024, np.random.default_rng(3)):
        batches.append({
            "rgbs": torch.from_numpy(host["rgbs"]).to(device),
            "rays": torch.from_numpy(host["rays"]).to(device),
            "img_indices": torch.from_numpy(host["img_indices"]).long().to(device),
        })
        if len(batches) == 30:
            break

    def loss_and_grads():
        for o in (step.fg_opt, step.bg_opt):
            o.zero_grad(set_to_none=True)
        gen = torch.Generator(device=device).manual_seed(5)
        loss_t, _, _ = step.loss(batches[0], gen)
        loss_t.backward()
        grads = {f"{side}.{n}": q.grad.detach().clone()
                 for side, b in (("fg", runner.fg), ("bg", runner.bg))
                 for n, q in b.module.named_parameters() if q.grad is not None}
        return loss_t.item(), grads

    k_loss, k_grads = loss_and_grads()
    saved = (ft.fused_nerf_train_fwd, ft.train_bwd_data, ft.weight_grad)
    ft.fused_nerf_train_fwd = ft.fused_nerf_train_fwd_plain
    ft.train_bwd_data = ft.train_bwd_data_plain
    ft.weight_grad = ft.weight_grad_plain
    try:
        p_loss, p_grads = loss_and_grads()
    finally:
        ft.fused_nerf_train_fwd, ft.train_bwd_data, ft.weight_grad = saved
    worst_name, worst = max(((n, rel_err(k_grads[n], p_grads[n])) for n in p_grads),
                            key=lambda t: t[1])
    log(f"  one step, kernels vs plain: loss {k_loss:.6f} vs {p_loss:.6f} "
        f"(diff {abs(k_loss - p_loss):.3e}); worst relative grad diff "
        f"{worst:.3e} ({worst_name})")
    report["training"] = {"steps": TRAIN_STEPS, "loss_first10": first,
                          "loss_last10": last, "val_psnr": val.get("val/psnr"),
                          "step_loss_diff": abs(k_loss - p_loss),
                          "step_worst_rel_grad_diff": worst}
    report["train_step"] = step
    report["train_batches"] = batches
    return bool(ok)


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


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def dx_flops_per_point(cfg) -> int:
    """Multiply-adds x 2 of one point's data-gradient products at the live
    widths: through every trunk layer but the first (no gradient flows into
    the encodings, nor into a skip layer's encoding columns), trunk_final,
    the branch into the final features and d_app, and the heads."""
    d = cfg.layer_dim
    macs = (cfg.layers - 1) * d * d + d
    if cfg.uses_dir_branch:
        macs += d * d + (d + cfg.appearance_dim) * (d // 2) + (d // 2) * 3
    else:
        macs += d * 3
    return 2 * macs


def time_train_kernels(device, report):
    """Training kernels per launch at the step's four shapes; plain
    versions and bounds at the fg-fine shape."""
    import torch

    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    hp = paper_hparams()
    kernels = report["kernels"]
    saved = train_counters()
    per_step = 0.0
    shapes = [("fg coarse", False, 1024 * 256), ("fg fine", False, 1024 * 512),
              ("bg coarse", True, 1024 * 128), ("bg fine", True, 1024 * 256)]
    for name, bg, m in shapes:
        bundle = seeded_bundle(hp, 16, bg, 21, device)
        cfg = bundle.config
        packed = fused_mlp.pack_params(bundle.module)
        xyz, dirs, idx = mlp_inputs(cfg, m, 22, device)
        app = bundle.module.appearance(idx).float()
        noise = torch.rand((m,), device=device).to(torch.bfloat16).float()
        g = torch.randn((m, 4), device=device)
        with torch.no_grad():
            _, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
            grad, _ = ft.train_bwd_data(packed, act, g, noise)
            t_fwd = cuda_ms(lambda: ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise), 5)
            t_bwd = cuda_ms(lambda: ft.train_bwd_data(packed, act, g, noise), 5)
            t_wg = cuda_ms(lambda: ft.weight_grad(packed, act, grad), 5)
        per_step += t_fwd + t_bwd + t_wg
        log(f"  train kernels, {name} ({m} points): fwd {t_fwd:.3f} ms, "
            f"bwd-data {t_bwd:.3f} ms, weight-grad {t_wg:.3f} ms")
        if name != "fg fine":
            continue
        flops = fused_mlp.flops_per_point(cfg) * m
        dx_flops = dx_flops_per_point(cfg) * m
        named = dict(bundle.module.named_parameters())
        n_params = sum(named[k].numel() for k in fused_mlp.mlp_param_names(cfg))
        # The function's boundary: xyz, dirs, app, noise in and (rgb, sigma)
        # out forward; the same points, noise and the output cotangent in,
        # d_app and the weight gradients out backward. The saved rows are
        # this design's own traffic, printed beside the bound, not in it.
        fwd_b = (fused_mlp.io_bytes_per_point(cfg) + 4) * m
        bwd_b = fwd_b + 4 * cfg.appearance_dim * m + 4 * n_params
        act_b, grad_b = act.numel() * 2, grad.numel() * 2
        with torch.no_grad():
            p_fwd = cuda_ms(lambda: ft.fused_nerf_train_fwd_plain(packed, xyz, dirs, app, noise), 2, 1)
            p_bwd = cuda_ms(lambda: ft.train_bwd_data_plain(packed, act, g, noise), 2, 1)
            p_wg = cuda_ms(lambda: ft.weight_grad_plain(packed, act, grad), 2, 1)
        rows = {  # name: (ms, plain ms, FLOP, bytes, saved-row bytes moved)
            "fused_nerf_train_fwd": (t_fwd, p_fwd, flops, fwd_b, act_b),
            "train_bwd_data": (t_bwd, p_bwd, dx_flops, bwd_b, act_b + grad_b),
            "weight_grad": (t_wg, p_wg, flops, bwd_b, act_b + grad_b),
        }
        for k, (ms, plain_ms, fl, nb, rows_b) in rows.items():
            bms, by = bound(fl, nb)
            kernels[k].update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
            log(f"  {k} at fg fine: {ms:.3f} ms/launch = {fl / ms / 1e9:.1f} "
                f"TFLOP/s; plain {plain_ms:.3f} ms; bound {bms:.3f} ms ({by}: "
                f"{fl:.4g} FLOP, {nb:.4g} B); saved rows moved {rows_b:.4g} B "
                f"= {rows_b / PEAK_HBM_BYTES * 1e3:.3f} ms at the memory rate")
        report["training"]["fg_fine_saved_row_bytes"] = {"act": act_b, "grad": grad_b}
        del act, grad
        torch.cuda.empty_cache()
    report["train_kernel_ms_per_step"] = per_step
    # Timing launches are not main-path launches.
    for k in ("fused_nerf_train_fwd", "train_bwd_data", "weight_grad"):
        getattr(ft, k).launches = saved[k]


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
    bms, by = bound(flops, nbytes)
    report["kernels"]["fused_nerf_eval"].update(
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    log(f"  fused eval kernel at {m} points (fg fine, 16384 x 512): "
        f"{ms:.3f} ms/launch = {flops / ms / 1e9:.1f} TFLOP/s; plain "
        f"{plain_ms:.3f} ms; bound {bms:.3f} ms ({by}: {flops:.4g} FLOP, "
        f"{nbytes:.4g} B)")
    del xyz, dirs, idx, app

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

    time_train_kernels(device, report)
    step, batches = report["train_step"], report["train_batches"]
    for b in batches[:5]:  # warm-up
        step(b)
    torch.cuda.synchronize()
    n = 20
    t0 = time.perf_counter()
    for b in batches[5:5 + n]:
        step(b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    share = report["train_kernel_ms_per_step"] / step_ms
    report["training"].update(step_ms=step_ms, rays_per_s=1024 / step_ms * 1e3,
                               kernel_ms_per_step=report["train_kernel_ms_per_step"],
                               kernel_share=share,
                               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  training path: {step_ms:.2f} ms/step over {n} chained steps = "
        f"{1024 / step_ms * 1e3:.1f} rays/s (paper fg+bg, batch 1024); "
        f"training kernels {report['train_kernel_ms_per_step']:.2f} ms/step "
        f"from per-launch times ({100 * share:.1f}% of the step)")
    profile_steps(step, batches[25:30], report)
    return True


def profile_steps(step, batches, report) -> None:
    """Device time by kernel over a few chained steps (torch.profiler) and
    the device's busy share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            step(b)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", 0.0) or 0.0
        if dev > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev / 1e3 / len(batches), e.count // len(batches), e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * len(batches)
    if not rows:
        log("  profiler: no device time recorded (device share not measured)")
        return
    log(f"  profiler over {len(batches)} steps: device busy {busy:.1f} ms of "
        f"{wall_ms:.1f} ms wall ({100 * busy / wall_ms:.1f}%); per step by kernel:")
    for ms, count, name in rows[:15]:
        log(f"    {ms:8.3f} ms  x{count:<4d} {name[:90]}")
    rest = sum(r[0] for r in rows[15:])
    log(f"    {rest:8.3f} ms  in {len(rows) - 15} other kernels")
    report["training"]["profiled_device_busy_share"] = busy / wall_ms


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

    report = {"kernels": {name: {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "library_ms": None} for name, source, replaces in KERNELS}}
    ok = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phases = (
            ("build", lambda: phase_build(device, report)),
            ("compare", lambda: phase_compare(device, report)),
            ("serve", lambda: phase_serve(device, report, Path(tmp))),
            ("train", lambda: phase_train(device, report, Path(tmp))),
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

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: entry[k] for k in keys} for entry in report["kernels"].values()]
    serving = {k: report[k] for k in ("s_per_view", "rays_per_s",
                                      "render_rgb_diff")}
    log(json.dumps({"serving": serving}))
    log(json.dumps({"training": report["training"]}))
    log(json.dumps({"kernels": kernels}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
