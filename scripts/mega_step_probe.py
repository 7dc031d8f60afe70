"""Where a joint Mega-NeRF step through the training kernels parts from the
same step through their plain versions, on the card.

    python3 scripts/mega_step_probe.py [--out DIR] [--top 6]

(`--device cpu --model '--layers 2 ...'` runs it at a tiny width on the
CPU, where both chains are the plain versions: a dry run of the script.)

Rebuilds `chip_smoke.py`'s `train_mega` state (its datasets, its K = 8
centroids, `train.main --train_mega_nerf` for `MEGA_TRAIN_STEPS` steps at
`configs/mega-nerf/building.yaml`, its first batch and noise), then runs
one joint step three ways (`chip_smoke.joint_step_through`): through the
kernels, through their plain versions, and through an f64 reference (the
same bf16 weights; every product, sum and activation in f64, no rounding
of the saved rows). Each way records every call of the training MLP: its
submodule, its points and sigma noise, and the cotangent that reaches it.

Reports:
- `step`: each gradient tensor's relative norm difference for kernel vs
  plain, kernel vs f64 and plain vs f64 (the worst `--top` of kernel vs
  plain, and the worst of each pair);
- `inputs`: per MLP call, whether the kernel and plain steps fed it the
  same points (the fine samples follow the coarse pass's output) and how
  far their cotangents are apart;
- `replay`: the calls of the worst tensors' submodules rerun on the kernel
  step's own inputs and cotangents, kernel chain against plain chain
  against f64 chain, so a kernel's drift shows apart from the inputs'; and
  per stage on identical inputs: the saved rows (elements that differ, ReLU
  masks that flip), the backward-data rows on the kernel's saved rows, and
  the weight gradient on the kernel's rows against f64 sums of the same
  rows.

Writes `{out}/mega_step_probe.json` with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from mega_nerf_tpu_torch import train as port_train  # noqa: E402
from mega_nerf_tpu_torch.parallel.train_step import TrainStep  # noqa: E402
from mega_nerf_tpu_torch.render import fused_train as ft  # noqa: E402
from mega_nerf_tpu_torch.render.fused_mlp import mlp_param_names, pack_tensors  # noqa: E402
from mega_nerf_tpu_torch.render.rendering import RenderSettings  # noqa: E402
from mega_nerf_tpu_torch.runtime.runner import Runner, batch_to_device  # noqa: E402
from mega_nerf_tpu_torch.scripts.create_cluster_masks import make_centroids  # noqa: E402

CHAINS = ("kernel", "plain", "f64")  # chip_smoke.train_chain


def rel(a, b) -> float:
    return cs.rel_err(a, b)


def build_state(tmp: Path, device, model_args=(), extra_steps: int = 0):
    """`chip_smoke.py`'s train_mega state -> (step, first batch), after
    `extra_steps` steps of the joint step on the phase's batches."""
    ds = tmp / "dataset"
    cs.write_dataset(ds, hw=128, n_train=4, seed=7)
    lo, hi = cs.camera_extent(ds)
    params = tmp / "mega" / "params.pt"
    params.parent.mkdir(parents=True)
    torch.save({"centroids": torch.from_numpy(make_centroids(cs.MEGA_GRID, lo, hi)),
                "grid_dim": list(cs.MEGA_GRID), "min_position": torch.from_numpy(lo),
                "max_position": torch.from_numpy(hi), "cluster_2d": False}, params)
    tds = tmp / "train_dataset"
    cs.write_dataset(tds, hw=128, n_train=4, seed=11, smooth=True)
    extra = cs.TRAIN_ARGS + ["--train_iterations", str(cs.MEGA_TRAIN_STEPS),
                             "--train_mega_nerf", str(params), "--device", device.type,
                             *model_args]
    port_train.main(cs.config_hparams(port_train.get_train_opts, cs.MEGA_CONFIG, tds,
                                      tmp / "mega_train", extra))
    runner = Runner(cs.config_hparams(port_train.get_train_opts, cs.MEGA_CONFIG, tds,
                                      tmp / "unused", extra), set_experiment_path=False)
    runner._load_weights(tmp / "mega_train" / "0" / "models" / f"{cs.MEGA_TRAIN_STEPS}.pt")
    step = TrainStep(runner.fg, runner.bg, RenderSettings.from_hparams(runner.hparams),
                     5e-4, 0.1, cs.MEGA_TRAIN_STEPS, runner.sphere_center,
                     runner.sphere_radius)
    batches = [batch_to_device(b, device) for _, b in zip(
        range(max(1, extra_steps)), runner._make_dataset().batches(1024, np.random.default_rng(3)))]
    for b in batches[:extra_steps]:  # as train_mega times and profiles the step
        step(b)
    return step, batches[0]


def chain_grads(rec, chain: str):
    """One call's packed pieces and parameter gradients through `chain` on
    the recorded inputs and cotangent -> (saved rows, grad rows, grads by name)."""
    module = rec["module"]
    cfg = module.config
    named = dict(module.named_parameters())
    params = [named[n] for n in mlp_param_names(cfg)]
    packed = pack_tensors(cfg, dict(zip(mlp_param_names(cfg), params)))
    fwd, bwd, wg = cs.train_chain(chain)
    with torch.no_grad():
        _, act = fwd(packed, rec["xyz"], rec["coords"], rec["app"], rec["nz"])
        rows, _ = bwd(packed, act, rec["g"].float().contiguous(), rec["nz"])
        flat = wg(packed, act, rows)
    grads = ft.unpack_grads(cfg, ft.split_grads(packed, flat), params)
    return packed, act, rows, dict(zip(mlp_param_names(cfg), grads))


def row_stats(a, b) -> dict:
    """Saved or gradient rows of two chains on the same inputs."""
    a, b = a.float(), b.float()
    return {"elements": a.numel(), "differ": int((a != b).sum()),
            "mask_flips": int(((a > 0) != (b > 0)).sum()), "rel": rel(a, b)}


def job_of(packed, name: str):
    """The weight-gradient job (d_col, n, x_col, k, ...) that forms `name`."""
    names = mlp_param_names(packed.config)
    if name not in names:
        return None
    off = ft._offsets(ft.packed_shapes(packed))[names.index(name)]
    return next((job for job in ft.weight_grad_jobs(packed) if job[4] == off), None)


def attribution(packed, outs, job, g, top: int = 5) -> dict:
    """Per point, how far each chain's contribution (d_pre row outer input
    row) to one weight gradient sits from the f64 chain's; the points that
    carry most of the gap, their ReLU flips against the f64 rows and their
    cotangents."""
    d_col, n, x_col, k = job[:4]
    ref_x, ref_d = outs["f64"][0].double(), outs["f64"][1][:, d_col:d_col + n].double()
    rx = ref_x[:, x_col:x_col + k]
    total = ref_d.T @ rx
    tnorm = total.norm().item()
    lay = ft.act_layout(packed)
    res = {"layout": lay, "ref_norm": tnorm,
           "g_norm_median": g.float().norm(dim=1).median().item()}
    for ch in ("kernel", "plain"):
        act = outs[ch][0].double()
        dd, xx = outs[ch][1][:, d_col:d_col + n].double(), act[:, x_col:x_col + k]
        gap = dd.T @ xx - total
        sq = ((dd * dd).sum(1) * (xx * xx).sum(1) + (ref_d * ref_d).sum(1) * (rx * rx).sum(1)
              - 2 * (dd * ref_d).sum(1) * (xx * rx).sum(1))
        per = sq.clamp_min(0).sqrt()
        idx = per.argsort(descending=True)[:top]
        part = dd[idx].T @ xx[idx] - ref_d[idx].T @ rx[idx]
        points = []
        for i in idx.tolist():
            flip = ((act[i] > 0) != (ref_x[i] > 0)).nonzero().flatten()
            points.append({
                "point": i, "gap_rel": per[i].item() / tnorm,
                "g_norm": g[i].float().norm().item(), "flips": int(flip.numel()),
                "flip_cols": flip[:8].tolist(),
                "flip_values_chain_f64": [(act[i, c].item(), ref_x[i, c].item())
                                          for c in flip[:4].tolist()]})
        res[ch] = {"gap_rel": gap.norm().item() / tnorm,
                   "top_share": part.norm().item() / max(gap.norm().item(), 1e-300),
                   "gap_rel_without_top": (gap - part).norm().item() / tnorm,
                   "flips_all_points": int(((act > 0) != (ref_x > 0)).sum()),
                   "top_points": points}
    return res


def replay(key: str, calls, top_names):
    """The kernel step's calls of submodule `key` through the three chains on
    their own inputs, and each stage of the kernel chain on identical inputs."""
    mine = [c for c in calls if c["key"] == key]
    sums = {ch: {} for ch in CHAINS}
    stages = []
    for rec in mine:
        outs = {}
        for ch in CHAINS:
            packed, act, rows, grads = chain_grads(rec, ch)
            outs[ch] = (act, rows)
            for n, g in grads.items():
                sums[ch][n] = sums[ch].get(n, 0) + g.double()
        with torch.no_grad():
            act_k, rows_k = outs["kernel"]
            rows_p_on_k, _ = ft.train_bwd_data_plain(packed, act_k, rec["g"].float().contiguous(),
                                                     rec["nz"])
            wg_k = ft.weight_grad(packed, act_k, rows_k)
            wg_p = ft.weight_grad_plain(packed, act_k, rows_k)
            wg_r = cs.weight_grad_f64(packed, act_k, rows_k).double()
        worst = next((full.split(".", 2)[2] for full in top_names
                      if full.startswith(key + ".") and full.endswith(".weight")
                      and job_of(packed, full.split(".", 2)[2]) is not None), None)
        stages.append({
            "points": int(rec["xyz"].shape[0]),
            "attribution": None if worst is None else {
                "tensor": worst, **attribution(packed, outs, job_of(packed, worst), rec["g"])},
            "fwd_rows_kernel_vs_plain": row_stats(act_k, outs["plain"][0]),
            "bwd_rows_kernel_vs_plain_on_kernel_rows": row_stats(rows_k, rows_p_on_k),
            "wg_on_kernel_rows": {"kernel_vs_f64": rel(wg_k.double(), wg_r),
                                  "plain_vs_f64": rel(wg_p.double(), wg_r),
                                  "kernel_vs_plain": rel(wg_k, wg_p)}})
    side = key.split(".")[0]
    out = {}
    for full in top_names:
        s, sub, name = full.split(".", 2)
        if f"{s}.{sub}" != key or name not in sums["kernel"]:
            continue
        k, p, r = (sums[ch][name] for ch in ("kernel", "plain", "f64"))
        out[full] = {"kernel_vs_plain": rel(k, p), "kernel_vs_f64": rel(k, r),
                     "plain_vs_f64": rel(p, r)}
    return {"submodule": key, "side": side, "calls": len(mine), "tensors": out,
            "stages": stages}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=str, default=".exp/mega_step_probe")
    ap.add_argument("--top", type=int, default=6)
    ap.add_argument("--extra_steps", type=int, default=0,
                    help="joint steps before the comparison (train_mega takes 28: "
                         "5 warm, 20 timed, 3 profiled; their sample draws differ)")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--model", type=str, default="",
                    help="model flags added to the config's, as one string")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    device = torch.device("cuda:0" if args.device == "cuda" else args.device)
    smi = "cpu" if device.type != "cuda" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    result = {"device": smi, "extra_steps": args.extra_steps}
    with tempfile.TemporaryDirectory() as tmp:
        step, batch = build_state(Path(tmp), device, args.model.split(), args.extra_steps)
        runs = {ch: cs.joint_step_through(step, batch, device, ch) for ch in CHAINS}
        (lk, gk, ck), (lp, gp, cp), (lr, gr, _) = (runs[c] for c in ("kernel", "plain", "f64"))
        pairs = {"kernel_vs_plain": (gk, gp), "kernel_vs_f64": (gk, gr),
                 "plain_vs_f64": (gp, gr)}
        per = {n: {pair: rel(a[n], b[n]) for pair, (a, b) in pairs.items()} for n in gp}
        top = sorted(per, key=lambda n: -per[n]["kernel_vs_plain"])[:args.top]
        result["step"] = {
            "loss": {"kernel": lk, "plain": lp, "f64": lr},
            "worst_kernel_vs_plain": [(n, per[n]) for n in top],
            "worst_of_each_pair": {pair: max((v[pair], n) for n, v in per.items())
                                   for pair in pairs},
            "tensors_over_1e-2": {pair: sum(v[pair] > 1e-2 for v in per.values())
                                  for pair in pairs}}
        worst = top[0]
        diff = (gk[worst] - gp[worst]).abs()
        at = divmod(int(diff.argmax()), diff.shape[-1]) if diff.dim() == 2 else int(diff.argmax())
        flat = int(diff.argmax())
        result["step"]["worst_element"] = {
            "tensor": worst, "index": at,
            "kernel": gk[worst].flatten()[flat].item(), "plain": gp[worst].flatten()[flat].item(),
            "f64": gr[worst].flatten()[flat].item(),
            "tensor_norm_f64": gr[worst].norm().item()}
        # The same two steps with every ray origin moved by one f32 ulp: how
        # far an equally valid input moves each chain's gradients.
        nudged = dict(batch)
        rays = batch["rays"].clone()
        rays[:, :3] = torch.nextafter(rays[:, :3], torch.full_like(rays[:, :3], float("inf")))
        nudged["rays"] = rays
        result["step"]["ray_origins_one_ulp"] = {}
        for ch, base in (("kernel", gk), ("plain", gp)):
            _, gn, _ = cs.joint_step_through(step, nudged, device, ch)
            errs = {n: rel(gn[n], base[n]) for n in base}
            result["step"]["ray_origins_one_ulp"][ch] = {
                "worst": max((v, n) for n, v in errs.items()),
                "tensors_over_1e-2": sum(v > 1e-2 for v in errs.values()),
                top[0]: errs[top[0]]}
        print(json.dumps({"step": result["step"]}), flush=True)
        inputs = []
        for a, b in zip(ck, cp):
            row = {"key": a["key"], "points": [int(a["xyz"].shape[0]), int(b["xyz"].shape[0])]}
            if a["key"] == b["key"] and a["xyz"].shape == b["xyz"].shape:
                row["xyz_max_abs_diff"] = (a["xyz"] - b["xyz"]).abs().max().item()
                row["g_rel"] = rel(a["g"], b["g"])
            inputs.append(row)
        result["inputs"] = {"calls": [len(ck), len(cp)], "rows": inputs}
        print(json.dumps({"inputs": result["inputs"]}), flush=True)
        keys = sorted({".".join(n.split(".")[:2]) for n in top})
        result["replay"] = [replay(k, ck, top) for k in keys]
        for r in result["replay"]:
            print(json.dumps({"replay": r}), flush=True)
    (out / "mega_step_probe.json").write_text(json.dumps(result, indent=1))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
