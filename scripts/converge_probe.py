"""Training-quality variants of the ring scene at the paper config, on the card.

    python3 scripts/converge_probe.py [--steps 1250] [--out DIR] VARIANT [VARIANT ...]

The port's `scripts/convergence_run` trains cell 0 of a 2x1 grid on the
analytic ring scene (`data/synthetic.py`: 28 train and 2 val views of
128x128). This probe trains `Runner.train` on the same scene and masks
under variations of one run, each from scratch for `--steps` steps with
the lr decaying over them, and reports the train PSNR every 100 steps and
the right-half val PSNR of each val view at the end.

A VARIANT is `name:mask:seed[:opts]`:

- mask: `none` (every ray), a cell of the grid (`0`, `1`), or a cell
  with some views' masks replaced by all-ones masks (`0~12-15`: cell 0,
  views 12 to 15 whole);
- seed: `--random_seed` (the init, the batch order and the sample draws);
- opts, joined by `+`: `f32` (f32 compute: the f32 kernels), `fs` (the
  parquet chunk store, as `convergence_run`; the in-memory dataset
  otherwise), `untruncated` (the weights drawn from an untruncated
  normal of variance 1/fan_in, the port's init before it took flax's
  truncated LeCun normal), `jaxinit` (the JAX package's own draw for this
  seed: `--jax_init DIR` holds `seed{seed}.pt` from `scripts/jax_init_export.py`),
  `img` (after training, each training view's PSNR over the
  pixels it trained on, and over the whole view).

Writes one JSON line per variant to stdout and `{out}/results.json` with
the card's name and power limit; `{out}/ds` and `{out}/masks` hold the
scene and the masks as the card made them.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import mega_nerf_tpu_torch.runtime.runner as runner_mod  # noqa: E402
from mega_nerf_tpu_torch.data.torch_io import load_mask_zip, save_mask_zip  # noqa: E402
from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts  # noqa: E402
from mega_nerf_tpu_torch.scripts import convergence_run as cvr  # noqa: E402

PORT_INIT = runner_mod.init_weights


def untruncated_init(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Every weight an untruncated normal of variance 1/fan_in, zero
    biases (the port's init before it drew flax's truncated LeCun normal)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator) / p.shape[-1] ** 0.5)


def jax_init(path: Path, fg_seed: int):
    """An `init_weights` that loads the JAX package's draw from `path`
    (the fg module is the one seeded with `--random_seed`)."""
    states = torch.load(path)

    def load(module: torch.nn.Module, generator: torch.Generator) -> None:
        side = "fg" if generator.initial_seed() == fg_seed else "bg"
        module.load_state_dict(states[side])
    return load


def mask_dir(masks: Path, token: str) -> Path:
    """The mask directory of `token` (`0`, or `0~12-15`), made on first use."""
    if "~" not in token:
        return masks / token
    cell, views = token.split("~")
    lo, hi = (int(v) for v in views.split("-"))
    out = masks / token.replace("~", "_")
    if not out.exists():
        out.mkdir()
        for f in sorted((masks / cell).iterdir()):
            m = np.asarray(load_mask_zip(f))
            save_mask_zip(np.ones_like(m) if lo <= int(f.stem) <= hi else m, out / f.name)
    return out


def per_view_psnr(runner) -> list:
    """(view, PSNR over the pixels it trained on, PSNR over the view, pixels)
    of every training view (a val view trains on its left half)."""
    rows = []
    with torch.no_grad():
        for item in runner.train_items:
            pred = runner.render_image(item)["rgb_fine"].reshape(item.H, item.W, 3)
            gt = item.load_image().astype(np.float32) / 255.0
            m = item.load_mask()
            m = np.ones(gt.shape[:2], bool) if m is None else np.asarray(m, bool).copy()
            if item.is_val:
                m[:, item.W // 2:] = False
            err = ((pred - gt) ** 2).mean(-1)
            rows.append((item.image_index, round(float(-10 * np.log10(err[m].mean())), 2),
                         round(float(-10 * np.log10(err.mean())), 2), int(m.sum())))
    return rows


def run_variant(work: Path, ds: Path, masks: Path, spec: str, steps: int,
                device: str, model_args, jax_dir=None) -> dict:
    name, mask, seed, *rest = spec.split(":")
    opts = set(rest[0].split("+")) if rest else set()
    parser = get_opts_base()
    parser.add_argument("--exp_name", type=str, default=str(work / name))
    parser.add_argument("--dataset_path", type=str, default=str(ds))
    data = (["--dataset_type", "filesystem", "--chunk_paths", str(work / f"chunks_{name}"),
             "--num_chunks", "8"] if "fs" in opts else ["--dataset_type", "memory"])
    hp = parse_opts(parser, [
        "--near", "0.5", "--ray_altitude_range", "-2.0", "2.0", *model_args,
        "--lr", "5e-4", "--lr_decay_factor", "0.1", *data,
        "--train_iterations", str(steps), "--ckpt_interval", str(steps),
        "--val_interval", str(steps), "--val_scale_factor", "1", "--random_seed", seed,
        "--compute_dtype", "float32" if "f32" in opts else "bfloat16", "--device", device,
        *([] if mask == "none" else ["--cluster_mask_path", str(mask_dir(masks, mask))]),
    ])
    runner_mod.init_weights = (
        untruncated_init if "untruncated" in opts
        else jax_init(Path(jax_dir) / f"seed{seed}.pt", int(seed)) if "jaxinit" in opts
        else PORT_INIT)
    t0 = time.perf_counter()
    try:
        runner = runner_mod.Runner(hp)
        runner.train()
    finally:
        runner_mod.init_weights = PORT_INIT
    seconds = time.perf_counter() - t0
    exp = cvr.latest_experiment(hp.exp_name)
    rows = [json.loads(line) for line in open(exp / "tb" / "metrics.jsonl")]
    val = {}
    for r in rows:  # the last validation's views (no-mask runs validate twice)
        val.update({k: round(v, 3) for k, v in r.items() if k.startswith("val/psnr/")})
    return {"variant": spec,
            "train_psnr": [(r["step"], round(r["train/psnr"], 2)) for r in rows
                           if "train/psnr" in r],
            "val_psnr": [val[k] for k in sorted(val)],
            "per_view": per_view_psnr(runner) if "img" in opts else None,
            "seconds": round(seconds, 1)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--steps", type=int, default=1250)
    ap.add_argument("--out", type=str, default=".exp/converge_probe")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--jax_init", type=str, default=None,
                    help="directory of scripts/jax_init_export.py's files (jaxinit)")
    ap.add_argument("--model", type=str, default=None,
                    help="model flags in place of convergence_run.PAPER_ARGS, as "
                         "one string (--model='--layers 2 ...': a tiny width for a "
                         "dry run on the CPU)")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip() if args.device == "cuda" \
        else "cpu"
    model_args = cvr.PAPER_ARGS if args.model is None else args.model.split()
    results = {"device": smi, "steps": args.steps, "variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        ds, masks = work / "ds", work / "masks"
        cvr.build_scene(ds, "ring", 28, 2, args.hw, args.device)
        cvr.build_masks(ds, masks, cvr.MASK_GRID, args.device)
        shutil.copytree(ds, out / "ds", dirs_exist_ok=True)
        shutil.copytree(masks, out / "masks", dirs_exist_ok=True)
        for spec in args.variants:
            row = run_variant(work, ds, masks, spec, args.steps, args.device, model_args,
                              args.jax_init)
            results["variants"][spec.split(":")[0]] = row
            print(json.dumps(row), flush=True)
    (out / "results.json").write_text(json.dumps(results, indent=1))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
