"""Peak device memory and ms a step of a few training steps, without and
with `--remat`, at a config's own width.

    python -m mega_nerf_tpu_torch.scripts.remat_steps \
        --config_file configs/mega-nerf-dense/building.yaml [--steps 3]

Seeded random weights and seeded random batches of `--batch_size` rays
(origins near the scene's centre, half of the rays running past the
foreground into the background) stand in for a dataset; the train step is
`parallel/train_step.py::TrainStep` at the config's samples. Each run
starts from the same weights. A run that exhausts the card's memory prints
the allocator's message (the size of the request that failed) and the
peak reached. Prints one line a run and a JSON line of both.
"""

from __future__ import annotations

import copy
import json
import subprocess
import time
from argparse import Namespace

import torch

from mega_nerf_tpu_torch.models import init_weights, make_bg_nerf, make_nerf
from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts
from mega_nerf_tpu_torch.parallel.train_step import TrainStep
from mega_nerf_tpu_torch.render.rendering import RenderSettings
from mega_nerf_tpu_torch.runtime.runner import resolve_device


def get_remat_opts(args=None) -> Namespace:
    parser = get_opts_base()
    parser.add_argument('--steps', type=int, default=3,
                        help='timed steps, after one warm-up step')
    return parse_opts(parser, args, known_only=True)


def random_batch(n: int, gen: torch.Generator, device) -> dict:
    o = (torch.rand((n, 3), generator=gen) - 0.5) * 0.3
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen), dim=-1)
    far = torch.where(torch.arange(n)[:, None] % 2 == 0, 1e5, 0.8)
    rays = torch.cat([o, d, torch.full((n, 1), 0.05), far], -1)
    return {"rays": rays.to(device), "rgbs": torch.rand((n, 3), generator=gen).to(device),
            "img_indices": torch.randint(0, 4, (n,), generator=gen).to(device)}


def run(hp: Namespace, remat: bool, start, device) -> dict:
    """One warm-up and `--steps` timed steps from the weights `start`."""
    hp = copy.copy(hp)
    hp.remat = remat
    fg = make_nerf(hp, 4)
    bg = make_bg_nerf(hp, 4) if hp.bg_nerf else None
    for bundle, state in zip((fg, bg), start):
        if bundle is not None:
            bundle.module.load_state_dict(state)
            bundle.module.to(device)
    center = torch.zeros(3, device=device) if bg is not None else None
    radius = torch.ones(3, device=device) if bg is not None else None
    step = TrainStep(fg, bg, RenderSettings.from_hparams(hp), hp.lr, hp.lr_decay_factor,
                     hp.train_iterations, center, radius)
    gen = torch.Generator().manual_seed(hp.random_seed)
    batches = [random_batch(hp.batch_size, gen, device) for _ in range(hp.steps + 1)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    out = {"remat": remat, "layer_dim": hp.layer_dim, "batch_size": hp.batch_size}
    done = 0
    try:
        step(batches[0])
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for b in batches[1:]:
            loss = step(b)["loss"]
            done += 1
        out["loss"] = float(loss)
        out["step_ms"] = (time.perf_counter() - t0) / hp.steps * 1e3
    except torch.cuda.OutOfMemoryError as e:
        out["error"] = str(e).splitlines()[0]
        out["steps_done"] = done
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    del step, fg, bg, batches
    torch.cuda.empty_cache()
    return out


def main(hp: Namespace) -> list:
    device = resolve_device(hp.device)
    gen = torch.Generator().manual_seed(hp.random_seed)
    start = []
    for make in (make_nerf, make_bg_nerf):
        bundle = make(hp, 4)
        init_weights(bundle.module, gen)
        start.append({k: v.clone() for k, v in bundle.module.state_dict().items()})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip().splitlines()[:1]
    smi = smi[0] if smi else torch.cuda.get_device_name(device)
    results = []
    for remat in (False, True):
        res = run(hp, remat, start, device)
        print(f"{hp.config_file}, layer_dim {hp.layer_dim}/{hp.bg_layer_dim}, "
              f"{'with' if remat else 'without'} --remat on {smi}: {res}", flush=True)
        results.append(res)
    print(json.dumps({"remat_steps": results}))
    return results


if __name__ == '__main__':
    main(get_remat_opts())
