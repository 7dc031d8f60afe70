"""Worker of the port's multi-process CPU tests, and the launcher they use.

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/torch_multiprocess_worker.py <two|cells> <workdir>

Each rank joins a gloo process group through the port's entry points (their
`init_from_env`), drives the multi-process paths on tiny models with
`--device cpu`, and writes what the parent test checks to
`{workdir}/result_{rank}.json`. It imports the port only, never JAX.

- `two` (`tests/test_torch_multiprocess.py`, 2 ranks): the data-parallel
  `Runner.train` without perturbation or sigma noise (run `a`), a step whose
  background rays all fall in rank 0's half, both chunk-store feeding
  modes, a run cut at step 2 and resumed to step 4 (runs `e` and `e_resumed`,
  with perturbation and noise), `create_cluster_masks` and
  `render_images` over both ranks.
- `cuda_step` (`tests/test_torch_cuda.py`, 2 ranks on the card): one
  data-parallel step's averaged gradients through the training kernels
  beside one process's kernel step on the whole batch.
- `cells` (`tests/test_torch_multiprocess_cells.py`, 4 ranks): `train_cells`
  at cell 2 x data 2 from the memory dataset (`grid`), a resume from its
  step 2 (`grid_resumed`), the merge of the written cells; cell 4 x data 1
  from process-private filesystem stores (rank 3 holds only a padding
  cell); the layouts that must raise.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# The port's tiny model: fg and bg 4 x 32, 4-d appearance, f32.
MODEL_ARGS = [
    "--near", "0.5", "--coarse_samples", "16", "--fine_samples", "24",
    "--pos_xyz_dim", "6", "--pos_dir_dim", "2", "--layers", "4",
    "--skip_layers", "2", "--layer_dim", "32", "--bg_layer_dim", "32",
    "--appearance_dim", "4", "--compute_dtype", "float32",
    "--val_scale_factor", "1", "--ray_altitude_range", "-1.0", "1.0",
]
TRAIN_ARGS = ["--dataset_type", "memory", "--batch_size", "64", "--lr", "1e-3",
              "--val_interval", "100000", "--device", "cpu"]
MASK_ARGS = ["--grid_dim", "1", "3", "--ray_samples", "32", "--near", "0.5",
             "--far", "3.5", "--ray_altitude_range", "-1.0", "1.0", "--device", "cpu"]


def train_args(ds, exp, steps, extra=()):
    return (["--dataset_path", str(ds), "--exp_name", str(exp), *MODEL_ARGS, *TRAIN_ARGS,
             "--train_iterations", str(steps), "--ckpt_interval", "2", *extra])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(mode: str, workdir: Path, nproc: int, timeout: float = 600):
    """Start `nproc` ranks of `mode` and wait for all -> their results. A
    rank that fails stops the others and fails the call with its output."""
    port = free_port()
    procs = []
    for r in range(nproc):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(nproc), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(nproc), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        log = open(workdir / f"log_{r}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, mode, str(workdir)], stdout=log,
            stderr=subprocess.STDOUT, env=env, cwd=str(workdir)), log))
    deadline = time.monotonic() + timeout
    failed = None
    while any(p.poll() is None for p, _ in procs):
        failed = next((r for r, (p, _) in enumerate(procs)
                       if p.poll() not in (None, 0)), None)
        if failed is not None or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    for p, log in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        log.close()
    if failed is None:
        failed = next((r for r, (p, _) in enumerate(procs) if p.returncode != 0), None)
    if failed is not None:
        out = (workdir / f"log_{failed}.txt").read_text()[-6000:]
        raise AssertionError(f"rank {failed} of {mode} failed:\n{out}")
    return [json.loads((workdir / f"result_{r}.json").read_text()) for r in range(nproc)]


# ------------------------------------------------------------------- ranks

def state_hash(*modules) -> str:
    h = hashlib.sha256()
    for m in modules:
        if m is None:
            continue
        for k, v in m.state_dict().items():
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def no_sigma_noise():
    """Training settings without sigma noise, for the parity runs (the JAX
    package's one draw over the global batch cannot be reproduced by two
    generators)."""
    from mega_nerf_tpu_torch.render.rendering import RenderSettings

    real = RenderSettings.from_hparams.__func__

    def from_hparams(cls, hparams, **overrides):
        return real(cls, hparams, **{"sigma_noise": False, **overrides})

    RenderSettings.from_hparams = classmethod(from_hparams)
    return lambda: setattr(RenderSettings, "from_hparams", classmethod(real))


def split_rays(n: int, far: float, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    o = (rng.uniform(-0.15, 0.15, size=(n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return np.concatenate([o, d, np.full((n, 1), 0.05, np.float32),
                           np.full((n, 1), far, np.float32)], -1)


def row_ids(rays) -> set:
    import numpy as np

    rows = np.ascontiguousarray(rays).view(np.uint8).reshape(rays.shape[0], -1)
    return [hashlib.sha256(r.tobytes()).hexdigest()[:16] for r in rows]


def stream_check(runner, chunk_dir: Path):
    """Three epochs of the store at global batch 64 -> (per-epoch batch
    counts of every rank, rows seen by more than one rank)."""
    import numpy as np

    from mega_nerf_tpu_torch.data.filesystem_dataset import FilesystemDataset
    from mega_nerf_tpu_torch.parallel import distributed

    fs = FilesystemDataset(runner.train_items, runner.near, runner.far,
                           runner.ray_altitude_range, True, [chunk_dir], num_chunks=4,
                           scale_factor=1, disk_flush_size=10 ** 7,
                           rng=np.random.default_rng(0))
    counts, overlaps = [], []
    try:
        for epoch in range(3):
            ids, n = [], 0
            for batch in fs.batches(64, np.random.default_rng((0, epoch))):
                assert batch["rays"].shape[0] == 32, batch["rays"].shape
                ids += row_ids(batch["rays"])
                n += 1
            every = distributed.all_gather_object((n, ids))
            counts.append([c for c, _ in every])
            seen = [i for _, rows in every for i in rows]
            overlaps.append(len(seen) - len(set(seen)))
    finally:
        fs.close()
    return counts, overlaps, fs._shard_chunks


def run_two(workdir: Path, rank: int) -> dict:
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import train as port_train
    from mega_nerf_tpu_torch.data.torch_io import load_pt, save_pt
    from mega_nerf_tpu_torch.parallel import distributed
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render.rendering import RenderSettings
    from mega_nerf_tpu_torch.runtime.runner import Runner
    from mega_nerf_tpu_torch.scripts import create_cluster_masks as ccm
    from mega_nerf_tpu_torch.scripts import render_images

    ds = workdir / "ds"
    out = {}

    # (a) data parallel, no perturbation, no noise; (c) strided validation.
    restore = no_sigma_noise()
    try:
        hp = port_train.get_train_opts(train_args(
            ds, workdir / "exp_a", 2, ["--perturb", "0", "--ckpt_interval", "1"]))
        runner = Runner(hp)
        out["a_val"] = runner.train()
    finally:
        restore()
    out["a_hash"] = state_hash(runner.fg.module, runner.bg.module)
    out["backend"] = distributed.backend()
    out["experiment_path"] = None if runner.experiment_path is None else str(
        runner.experiment_path)

    # (b) a step whose background rays are all in rank 0's half.
    settings = RenderSettings.from_hparams(hp, perturb=0.0, sigma_noise=False)
    step = TrainStep(runner.fg, runner.bg, settings, 1e-3, 0.1, 10, runner.sphere_center,
                     runner.sphere_radius, group=distributed.world_group())
    rays = split_rays(16, 1e5 if rank == 0 else 0.8, seed=rank)
    batch = {"rays": torch.from_numpy(rays),
             "rgbs": torch.full((16, 3), 0.5),
             "img_indices": torch.zeros(16, dtype=torch.long)}
    bg_before = state_hash(runner.bg.module)
    _, _, local_bg = step.loss(batch, None)
    out["b_local_bg"] = bool(local_bg)
    step(batch)
    out["b_bg_moved"] = state_hash(runner.bg.module) != bg_before
    out["b_hash"] = state_hash(runner.fg.module, runner.bg.module)
    out["b_bg_steps"] = step.bg_sched.last_epoch

    # (d) both feeding modes of a shared chunk store.
    counts, overlaps, shard = stream_check(runner, workdir / "chunks_shard")
    out["d_stream"] = {"counts": counts, "overlaps": overlaps, "per_rank": shard}
    if rank == 0:
        shutil.copytree(workdir / "chunks_shard", workdir / "chunks_legacy")
        stamp = load_pt(workdir / "chunks_legacy" / "metadata.pt")
        del stamp["chunk_rows"]
        save_pt(stamp, workdir / "chunks_legacy" / "metadata.pt")
    distributed.barrier("legacy_store")
    counts, overlaps, shard = stream_check(runner, workdir / "chunks_legacy")
    out["d_shared"] = {"counts": counts, "overlaps": overlaps, "per_rank": shard}

    # (e) cut at 2, resumed to 4, with perturbation and noise.
    full = Runner(port_train.get_train_opts(train_args(ds, workdir / "exp_e", 4)))
    full.train()
    out["e_hash"] = state_hash(full.fg.module, full.bg.module)
    resumed = Runner(port_train.get_train_opts(train_args(
        ds, workdir / "exp_e", 4,
        ["--ckpt_path", str(workdir / "exp_e" / "0" / "models" / "2.pt")])))
    resumed.train()
    out["e_resumed_hash"] = state_hash(resumed.fg.module, resumed.bg.module)

    # (f) masks over both ranks; (g) frames over both ranks.
    ccm.main(ccm.get_mask_opts(["--dataset_path", str(ds), "--output",
                                str(workdir / "masks"), *MASK_ARGS]))
    render_images.main(render_images.get_render_opts(
        ["--dataset_path", str(ds), *MODEL_ARGS, "--device", "cpu",
         "--ckpt_path", str(workdir / "exp_e" / "0" / "models" / "4.pt"),
         "--centroids_path", str(workdir / "masks" / "params.pt"),
         "--input", str(workdir / "poses"), "--output", str(workdir / "frames")]))
    return out


# ---------------------------------------------------------------- the grid

GRID_ARGS = ["--ray_altitude_range", "-1.0", "1.0"]


def cell_args(ds, masks, exp, steps, extra=()):
    return ["--dataset_path", str(ds), "--exp_name", str(exp), "--cluster_mask_path",
            str(masks), *MODEL_ARGS, *TRAIN_ARGS, "--perturb", "0", "--far", "3.5",
            "--train_iterations", str(steps), "--ckpt_interval", "2", *extra]


def run_cells(workdir: Path, rank: int) -> dict:
    from mega_nerf_tpu_torch import train_cells
    from mega_nerf_tpu_torch.parallel import distributed
    from mega_nerf_tpu_torch.runtime.cell_runner import CellRunner
    from mega_nerf_tpu_torch.scripts import create_cluster_masks as ccm
    from mega_nerf_tpu_torch.scripts import merge_submodules

    ds, masks = workdir / "ds", workdir / "masks"
    ccm.main(ccm.get_mask_opts(["--dataset_path", str(ds), "--output", str(masks),
                                *MASK_ARGS]))
    out = {}

    # cell 2 x data 2 from memory: rank 0-1 hold cells 0, 1; ranks 2-3
    # cell 2 and padding cell 3.
    val_calls = []
    real_val = CellRunner._run_validation

    def recording(self, train_index, key_prefix="val"):
        metrics = real_val(self, train_index, key_prefix)
        val_calls.append([key_prefix, metrics])
        return metrics

    CellRunner._run_validation = recording
    restore = no_sigma_noise()
    try:
        full = CellRunner(train_cells.get_train_cells_opts(cell_args(
            ds, masks, workdir / "grid" / "sub", 4,
            ["--cell_axis", "2", "--data_axis", "2", "--val_interval", "2"])))
        full.train()
        CellRunner._run_validation = real_val
        resumed = CellRunner(train_cells.get_train_cells_opts(cell_args(
            ds, masks, workdir / "grid" / "sub", 4,
            ["--cell_axis", "2", "--data_axis", "2", "--ckpt_path",
             str(workdir / "grid" / "sub1" / "0" / "models" / "2.pt")])))
        resumed.train()
    finally:
        restore()
        CellRunner._run_validation = real_val
    out["val_calls"] = val_calls
    out["grid_cells"] = [s.index for s in full.cells]
    out["grid_group"] = [full.group_index, full.data_index]
    out["grid_hashes"] = [state_hash(s.fg.module, s.bg.module) for s in full.cells]
    out["grid_resumed_hashes"] = [state_hash(s.fg.module, s.bg.module)
                                  for s in resumed.cells]

    if rank == 0:
        merge_submodules.main(merge_submodules.get_merge_opts(
            ["--dataset_path", str(ds), *MODEL_ARGS, "--device", "cpu",
             "--ckpt_prefix", str(workdir / "grid" / "sub"),
             "--centroid_path", str(masks / "params.pt"),
             "--output", str(workdir / "merged.pt"), "--train_iterations", "4"]))
    distributed.barrier("merged")

    # cell 4 x data 1 from process-private filesystem stores: rank 3 holds
    # only padding cell 3.
    fs = ["--dataset_type", "filesystem", "--chunk_paths",
          str(workdir / f"chunks_{rank}"), "--num_chunks", "2"]
    hp = train_cells.get_train_cells_opts(cell_args(
        ds, masks, workdir / "fs" / "sub", 2, ["--cell_axis", "4", *fs]))
    runner = CellRunner(hp)
    runner.train()
    out["fs_cells"] = [s.index for s in runner.cells]
    chunks = workdir / f"chunks_{rank}"
    out["fs_stores"] = sorted(p.name for p in chunks.iterdir()) if chunks.exists() else []
    out["fs_finite"] = all(bool(v.isfinite().all()) for s in runner.cells
                           for v in s.fg.module.state_dict().values())

    # Layouts that raise, the same on every rank.
    raised = {}
    for name, extra in (("fs_data_axis", ["--cell_axis", "2", "--data_axis", "2", *fs]),
                        ("world", ["--cell_axis", "3"])):
        try:
            CellRunner(train_cells.get_train_cells_opts(cell_args(
                ds, masks, workdir / "raise" / "sub", 2, extra)))
            raised[name] = None
        except ValueError as e:
            raised[name] = str(e)
    out["raised"] = raised
    return out


def run_cuda_step(workdir: Path, rank: int) -> dict:
    """Width 64, paper layout (8 layers, 48-d appearance, bf16), fg + bg:
    each rank's half of a 2,048-ray batch through the training kernels,
    gradients averaged over the ranks; rank 0 also takes one process's
    kernel step on the whole batch."""
    from argparse import Namespace

    import torch

    from mega_nerf_tpu_torch.models import init_weights, make_bg_nerf, make_nerf
    from mega_nerf_tpu_torch.parallel import distributed
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render import fused_train as ft
    from mega_nerf_tpu_torch.render.rendering import RenderSettings

    device = distributed.rank_device("cuda")
    hp = Namespace(pos_xyz_dim=12, pos_dir_dim=4, layers=8, skip_layers=[4], layer_dim=64,
                   bg_layer_dim=64, appearance_dim=48, affine_appearance=False,
                   use_cascade=False, sh_deg=None, shifted_softplus=True,
                   compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    fg, bg = make_nerf(hp, 7), make_bg_nerf(hp, 7)
    for b in (fg, bg):
        init_weights(b.module, gen)
        with torch.no_grad():  # small random biases so no layer starts dead
            for name, p in b.module.named_parameters():
                if name.endswith("bias"):
                    p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        b.module.to(device)
    n = 2048
    o = torch.rand((n, 3), generator=gen) * 0.3 - 0.15
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen), dim=-1)
    far = torch.where(torch.arange(n) % 2 == 0, 1e5, 0.8)[:, None]
    batch = {"rays": torch.cat([o, d, torch.full((n, 1), 0.05), far], -1).to(device),
             "rgbs": torch.rand((n, 3), generator=gen).to(device),
             "img_indices": torch.randint(0, 7, (n,), generator=gen).to(device)}
    center = torch.tensor([0.05, -0.1, 0.0], device=device)
    radius = torch.tensor([1.4, 1.1, 1.2], device=device)
    settings = RenderSettings(coarse_samples=64, fine_samples=128)

    def grads(group, rows):
        step = TrainStep(fg, bg, settings, 1e-3, 0.1, 10, center, radius, group=group)
        step.gradients({k: v[rows] for k, v in batch.items()}, None)
        return {f"{side}.{name}": p.grad.detach().clone()
                for side, b in (("fg", fg), ("bg", bg))
                for name, p in b.module.named_parameters()}

    half = n // distributed.world_size()
    launches = ft.fused_nerf_train_fwd.launches, ft.train_bwd_data.launches, \
        ft.weight_grad.launches
    dp = grads(distributed.world_group(), slice(rank * half, (rank + 1) * half))
    torch.cuda.synchronize(device)
    h = hashlib.sha256()
    for g in dp.values():
        h.update(g.cpu().contiguous().numpy().tobytes())
    out = {"backend": distributed.backend(), "hash": h.hexdigest(),
           "launches": [a - b for a, b in zip(
               (ft.fused_nerf_train_fwd.launches, ft.train_bwd_data.launches,
                ft.weight_grad.launches), launches)]}
    if rank == 0:
        one = grads(None, slice(0, n))
        out["rel"] = {k: ((dp[k].float() - g.float()).norm()
                          / g.float().norm().clamp_min(1e-30)).item()
                      for k, g in one.items()}
    return out


def main() -> None:
    mode, workdir = sys.argv[1], Path(sys.argv[2])
    sys.path.insert(0, str(ROOT))
    # The checks read metrics.jsonl, not TensorBoard's event files, and
    # importing TensorBoard here pulls TensorFlow in (~13 s a process).
    sys.modules["torch.utils.tensorboard"] = None
    import torch

    torch.set_num_threads(1)
    from mega_nerf_tpu_torch.parallel import distributed

    distributed.init_from_env("cuda" if mode == "cuda_step" else "cpu")
    rank = distributed.rank()
    result = {"two": run_two, "cells": run_cells, "cuda_step": run_cuda_step}[mode](
        workdir, rank)
    distributed.barrier("done")
    (workdir / f"result_{rank}.json").write_text(json.dumps(result))
    print(f"rank {rank}: ok", flush=True)


if __name__ == "__main__":
    main()
