"""Merge per-submodule training runs into one Mega-NeRF container.

    python -m mega_nerf_tpu_torch.scripts.merge_submodules --config_file ... \
        --ckpt_prefix <dir>/submodule_ --centroid_path <masks>/params.pt \
        --output merged.pt [--torchscript]

Counterpart of the JAX package's `scripts/merge_submodules.py`. For each
centroid i it takes the newest experiment version under
`{ckpt_prefix}{i}/` holding `models/{train_iterations}.pt` (the reference
`{iter}.pt`, as the port's and the reference's trainers write it) or the
JAX package's `{iter}.ckpt` (its weights, read without flax or msgpack by
`runtime/checkpoints.py::load_checkpoint`), reads the fg (and bg)
state dicts, and writes the native container with the centroid metadata
of create_cluster_masks' `params.pt`; with `--torchscript` also the
viewer's TorchScript container at `<output>.ts`. It ends with a forward
pass of ones through the merged mixtures, on the CPU.
"""

from __future__ import annotations

from argparse import Namespace
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mega_nerf_tpu_torch.data.torch_io import load_pt
from mega_nerf_tpu_torch.models.container import (
    ContainerData,
    container_to_bundles,
    save_native_container,
    save_torchscript_container,
)
from mega_nerf_tpu_torch.models.factory import ModelBundle
from mega_nerf_tpu_torch.models.mega import cluster_weights, mega_apply
from mega_nerf_tpu_torch.models.weights import strip_module_prefix
from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts
from mega_nerf_tpu_torch.runtime.checkpoints import load_checkpoint


def get_merge_opts(args=None) -> Namespace:
    parser = get_opts_base()
    parser.add_argument('--ckpt_prefix', type=str, required=True)
    parser.add_argument('--centroid_path', type=str, required=True)
    parser.add_argument('--output', type=str, required=True)
    parser.add_argument('--torchscript', default=False, action='store_true',
                        help='also write a TorchScript container for the viewer')
    return parse_opts(parser, args, known_only=True)


def load_submodule_states(checkpoint_path: Path, hparams: Namespace
                          ) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, np.ndarray]]]:
    """A `{iter}.pt`, or the JAX package's `.ckpt`, -> (fg state, bg state
    or None) as reference-named numpy dicts. For a `.ckpt` the hparams give
    the models' structure and the payload its appearance rows."""
    loaded = load_checkpoint(checkpoint_path, hparams)

    def numpy_state(key):
        state = loaded.get(key)
        return None if state is None else {
            k: np.asarray(v) for k, v in strip_module_prefix(state).items()}

    return numpy_state("model_state_dict"), numpy_state("bg_model_state_dict")


def find_checkpoint(centroid_path: Path, train_iterations: int) -> Path:
    """The newest version directory holding the final-iteration `{iter}.pt`
    (or `.ckpt`)."""
    if not centroid_path.exists():
        raise FileNotFoundError(f"{centroid_path} not found")
    versions = sorted((int(x.name) for x in centroid_path.iterdir() if x.name.isdigit()),
                      reverse=True)
    for version in versions:
        models = centroid_path / str(version) / "models"
        for suffix in (".pt", ".ckpt"):
            ckpt = models / f"{train_iterations}{suffix}"
            if ckpt.exists():
                return ckpt
    raise FileNotFoundError(f"no {train_iterations}.pt/.ckpt under {centroid_path}")


def mixture_forward(bundle: ModelBundle, xyz: torch.Tensor, dirs, idx) -> torch.Tensor:
    """The mixture's eager forward on the CPU: (N, 3 [+ routing 3]) points
    -> (N, 4) [rgb, sigma]."""
    points = xyz[:, 3:] if bundle.xyz_real else xyz
    weights = cluster_weights(xyz[:, :3], bundle.centroids, bundle.boundary_margin,
                              bundle.cluster_dim_start)
    with torch.no_grad():
        return mega_apply(lambda k: bundle.module[k](points, dirs, idx), weights)


def smoke_forward(data: ContainerData, hparams: Namespace) -> None:
    """A forward pass of ones through the merged fg (and bg) mixture."""
    fg, bg = container_to_bundles(data, hparams)
    dirs = torch.ones((1, 3)) if fg.config.pos_dir_dim > 0 else None
    idx = torch.zeros((1,), dtype=torch.long) if fg.config.appearance_dim > 0 else None
    print(f"fg test eval: {mixture_forward(fg, torch.ones((1, 3)), dirs, idx)}")
    if bg is not None:
        print(f"bg test eval: {mixture_forward(bg, torch.ones((1, 7)), dirs, idx)}")


def write_container(data: ContainerData, hparams: Namespace) -> None:
    """The native container at --output, and with --torchscript the
    viewer's at `<output>.ts`; then the smoke forward."""
    save_native_container(hparams.output, data)
    print(f"Wrote native container to {hparams.output}")
    if hparams.torchscript:
        ts_path = f"{hparams.output}.ts"
        save_torchscript_container(ts_path, data, hparams)
        print(f"Wrote TorchScript container to {ts_path}")
    smoke_forward(data, hparams)


def main(hparams: Namespace) -> None:
    ckpt_prefix = Path(hparams.ckpt_prefix)
    centroid_metadata = load_pt(hparams.centroid_path)
    centroids = np.asarray(centroid_metadata["centroids"], np.float32)

    fg_states, bg_states = [], []
    for i in range(len(centroids)):
        ckpt = find_checkpoint(ckpt_prefix.parent / f"{ckpt_prefix.name}{i}",
                               hparams.train_iterations)
        print(f"centroid {i}: {ckpt}")
        fg_state, bg_state = load_submodule_states(ckpt, hparams)
        fg_states.append(fg_state)
        if bg_state is not None:
            bg_states.append(bg_state)

    write_container(ContainerData(
        centroids=centroids,
        grid_dim=tuple(int(x) for x in centroid_metadata["grid_dim"]),
        min_position=np.asarray(centroid_metadata["min_position"], np.float32),
        max_position=np.asarray(centroid_metadata["max_position"], np.float32),
        need_viewdir=hparams.pos_dir_dim > 0,
        need_appearance_embedding=hparams.appearance_dim > 0,
        cluster_2d=bool(centroid_metadata["cluster_2d"]),
        fg_states=fg_states,
        bg_states=bg_states,
    ), hparams)


if __name__ == '__main__':
    main(get_merge_opts())
