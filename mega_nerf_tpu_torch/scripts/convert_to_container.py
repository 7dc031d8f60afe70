"""Wrap one `{iter}.pt` as a one-submodule container (centroid at the origin).

    python -m mega_nerf_tpu_torch.scripts.convert_to_container --config_file ... \
        --ckpt_path <run>/models/<iter>.pt --output single.pt [--torchscript]

Counterpart of the JAX package's `scripts/convert_to_container.py`; ends
with the same forward pass of ones as `merge_submodules`.
"""

from __future__ import annotations

from argparse import Namespace
from pathlib import Path

import numpy as np

from mega_nerf_tpu_torch.models.container import ContainerData
from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts
from mega_nerf_tpu_torch.scripts.merge_submodules import (
    load_submodule_states,
    write_container,
)


def get_convert_opts(args=None) -> Namespace:
    parser = get_opts_base()
    parser.add_argument('--output', type=str, required=True)
    parser.add_argument('--torchscript', default=False, action='store_true')
    return parse_opts(parser, args, known_only=True)


def main(hparams: Namespace) -> None:
    if hparams.ckpt_path is None:
        raise ValueError("convert_to_container needs --ckpt_path")
    fg_state, bg_state = load_submodule_states(Path(hparams.ckpt_path), hparams)
    write_container(ContainerData(
        centroids=np.zeros((1, 3), np.float32),
        grid_dim=(1, 1),
        min_position=np.zeros(3, np.float32),
        max_position=np.ones(3, np.float32),
        need_viewdir=hparams.pos_dir_dim > 0,
        need_appearance_embedding=hparams.appearance_dim > 0,
        cluster_2d=False,
        fg_states=[fg_state],
        bg_states=[bg_state] if bg_state is not None else [],
    ), hparams)


if __name__ == '__main__':
    main(get_convert_opts())
