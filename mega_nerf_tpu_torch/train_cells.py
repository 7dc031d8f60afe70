"""Grid training entry point: every submodule of a Mega-NeRF in one run.

    python -m mega_nerf_tpu_torch.train_cells --config_file configs/mega-nerf/building.yaml \
        --exp_name exps/building-sub --dataset_path <scene> \
        --cluster_mask_path <masks> [--dataset_type filesystem --chunk_paths <dir>]

Counterpart of the JAX package's `train_cells.py` (`--device`, default
cuda; cuda without a card raises). Under torchrun, `--cell_axis C
--data_axis D` spreads the cells over C groups of D ranks
(`runtime/cell_runner.py`). `--cluster_mask_path`
is the masks ROOT written by `scripts/create_cluster_masks.py` (params.pt
and the per-cell directories 0..K-1); `--exp_name` is the per-cell prefix:
cell i writes `{exp_name}{i}/{version}/models/{iter}.pt`, which
`scripts/merge_submodules.py --ckpt_prefix {exp_name}` reads. `--ckpt_path`
to any one cell's `{iter}.pt`, or to the JAX package's `{iter}.ckpt` of a
cell, resumes every cell of the grid.
`--detect_anomalies` turns on torch autograd anomaly mode.
"""

from __future__ import annotations

from argparse import Namespace

import torch

from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts
from mega_nerf_tpu_torch.parallel.distributed import init_from_env
from mega_nerf_tpu_torch.runtime.cell_runner import CellRunner


def get_train_cells_opts(args=None) -> Namespace:
    parser = get_opts_base()
    parser.add_argument('--exp_name', type=str, required=True,
                        help='per-cell experiment prefix: cell i writes {exp_name}{i}/')
    parser.add_argument('--dataset_path', type=str, required=True)
    return parse_opts(parser, args)


def main(hparams: Namespace) -> None:
    if hparams.cluster_mask_path is None:
        raise ValueError(
            "cell-parallel training needs --cluster_mask_path (the masks root "
            "written by scripts/create_cluster_masks.py)")
    init_from_env(hparams.device)
    torch.autograd.set_detect_anomaly(bool(hparams.detect_anomalies))
    CellRunner(hparams).train()


if __name__ == '__main__':
    main(get_train_cells_opts())
