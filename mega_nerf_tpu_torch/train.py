"""Training entry point: `python -m mega_nerf_tpu_torch.train --config_file
... --dataset_path ... --exp_name ... --dataset_type memory`.

Counterpart of the JAX package's `train.py`. Runs on `--device` (default
cuda; cuda without a card raises). `--detect_anomalies` turns on torch
autograd anomaly mode. Under torchrun (`torchrun --nproc_per_node N -m
mega_nerf_tpu_torch.train ...`) the N ranks train one model data-parallel
(`runtime/runner.py`). `--ckpt_path` resumes a run from the port's
`{iter}.pt` or from the JAX package's `{iter}.ckpt` (a run moved from a
TPU to the card: weights, Adam states, iteration and stream position).
Training from `--container_path` raises.
"""

from __future__ import annotations

from argparse import Namespace
from typing import Dict

import torch

from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts
from mega_nerf_tpu_torch.parallel.distributed import init_from_env
from mega_nerf_tpu_torch.runtime.runner import Runner


def get_train_opts(args=None) -> Namespace:
    parser = get_opts_base()
    parser.add_argument('--exp_name', type=str, required=True,
                        help='experiment name')
    parser.add_argument('--dataset_path', type=str, required=True)
    return parse_opts(parser, args)


def main(hparams: Namespace) -> Dict[str, float]:
    """Train; returns the final validation metrics (empty with a cluster
    mask, which skips the final validation)."""
    init_from_env(hparams.device)
    torch.autograd.set_detect_anomaly(bool(hparams.detect_anomalies))
    return Runner(hparams).train()


if __name__ == '__main__':
    main(get_train_opts())
