"""Eval entry point: `python -m mega_nerf_tpu_torch.eval --config_file ...
--dataset_path ... --ckpt_path ... --exp_name ...`, or with
`--container_path <merged container>` in place of `--ckpt_path` to serve a
Mega-NeRF mixture, or with `--train_mega_nerf params.pt` to serve the
jointly trained mixture of `--ckpt_path` (densely or routed, by
`--mega_routing`). `--ckpt_path` may be the port's `{iter}.pt` or the JAX
package's `{iter}.ckpt`; eval reads only its weights.

Counterpart of the JAX package's `eval.py`. Runs on `--device` (default
cuda; cuda without a card raises). `--occupancy_path <occupancy or octree
.npz>` (from `scripts.bake_occupancy` or `scripts.create_octree`) tightens
each ray's fg interval; a mixture is culled per chunk unless
`--no_cell_cull`. Under torchrun the val views are strided over the ranks
and the metrics gathered.
"""

from __future__ import annotations

from argparse import Namespace
from typing import Dict

from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts
from mega_nerf_tpu_torch.parallel.distributed import init_from_env
from mega_nerf_tpu_torch.runtime.runner import Runner


def get_eval_opts(args=None) -> Namespace:
    parser = get_opts_base()
    parser.add_argument('--exp_name', type=str, required=True,
                        help='experiment name')
    parser.add_argument('--dataset_path', type=str, required=True)
    return parse_opts(parser, args)


def main(hparams: Namespace) -> Dict[str, float]:
    """Render and score every val view; returns the averaged metrics."""
    if hparams.ckpt_path is None and hparams.container_path is None:
        raise ValueError("eval needs --ckpt_path or --container_path")
    init_from_env(hparams.device)
    return Runner(hparams).eval()


if __name__ == '__main__':
    main(get_eval_opts())
