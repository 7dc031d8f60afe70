"""Config/flag system: argparse layered under YAML config files.

A copy of the JAX package's `opts.py` (the port shares no module with it):
the same flag names and defaults, so `configs/*.yaml` and command lines
written for one package parse identically in the other. YAML keys are long
option names (including negated store_false flags like `no_bg_nerf: true`);
CLI flags override the file.

Added here: `--device` (default `cuda`). Flags of JAX-package features the
port has not reached yet are still accepted so every shipped config
parses. Where the feature would change the result, setting the flag
raises `NotImplementedError`: training with `--container_path` (the JAX
Runner ignores the container's weights there; ROADMAP.md C).
`--train_mega_nerf` (joint mixture training) and `--mega_routing
dense|routed|ray|auto` with `--routing_max_experts` and
`--ray_routing_gate` act as in the JAX package (`auto` routes per point
past 32 submodules). `--cell_axis C` and `--data_axis D` lay the ranks of a
torchrun `train_cells` run out as C cell groups of D ranks (C x D must be
the world size; one process takes 1 x 1). `--occupancy_path`
(with `--occupancy_thresh`, `_dilate`, `_probes`, `_mode`), `--no_cell_cull`
and `--bake_cell_cull` act as in the JAX package. The others, such as the
eval compositor (a choice between equivalent compositors) and
`--render_dispatch_depth`, are speed or layout choices of the JAX package
and have no effect in the port.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def get_opts_base() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(add_help=True)
    parser.add_argument('--config_file', type=str, default=None,
                        help='YAML config file; keys are long option names')

    parser.add_argument('--dataset_type', type=str, default='filesystem',
                        choices=['filesystem', 'memory'])
    parser.add_argument('--chunk_paths', type=str, nargs='+', default=None)
    parser.add_argument('--num_chunks', type=int, default=200)
    parser.add_argument('--disk_flush_size', type=int, default=10000000)
    parser.add_argument('--train_every', type=int, default=1)

    parser.add_argument('--cluster_mask_path', type=str, default=None)

    parser.add_argument('--ckpt_path', type=str, default=None,
                        help="the port's {iter}.pt or the JAX package's "
                             "{iter}.ckpt: resumes training, or gives eval "
                             "its weights")
    parser.add_argument('--container_path', type=str, default=None)

    parser.add_argument('--near', type=float, default=1)
    parser.add_argument('--far', type=float, default=None)
    parser.add_argument('--ray_altitude_range', nargs='+', type=float, default=None)
    parser.add_argument('--coarse_samples', type=int, default=256)
    parser.add_argument('--fine_samples', type=int, default=512)

    parser.add_argument('--train_scale_factor', type=int, default=1)
    parser.add_argument('--val_scale_factor', type=int, default=4)

    parser.add_argument('--pos_xyz_dim', type=int, default=12)
    parser.add_argument('--pos_dir_dim', type=int, default=4)
    parser.add_argument('--layers', type=int, default=8)
    parser.add_argument('--skip_layers', type=int, nargs='+', default=[4])
    parser.add_argument('--layer_dim', type=int, default=256)
    parser.add_argument('--bg_layer_dim', type=int, default=256)
    parser.add_argument('--appearance_dim', type=int, default=48)
    parser.add_argument('--affine_appearance', default=False, action='store_true')

    parser.add_argument('--use_cascade', default=False, action='store_true')

    parser.add_argument('--train_mega_nerf', type=str, default=None)
    parser.add_argument('--boundary_margin', type=float, default=1.15)
    parser.add_argument('--all_val', default=False, action='store_true')
    parser.add_argument('--cluster_2d', default=False, action='store_true')

    parser.add_argument('--sh_deg', type=int, default=None)

    parser.add_argument('--no_center_pixels', dest='center_pixels',
                        default=True, action='store_false')
    parser.add_argument('--no_shifted_softplus', dest='shifted_softplus',
                        default=True, action='store_false')

    parser.add_argument('--batch_size', type=int, default=1024)
    parser.add_argument('--image_pixel_batch_size', type=int, default=64 * 1024)
    parser.add_argument('--model_chunk_size', type=int, default=32 * 1024)

    parser.add_argument('--perturb', type=float, default=1.0)
    parser.add_argument('--noise_std', type=float, default=1.0)

    parser.add_argument('--lr', type=float, default=5e-4)
    parser.add_argument('--lr_decay_factor', type=float, default=0.1)

    parser.add_argument('--no_bg_nerf', dest='bg_nerf', default=True,
                        action='store_false')

    parser.add_argument('--ellipse_scale_factor', type=float, default=1.1)
    parser.add_argument('--no_ellipse_bounds', dest='ellipse_bounds',
                        default=True, action='store_false')

    parser.add_argument('--train_iterations', type=int, default=500000)
    parser.add_argument('--val_interval', type=int, default=500001)
    parser.add_argument('--ckpt_interval', type=int, default=10000)

    parser.add_argument('--no_resume_ckpt_state', dest='resume_ckpt_state',
                        default=True, action='store_false')

    parser.add_argument('--no_amp', dest='amp', default=True, action='store_false')
    parser.add_argument('--detect_anomalies', default=False, action='store_true')
    parser.add_argument('--random_seed', type=int, default=42)

    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device the entry points run on ('cuda' "
                             "or 'cpu'); cuda without a card raises")
    parser.add_argument('--profile_steps', type=int, default=0)
    parser.add_argument('--ref_packed_dirs', default=False, action='store_true',
                        help='replicate the reference packed-input direction '
                             'quirk (see NeRFConfig.ref_packed_dirs)')
    parser.add_argument('--render_dispatch_depth', type=int, default=2)
    parser.add_argument('--no_cell_cull', dest='cell_cull', default=True,
                        action='store_false')
    parser.add_argument('--bake_cell_cull', type=str, default='auto',
                        choices=['auto', 'on', 'off'])
    parser.add_argument('--occupancy_path', type=str, default=None)
    parser.add_argument('--occupancy_thresh', type=float, default=-1.0)
    parser.add_argument('--occupancy_dilate', type=int, default=1)
    parser.add_argument('--occupancy_probes', type=int, default=128)
    parser.add_argument('--occupancy_mode', type=str, default='near',
                        choices=['near', 'both'])
    parser.add_argument('--ref_bg_sampling', default=False, action='store_true',
                        help='replicate the reference bg fine-sampling quirk '
                             '(see RenderSettings.ref_bg_sampling)')
    parser.add_argument('--compute_dtype', type=str, default='bfloat16',
                        choices=['bfloat16', 'float32'],
                        help='matmul operand precision (params stay float32)')
    parser.add_argument('--remat', default=False, action='store_true')
    parser.add_argument('--no_pallas', dest='use_fused_kernel', default=True,
                        action='store_false',
                        help='evaluate the MLP with the eager NeRF module '
                             'instead of the fused eval kernel')
    parser.add_argument('--distortion_loss_weight', type=float, default=0.0)
    parser.add_argument('--eval_compositor', type=str, default='auto',
                        choices=['auto', 'merge_grouped', 'merge', 'union'])
    parser.add_argument('--mega_routing', type=str, default='auto',
                        choices=['auto', 'dense', 'routed', 'ray'])
    parser.add_argument('--ray_routing_gate', type=float, default=0.45)
    parser.add_argument('--routing_max_experts', type=int, default=4)
    parser.add_argument('--data_axis', type=int, default=None)
    parser.add_argument('--cell_axis', type=int, default=1)

    return parser


def _apply_config_file(parser: argparse.ArgumentParser, config_path: str,
                       argv: List[str]) -> None:
    """Layer YAML values under CLI flags, configargparse-style.

    For store_true/store_false flags a truthy value applies the flag's const
    (so `no_bg_nerf: true` sets bg_nerf=False, matching the reference
    configs)."""
    import yaml

    with open(config_path) as f:
        values = yaml.safe_load(f) or {}

    by_flag = {}
    for action in parser._actions:
        for opt in action.option_strings:
            if opt.startswith('--'):
                by_flag[opt[2:]] = action

    explicit = {a.strip('-').split('=')[0] for a in argv if a.startswith('--')}

    for key, value in values.items():
        action = by_flag.get(key)
        if action is None:
            raise ValueError(f'Unknown config key: {key!r} in {config_path}')
        if key in explicit:
            continue  # CLI wins
        if isinstance(action, (argparse._StoreTrueAction, argparse._StoreFalseAction)):
            if _as_bool(value):
                parser.set_defaults(**{action.dest: action.const})
        else:
            parser.set_defaults(**{action.dest: value})


def _as_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ('1', 'true', 'yes', 'on')


def parse_opts(parser: argparse.ArgumentParser,
               args: Optional[List[str]] = None,
               known_only: bool = False) -> argparse.Namespace:
    """Parse CLI args with optional YAML config layering."""
    argv = list(sys.argv[1:] if args is None else args)
    pre, _ = parser.parse_known_args(argv)
    if pre.config_file:
        _apply_config_file(parser, pre.config_file, argv)
    if known_only:
        return parser.parse_known_args(argv)[0]
    return parser.parse_args(argv)
