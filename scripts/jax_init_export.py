"""The JAX package's initial weights for the ring scene's paper config, as
the port's state dicts.

    python3 scripts/jax_init_export.py --out DIR SEED [SEED ...]

For each `--random_seed` SEED, draws what the JAX `Runner.train` draws
(`make_train_state` from `PRNGKey(seed)`: fg and bg of
`convergence_run.PAPER_ARGS` with one appearance row per training item of
cell 0, 30) and writes `{out}/seed{SEED}.pt` = {"fg": state, "bg": state},
carried by `state_from_flax_params`. Runs on the CPU; the weights are
loaded on the card by `scripts/converge_probe.py`'s `jaxinit` option.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from mega_nerf_tpu.models import factory as j_factory  # noqa: E402
from mega_nerf_tpu.opts import get_opts_base as j_opts  # noqa: E402
from mega_nerf_tpu.opts import parse_opts as j_parse  # noqa: E402
from mega_nerf_tpu_torch.models import factory as t_factory  # noqa: E402
from mega_nerf_tpu_torch.models import state_from_flax_params  # noqa: E402
from mega_nerf_tpu_torch.opts import get_opts_base, parse_opts  # noqa: E402
from mega_nerf_tpu_torch.scripts import convergence_run as cvr  # noqa: E402

TRAIN_ITEMS = 30  # 28 train views and the 2 val views' left halves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("seeds", nargs="+", type=int)
    ap.add_argument("--out", type=str, required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    hps = []
    for opts, parse in ((j_opts, j_parse), (get_opts_base, parse_opts)):
        parser = opts()
        parser.add_argument("--exp_name", type=str, default=".")
        parser.add_argument("--dataset_path", type=str, default=".")
        hps.append(parse(parser, cvr.PAPER_ARGS))
    j_models = [j_factory.make_nerf(hps[0], TRAIN_ITEMS),
                j_factory.make_bg_nerf(hps[0], TRAIN_ITEMS)]
    t_configs = [t_factory.make_nerf(hps[1], TRAIN_ITEMS).module.config,
                 t_factory.make_bg_nerf(hps[1], TRAIN_ITEMS).module.config]
    for seed in args.seeds:
        k_fg, k_bg, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
        states = {}
        for side, bundle, cfg, key in zip(("fg", "bg"), j_models, t_configs, (k_fg, k_bg)):
            states[side] = state_from_flax_params(cfg, jax.device_get(bundle.init(key)))
        torch.save(states, out / f"seed{seed}.pt")
        print(f"seed {seed}: {out / f'seed{seed}.pt'}", flush=True)


if __name__ == "__main__":
    main()
