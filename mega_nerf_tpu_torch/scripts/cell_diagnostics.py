"""Per-submodule density diagnostics of a merged Mega-NeRF.

    python -m mega_nerf_tpu_torch.scripts.cell_diagnostics --workdir <dir> \
        [--grid_res 33] [--synthetic] [--sigma_thresh 5.0] [--device cuda]

Counterpart of the JAX package's `scripts/cell_diagnostics.py`. The failure
of spatially partitioned training is the merge-time floater: a submodule
puts density inside its own routing region that agrees with every ray it
trained on but is wrong, and the merged mixture shows it as ghost geometry
in held-out views (too few distinct viewpoints per cell leave in-cell
density and density along the ray undistinguished). From a merged
container alone (`{workdir}/merged.pt` of `cell_convergence_run`, or
`--container`) it reports, on a `--grid_res`^3 grid over the cube of
half-extent `--extent`, per cell:

- occupancy: the fraction of the cell's own Voronoi region whose sigma
  exceeds `--sigma_thresh`;
- boundary disagreement: in the routing boundary band (where the margin
  blend mixes submodules), the mean gap between the cell's opacity over
  one paper-config sample step and the largest of the other submodules';
- with `--synthetic`, false positive (floater) and false negative
  (missing) voxels against the analytic ring scene of `data/synthetic.py`.

Each submodule's sigma comes from `render/rendering.py::query_points` on
that submodule alone (`sigma_only`, +x view direction, appearance 0), on
`--device`: at bf16 compute, the paper config's, the eval kernel
(`csrc/eval_fwd.cu`) on the card (`main(argv, compute_dtype="float32")`
queries in f32, as the comparison with the JAX script does). Prints one JSON line per
cell and a summary line, and writes both to
`{workdir}/cell_diagnostics.json`.
"""

from __future__ import annotations

import argparse
import json
from argparse import Namespace
from pathlib import Path
from typing import Optional, Sequence


def get_diagnostics_opts(argv: Optional[Sequence[str]] = None) -> Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", type=str, required=True,
                    help="cell_convergence_run workdir (masks/ + merged.pt)")
    ap.add_argument("--container", type=str, default=None,
                    help="merged container path (default {workdir}/merged.pt)")
    ap.add_argument("--grid_res", type=int, default=33)
    ap.add_argument("--extent", type=float, default=1.2,
                    help="probe cube half-extent around the origin")
    ap.add_argument("--sigma_thresh", type=float, default=5.0,
                    help="density treated as occupied (alpha ~ 6%% at the "
                         "paper config's ~0.012 sample spacing)")
    ap.add_argument("--boundary_margin", type=float, default=1.15)
    ap.add_argument("--synthetic", action="store_true",
                    help="score against data/synthetic.py's analytic ring scene")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--skip_layers", type=int, nargs="*", default=[4])
    ap.add_argument("--layer_dim", type=int, default=256)
    ap.add_argument("--bg_layer_dim", type=int, default=256)
    ap.add_argument("--pos_xyz_dim", type=int, default=12)
    ap.add_argument("--pos_dir_dim", type=int, default=4)
    ap.add_argument("--appearance_dim", type=int, default=48)
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the submodules are queried (cuda without a card "
                         "raises)")
    return ap.parse_args(argv)


def submodule_sigmas(fg, pts, device):
    """(K, P) sigma of each fg submodule alone at `pts` (P, 3)."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch.models.factory import ModelBundle
    from mega_nerf_tpu_torch.render.rendering import RenderSettings, query_points

    settings = RenderSettings()
    xyz = torch.from_numpy(pts).to(device)
    out = []
    for sub in fg.module:
        single = ModelBundle(module=sub.to(device), config=fg.config)
        with torch.no_grad():
            sigma = query_points(single, "fine", settings, xyz, sigma_only=True)
        out.append(sigma[:, 0].float().cpu().numpy())
    return np.stack(out)


def main(argv: Optional[Sequence[str]] = None, compute_dtype: str = "bfloat16") -> dict:
    """Diagnose -> {"cells": rows, "summary": summary} (also written to
    cell_diagnostics.json); `compute_dtype` is the MLP's (bfloat16 runs the
    bf16 eval kernel on the card, float32 the f32 one)."""
    args = get_diagnostics_opts(argv)

    import numpy as np
    import torch

    from mega_nerf_tpu_torch.models.container import container_to_bundles, load_container
    from mega_nerf_tpu_torch.runtime.runner import resolve_device

    device = resolve_device(args.device)
    work = Path(args.workdir)
    container = Path(args.container or work / "merged.pt")
    hp = Namespace(
        boundary_margin=args.boundary_margin, layers=args.layers,
        skip_layers=args.skip_layers, layer_dim=args.layer_dim,
        bg_layer_dim=args.bg_layer_dim, pos_xyz_dim=args.pos_xyz_dim,
        pos_dir_dim=args.pos_dir_dim, appearance_dim=args.appearance_dim,
        affine_appearance=False, sh_deg=None, shifted_softplus=True,
        use_cascade=False, mega_routing="auto", routing_max_experts=4,
        compute_dtype=compute_dtype,
    )
    data = load_container(container)
    fg, _bg = container_to_bundles(data, hp)
    cent = np.asarray(data.centroids, np.float32)
    k_cells = cent.shape[0]

    n = args.grid_res
    g = np.linspace(-args.extent, args.extent, n, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)

    dists = np.linalg.norm(pts[:, None, :] - cent[None], axis=-1)
    owner = dists.argmin(1)
    # The boundary band: the margin blend mixes where the runner-up's
    # distance is within boundary_margin of the winner's.
    part = np.partition(dists, 1, axis=1)
    boundary = part[:, 1] <= args.boundary_margin * part[:, 0]

    truth_occ = None
    if args.synthetic:
        from mega_nerf_tpu_torch.data.synthetic import scene_density_color

        true_sigma, _ = scene_density_color(torch.from_numpy(pts))
        truth_occ = true_sigma.numpy() > 1.0

    sigmas = submodule_sigmas(fg, pts, device)  # (K, P)
    # Opacity over one paper-config sample step, a scale-free comparison.
    alpha = 1.0 - np.exp(-np.maximum(sigmas, 0.0) * 0.012)

    rows = []
    for k in range(k_cells):
        own = owner == k
        occ = sigmas[k] > args.sigma_thresh
        band = own & boundary
        others = np.max(np.where(np.arange(k_cells)[:, None] == k, -1.0, alpha), axis=0)
        row = {
            "cell": k,
            "centroid": [round(float(v), 3) for v in cent[k]],
            "own_points": int(own.sum()),
            "own_occupied_frac": round(float(occ[own].mean()), 4),
            # The disagreement where this cell's blend mixes:
            "boundary_alpha_spread": round(float(
                np.abs(alpha[k][band] - others[band]).mean()) if band.any() else 0.0, 4),
        }
        if truth_occ is not None:
            fp = occ & ~truth_occ & own
            fn = ~occ & truth_occ & own
            row["floater_voxels"] = int(fp.sum())
            row["missing_voxels"] = int(fn.sum())
            row["floater_frac_of_region"] = round(float(fp.sum() / own.sum()), 4)
        rows.append(row)
        print(json.dumps(row), flush=True)

    summary = {
        "container": str(container),
        "cells": k_cells,
        "grid_res": n,
        "boundary_band_frac": round(float(boundary.mean()), 4),
    }
    if truth_occ is not None:
        summary["total_floater_voxels"] = int(sum(r["floater_voxels"] for r in rows))
        summary["total_missing_voxels"] = int(sum(r["missing_voxels"] for r in rows))
    print(json.dumps(summary), flush=True)
    result = {"cells": rows, "summary": summary}
    (work / "cell_diagnostics.json").write_text(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
