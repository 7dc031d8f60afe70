"""Hierarchical coarse->fine volume renderer with NeRF++ fg/bg decomposition.

Port of the JAX package's `render/rendering.py` (`render_rays`,
`_get_results`, `_inference`, `_model_eval`), eval and train modes:

- the background model is evaluated for all rays and its contribution is
  masked by `has_bg = far > fg_far` (fg rays are clamped at the ellipsoid);
- the `capped` / `last_delta` arithmetic, the bg `flip` and
  `ref_bg_sampling` follow the JAX package exactly;
- the coarse+fine merge is `composite_weights_merge` (a stable sort by
  depth, then `composite_weights`);
- the MLP runs through the fused kernel wrappers when the architecture is
  inside their coverage (`fused_mlp.supports_fused_kernel`; eval:
  `fused_nerf_eval`, train: the differentiable `fused_nerf_train_apply`),
  else through the eager `NeRF` module. The gate looks at the architecture
  only; on a CPU tensor the wrappers run the kernels' plain versions;
- train mode (`train=True`) draws from a `torch.Generator` where the JAX
  package splits keys: stratified perturbation, sorted-uniform fine
  sampling (`det = perturb == 0`) and uniform sigma noise rounded to the
  compute dtype. Without a generator it is deterministic. Coarse weights
  and fine depths are detached; depth variance uses detached weights.
  Callers of eval mode wrap it in `torch.no_grad()`.

Not ported yet: occupancy `fg_bounds`, the cascade, mega mixtures and their
routing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from mega_nerf_tpu_torch.models.factory import ModelBundle
from mega_nerf_tpu_torch.models.nerf import direction_coords
from mega_nerf_tpu_torch.ops.compositing import (
    composite_weights,
    composite_weights_merge,
)
from mega_nerf_tpu_torch.ops.geometry import depth2pts_outside, intersect_sphere
from mega_nerf_tpu_torch.ops.sampling import expand_and_perturb_z_vals, sample_pdf
from mega_nerf_tpu_torch.render.fused_mlp import (
    fused_nerf_eval,
    pack_params,
    supports_fused_kernel,
)
from mega_nerf_tpu_torch.render.fused_train import fused_nerf_train_apply

INF_DELTA = 1e10


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static rendering configuration."""

    coarse_samples: int = 256
    fine_samples: int = 512
    perturb: float = 1.0  # train-mode stratified jitter (0 = none)
    sigma_noise: bool = True  # train-mode uniform [0, 1) density noise
    # False = evaluate the MLP with the eager NeRF module (--no_pallas);
    # otherwise the fused kernel wherever the architecture is covered.
    use_fused_kernel: bool = True
    # Reproduce the reference's bg fine-sampling quirk: bg coarse weights
    # are computed in descending-z order but paired with ascending bins
    # when the fine CDF is built. The default flips them back into bin
    # order (see the JAX package's RenderSettings.ref_bg_sampling).
    ref_bg_sampling: bool = False
    get_depth: bool = False
    get_depth_variance: bool = False
    get_bg_fg_rgb: bool = False
    # Mip-NeRF 360 distortion regularizer weight (> 0 emits a per-ray
    # `distortion_coarse` term for the trainer). 0 = off.
    distortion_loss_weight: float = 0.0

    @classmethod
    def from_hparams(cls, hparams, **overrides) -> "RenderSettings":
        kw = dict(
            coarse_samples=getattr(hparams, "coarse_samples", 256),
            fine_samples=getattr(hparams, "fine_samples", 512),
            perturb=getattr(hparams, "perturb", 1.0),
            use_fused_kernel=getattr(hparams, "use_fused_kernel", True),
            ref_bg_sampling=getattr(hparams, "ref_bg_sampling", False),
            distortion_loss_weight=getattr(hparams, "distortion_loss_weight", 0.0),
        )
        kw.update(overrides)
        return cls(**kw)


_LOGGED_MLP_PATHS = set()


def _log_mlp_path(message: str) -> None:
    """Print each distinct MLP-path decision once per process."""
    if message not in _LOGGED_MLP_PATHS:
        _LOGGED_MLP_PATHS.add(message)
        print(message, flush=True)


def fused_gate(bundle: ModelBundle, settings: RenderSettings) -> Tuple[bool, str]:
    """Does this bundle's MLP go through the fused kernel wrappers?"""
    if not settings.use_fused_kernel:
        return False, "disabled (--no_pallas)"
    return supports_fused_kernel(bundle.config)


def packed_params(bundle: ModelBundle):
    """The bundle's kernel-layout weights for eval, packed on first use and
    kept on the bundle until a parameter changes: the cache is keyed on
    each parameter's storage and version counter, which optimizer steps
    and `load_state_dict` (in-place updates) bump."""
    key = tuple((p.data_ptr(), p._version) for p in bundle.module.parameters())
    if bundle.packed is None or bundle.packed_key != key:
        bundle.packed = pack_params(bundle.module)
        bundle.packed_key = key
    return bundle.packed


def _model_eval(
    bundle: ModelBundle,
    typ: str,
    settings: RenderSettings,
    xyz: torch.Tensor,  # (N, S, D)
    rays_d: torch.Tensor,  # (N, 1, 3)
    image_indices: Optional[torch.Tensor],  # (N,)
    train: bool,
    generator: Optional[torch.Generator],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the MLP on all samples -> (rgbs (N, S, 3), sigmas (N, S))."""
    cfg = bundle.config
    n, s, d = xyz.shape
    flat_xyz = xyz.reshape(n * s, d).float().contiguous()
    dirs = None
    if cfg.pos_dir_dim > 0:
        dirs = rays_d.expand(n, s, 3).reshape(n * s, 3)

    noise = None
    if train and generator is not None and settings.sigma_noise:
        # Uniform [0, 1) pre-activation density noise, rounded to the
        # compute dtype as the JAX package does (PARITY.md 2.1).
        noise = torch.rand((n * s,), generator=generator, device=xyz.device)
        noise = noise.to(cfg.dtype).float()

    fused, why = fused_gate(bundle, settings)
    where = "kernel" if flat_xyz.is_cuda else "plain version"
    mode = "train" if train else "eval"
    _log_mlp_path(
        f"MLP path [xyz_dim={cfg.xyz_dim}/{typ}/{mode}]: "
        + (f"fused {mode} ({where})" if fused else f"eager NeRF module ({why})")
    )
    if fused:
        coords = None if dirs is None else \
            direction_coords(cfg, flat_xyz, dirs).float().contiguous()
        app = None
        if cfg.appearance_dim > 0:
            app = bundle.module.appearance(image_indices)  # (N, A) per ray
            if train:
                app = app.float()  # bf16-exact f32 rows; grads sum in f32
            app = app[:, None].expand(n, s, app.shape[-1]).reshape(n * s, -1)
            app = app.contiguous()
        if train:
            out = fused_nerf_train_apply(bundle.module, flat_xyz, coords, app,
                                         noise)
        else:
            out = fused_nerf_eval(packed_params(bundle), flat_xyz, coords, app)
    else:
        idx = None
        if cfg.appearance_dim > 0:
            idx = image_indices[:, None].expand(n, s).reshape(n * s)
        out = bundle.module(flat_xyz, dirs, idx, noise)
    out = out.reshape(n, s, 4)
    return out[..., :3], out[..., 3]


def _inference(
    results: Dict[str, torch.Tensor],
    typ: str,
    bundle: ModelBundle,
    settings: RenderSettings,
    rays_d: torch.Tensor,
    image_indices: Optional[torch.Tensor],
    xyz: torch.Tensor,
    z_vals: torch.Tensor,
    last_delta: torch.Tensor,  # (N, 1)
    composite_rgb: bool,
    get_depth: bool,
    get_depth_variance: bool,
    get_weights: bool,
    get_bg_lambda: bool,
    flip: bool,
    depth_real: Optional[torch.Tensor],
    train: bool,
    generator: Optional[torch.Generator],
) -> None:
    """One sampling level: MLP eval + (optional coarse merge) + compositing.
    The coarse raw outputs are stashed in `results` and merged into the
    fine pass."""
    merge_prev = "zvals_coarse" in results

    if flip and not merge_prev:
        xyz = torch.flip(xyz, dims=(-2,))
        z_vals = torch.flip(z_vals, dims=(-1,))
        if depth_real is not None:
            depth_real = torch.flip(depth_real, dims=(-1,))

    rgbs, sigmas = _model_eval(bundle, typ, settings, xyz, rays_d,
                               image_indices, train, generator)

    if merge_prev:
        # A stable sort of the union: serves both of the JAX package's
        # train compositors (the two-sorted-lists merge and, when perturb > 1
        # breaks the coarse list's order, the unsorted union).
        cw = composite_weights_merge(
            z_vals, sigmas, results["zvals_coarse"], results["raw_sigma_coarse"],
            last_delta, flip=flip,
        )
        z_vals = torch.cat([z_vals, results["zvals_coarse"]], -1)
        rgbs = torch.cat([rgbs, results["raw_rgb_coarse"]], 1)
        sigmas = torch.cat([sigmas, results["raw_sigma_coarse"]], 1)
        if depth_real is not None:
            depth_real = torch.cat([depth_real, results["depth_real_coarse"]], -1)
    else:
        cw = composite_weights(sigmas, z_vals, last_delta, flip=flip)
    weights = cw.weights

    if get_bg_lambda:
        results[f"bg_lambda_{typ}"] = cw.bg_lambda
    if get_weights:
        results[f"weights_{typ}"] = weights
    if (settings.distortion_loss_weight > 0 and typ == "coarse" and not flip
            and not merge_prev):
        # Mip-NeRF 360 distortion on the (ascending) coarse pass:
        # sum_ij w_i w_j |s_i - s_j| = 2 sum_i w_i (s_i W_<i - (ws)_<i).
        span = z_vals[:, -1:] - z_vals[:, :1] + 1e-8
        sn = (z_vals - z_vals[:, :1]) / span
        dd = torch.cat([sn[:, 1:] - sn[:, :-1], torch.zeros_like(sn[:, :1])], -1)
        cum_w = torch.cumsum(weights, -1) - weights
        cum_ws = torch.cumsum(weights * sn, -1) - weights * sn
        results["distortion_coarse"] = (
            2.0 * torch.sum(weights * (sn * cum_w - cum_ws), -1)
            + torch.sum(weights ** 2 * dd, -1) / 3.0
        )

    if composite_rgb:
        results[f"rgb_{typ}"] = torch.sum(weights[..., None] * rgbs, 1)
    else:
        results[f"zvals_{typ}"] = z_vals
        results[f"raw_rgb_{typ}"] = rgbs
        results[f"raw_sigma_{typ}"] = sigmas
        if depth_real is not None:
            results[f"depth_real_{typ}"] = depth_real

    if get_depth or get_depth_variance:
        w = weights.detach()
        z = (depth_real if depth_real is not None else z_vals).detach()
        depth_map = torch.sum(w * z, 1)
        if get_depth:
            results[f"depth_{typ}"] = depth_map
        if get_depth_variance:
            results[f"depth_variance_{typ}"] = torch.sum(
                w * torch.square(z_vals.detach() - depth_map[:, None]), -1)


def _get_results(
    bundle: ModelBundle,
    settings: RenderSettings,
    rays_d: torch.Tensor,
    image_indices: Optional[torch.Tensor],
    xyz_coarse: torch.Tensor,
    z_vals: torch.Tensor,
    last_delta: torch.Tensor,
    get_depth: bool,
    get_bg_lambda: bool,
    flip: bool,
    depth_real: Optional[torch.Tensor],
    xyz_fine_fn,
    fine_samples: int,
    train: bool,
    generator: Optional[torch.Generator],
) -> Dict[str, torch.Tensor]:
    """Coarse pass + hierarchical fine pass."""
    results: Dict[str, torch.Tensor] = {}
    get_var = settings.get_depth_variance

    capped = last_delta[:, 0] < INF_DELTA
    z_max = torch.amax(z_vals, -1)
    last_delta_c = last_delta - torch.where(capped, z_max, 0.0)[:, None]

    _inference(
        results, "coarse", bundle, settings, rays_d, image_indices,
        xyz_coarse, z_vals, last_delta_c,
        composite_rgb=fine_samples == 0,
        get_depth=(fine_samples == 0) and get_depth,
        get_depth_variance=(fine_samples == 0) and get_var,
        get_weights=fine_samples > 0,
        get_bg_lambda=get_bg_lambda and fine_samples == 0,
        flip=flip,
        depth_real=depth_real,
        train=train,
        generator=generator,
    )
    if fine_samples == 0:
        return results

    z_vals_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    weights_c = results.pop("weights_coarse").detach()[:, 1:-1]
    if flip and not settings.ref_bg_sampling:
        # Coarse bg weights were computed in descending-z order: flip them
        # back into bin order before building the sampling CDF.
        weights_c = torch.flip(weights_c, dims=(-1,))
    perturb = settings.perturb if train else 0.0
    fine_z_vals = sample_pdf(z_vals_mid, weights_c, fine_samples,
                             det=(perturb == 0), generator=generator).detach()
    if flip:
        # The bg pass composites in descending order.
        fine_z_vals = torch.flip(fine_z_vals, dims=(-1,))

    xyz_fine, depth_real_fine = xyz_fine_fn(fine_z_vals)

    z_max_f = torch.amax(fine_z_vals, -1)
    last_delta_f = last_delta - torch.where(capped, z_max_f, 0.0)[:, None]

    _inference(
        results, "fine", bundle, settings, rays_d, image_indices,
        xyz_fine, fine_z_vals, last_delta_f,
        composite_rgb=True,
        get_depth=get_depth,
        get_depth_variance=get_var,
        get_weights=False,
        get_bg_lambda=get_bg_lambda,
        flip=flip,
        depth_real=depth_real_fine,
        train=train,
        generator=generator,
    )
    for k in ("zvals_coarse", "raw_rgb_coarse", "raw_sigma_coarse",
              "depth_real_coarse"):
        results.pop(k, None)
    return results


def render_rays(
    fg: ModelBundle,
    bg: Optional[ModelBundle],
    rays: torch.Tensor,  # (N, 8)
    image_indices: Optional[torch.Tensor],  # (N,)
    settings: RenderSettings,
    sphere_center: Optional[torch.Tensor] = None,
    sphere_radius: Optional[torch.Tensor] = None,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Render a batch of rays -> (results, bg_rays_present (bool scalar
    tensor)). Results carry `rgb_fine`, `depth_fine` (with `get_depth`),
    `depth_variance_fine` (with `get_depth_variance`), `fg_rgb_fine` /
    `bg_rgb_fine` (with `get_bg_fg_rgb`), ... as the JAX package's
    `render_rays`. `train` enables perturbation and sigma noise drawn from
    `generator` (none without one) and the differentiable fused MLP."""
    n_rays = rays.shape[0]
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    perturb = settings.perturb if train else 0.0
    jitter = generator if train else None

    last_delta = torch.full((n_rays, 1), INF_DELTA, device=rays.device)
    bg_results = None
    has_bg = None
    rays_o3 = rays_o[:, None, :]
    rays_d3 = rays_d[:, None, :]

    if bg is not None:
        fg_far = intersect_sphere(rays_o, rays_d, sphere_center, sphere_radius)
        fg_far = torch.maximum(fg_far, near[:, 0])
        has_bg = far[:, 0] > fg_far
        last_delta = torch.where(has_bg[:, None], fg_far[:, None], last_delta)
        far = torch.minimum(far, fg_far[:, None])

        s_bg = settings.coarse_samples // 2
        bg_z = torch.linspace(0.0, 1.0, s_bg, device=rays.device).expand(
            n_rays, s_bg)
        bg_z = expand_and_perturb_z_vals(bg_z, perturb, jitter)
        bg_pts, bg_depth_real = depth2pts_outside(
            rays_o3, rays_d3, bg_z, sphere_center, sphere_radius
        )
        bg_results = _get_results(
            bg, settings, rays_d3, image_indices, bg_pts, bg_z,
            torch.full((n_rays, 1), INF_DELTA, device=rays.device),
            get_depth=settings.get_depth,
            get_bg_lambda=False,
            flip=True,
            depth_real=bg_depth_real,
            xyz_fine_fn=lambda fz: depth2pts_outside(
                rays_o3, rays_d3, fz, sphere_center, sphere_radius
            ),
            fine_samples=settings.fine_samples // 2,
            train=train,
            generator=jitter,
        )

    z_steps = torch.linspace(0.0, 1.0, settings.coarse_samples,
                             device=rays.device)
    z_vals = near * (1.0 - z_steps) + far * z_steps
    z_vals = expand_and_perturb_z_vals(z_vals, perturb, jitter)
    xyz_coarse = rays_o3 + rays_d3 * z_vals[..., None]

    results = _get_results(
        fg, settings, rays_d3, image_indices, xyz_coarse, z_vals, last_delta,
        get_depth=settings.get_depth,
        get_bg_lambda=bg is not None,
        flip=False,
        depth_real=None,
        xyz_fine_fn=lambda fz: (rays_o3 + rays_d3 * fz[..., None], None),
        fine_samples=settings.fine_samples,
        train=train,
        generator=jitter,
    )

    if bg is not None:
        typ = "fine" if settings.fine_samples > 0 else "coarse"
        mult = torch.where(has_bg, results[f"bg_lambda_{typ}"], 0.0)
        for comp in ("rgb", "depth"):
            key = f"{comp}_{typ}"
            if key not in results or key not in bg_results:
                continue
            val = results[key]
            bg_val = bg_results[key] * (mult[:, None] if val.dim() > 1 else mult)
            if settings.get_bg_fg_rgb:
                results[f"fg_{comp}_{typ}"] = val
                results[f"bg_{comp}_{typ}"] = bg_val
            results[key] = val + bg_val
    bg_rays_present = (has_bg.any() if has_bg is not None
                       else torch.zeros((), dtype=torch.bool, device=rays.device))
    return results, bg_rays_present
