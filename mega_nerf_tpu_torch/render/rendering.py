"""Hierarchical coarse->fine volume renderer with NeRF++ fg/bg decomposition.

Port of the JAX package's `render/rendering.py` (`render_rays`,
`_get_results`, `_inference`, `_model_eval`), eval and train modes:

- the background model is evaluated for all rays and its contribution is
  masked by `has_bg = far > fg_far` (fg rays are clamped at the ellipsoid);
- the `capped` / `last_delta` arithmetic, the bg `flip` and
  `ref_bg_sampling` follow the JAX package exactly;
- the coarse+fine merge is `composite_weights_merge` (a stable sort by
  depth, then `composite_weights`); under the coarse/fine cascade
  (`use_cascade`) each level is its own NeRF (`bundle.level(typ)`), the
  coarse pass composites rgb (and the background's share), and the fine
  pass evaluates the sorted union of the coarse and fine depths with no
  merge;
- the SH output head (`sh_deg`): rgb = sigmoid(eval_sh(coefficients, ray
  direction)), on the eager module (the kernels have the rgb head only,
  as the JAX package's Pallas gate);
- the MLP runs through the fused kernel wrappers when the architecture is
  inside their coverage (`fused_mlp.supports_fused_kernel(cfg, train)`;
  eval: `fused_nerf_eval` to width 512, `fused_wide.fused_nerf_eval_wide`
  past it; train: the differentiable `fused_nerf_train_apply`, which runs
  `fused_train_wide.py` past width 512), else
  through the eager `NeRF` module (`mlp_route`). The gate looks at the
  architecture and the compute dtype: bf16 and f32 compute take the
  kernels to width 512 (f32 through the true-f32 kernels of
  `fused_f32.py`), past it the wide kernels (f32 through those of
  `fused_wide_f32.py`, to 1024, as the JAX gate); on a CPU tensor the
  wrappers run the kernels' plain versions;
- train mode (`train=True`) draws from a `torch.Generator` where the JAX
  package splits keys: stratified perturbation, sorted-uniform fine
  sampling (`det = perturb == 0`) and uniform sigma noise rounded to the
  compute dtype. Without a generator it is deterministic. Coarse weights
  and fine depths are detached; depth variance uses detached weights.
  Callers of eval mode wrap it in `torch.no_grad()`. With `remat`
  (`--remat`) the eager module's activations are recomputed in the
  backward pass (`torch.utils.checkpoint`, as `jax.checkpoint` in the JAX
  package); the fused routes ignore it, as the JAX Pallas route does;
- Mega-NeRF mixtures: routing weights from the first three columns of the
  points (`models/mega.py::cluster_weights`; a mixture background gets
  real-world routing coordinates prepended by `depth2pts_outside`), then
  each submodule through the route a single model of its architecture
  takes, on its own packed weights: blended densely (`mega_apply`), per
  point routed (`mega_apply_routed`, `--mega_routing routed` or `auto` past
  32 submodules), or, for the fg mixture of a view with per-ray supports
  (`fg_ray_support`), per ray routed (`mega_apply_ray_routed`). In train
  mode each submodule runs the training kernels on the points assigned to
  it (`mega_apply_routed`: at margin 1 the one-hot blend, exactly). The JAX
  package sends every mixture to XLA; the kernel route here gives the same
  output to the kernels' tolerance.

- occupancy-tightened fg intervals (`fg_bounds`, `render/ray_bounds.py`)
  and exact per-chunk cell culling of a fg mixture (`fg_active`,
  `render/cell_cull.py`), as the JAX package's `render_rays`;
- `query_points`, the MLP route of every pass, also serves the octree
  bake's point probes (`scripts/create_octree.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from mega_nerf_tpu_torch.models.factory import ModelBundle
from mega_nerf_tpu_torch.models.mega import (
    cluster_weights,
    mega_apply,
    mega_apply_ray_routed,
    mega_apply_routed,
    ray_route_experts,
)
from mega_nerf_tpu_torch.models.nerf import direction_coords
from mega_nerf_tpu_torch.ops.compositing import (
    composite_weights,
    composite_weights_merge,
)
from mega_nerf_tpu_torch.ops.geometry import depth2pts_outside, intersect_sphere
from mega_nerf_tpu_torch.ops.sampling import expand_and_perturb_z_vals, sample_pdf
from mega_nerf_tpu_torch.ops.sh import eval_sh
from mega_nerf_tpu_torch.render.fused_mlp import (
    fused_nerf_eval,
    is_wide,
    pack_params,
    supports_fused_kernel,
)
from mega_nerf_tpu_torch.render.fused_train import fused_nerf_train_apply
from mega_nerf_tpu_torch.render.fused_wide import fused_nerf_eval_wide

INF_DELTA = 1e10


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static rendering configuration."""

    coarse_samples: int = 256
    fine_samples: int = 512
    use_cascade: bool = False  # separate coarse and fine NeRFs
    perturb: float = 1.0  # train-mode stratified jitter (0 = none)
    sh_deg: Optional[int] = None  # SH output head of this degree
    sigma_noise: bool = True  # train-mode uniform [0, 1) density noise
    # Recompute the eager module's activations in the backward pass instead
    # of keeping them (torch.utils.checkpoint); the fused routes ignore it.
    remat: bool = False
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
            use_cascade=getattr(hparams, "use_cascade", False),
            perturb=getattr(hparams, "perturb", 1.0),
            sh_deg=getattr(hparams, "sh_deg", None),
            remat=getattr(hparams, "remat", False),
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


def mlp_route(cfg, device_type: str, train: bool = False) -> Tuple[bool, str]:
    """Does an MLP of `cfg` on points of `device_type` go through the fused
    kernel wrappers -> (fused, why not): the gate's answer
    (`supports_fused_kernel`, eval or with `train` training). On the card
    the kernels compute in bf16 or f32 (every width the gate admits: f32
    to 512 in `fused_f32.py`, past it to 1024 in `fused_wide_f32.py`);
    another compute dtype takes the eager module there. On CPU
    tensors the wrappers run their plain versions, which compute in any
    dtype."""
    ok, why = supports_fused_kernel(cfg, train)
    if ok and device_type == "cuda" and cfg.dtype not in (torch.bfloat16, torch.float32):
        return False, (f"{cfg.compute_dtype} compute on the card (the kernels are "
                       "bf16 and f32)")
    return ok, why


def fused_gate(bundle: ModelBundle, settings: RenderSettings, train: bool,
               device_type: str) -> Tuple[bool, str]:
    """Does this bundle's MLP go through the fused kernel wrappers for
    points on `device_type` (`mlp_route`)?"""
    if not settings.use_fused_kernel:
        return False, "disabled (--no_pallas)"
    if settings.sh_deg is not None:
        return False, "SH output head"
    return mlp_route(bundle.config, device_type, train)


def packed_params(bundle: ModelBundle, typ: str, sub: Optional[int] = None):
    """The kernel-layout weights of the module evaluating level `typ` (of a
    mixture: of submodule `sub`, at every level), for eval: packed on first
    use and kept on the bundle, one cache per level or submodule (a
    cascade's two levels and a mixture's submodules hold different
    weights), until a parameter of that module changes: each cache is
    keyed on its parameters' storage and version counters, which optimizer
    steps and `load_state_dict` (in-place updates) bump."""
    if sub is not None:
        module, slot = bundle.module[sub], ("sub", sub)
    else:
        module, slot = bundle.level(typ), (typ if bundle.cascade else "model")
    key = tuple((p.data_ptr(), p._version) for p in module.parameters())
    if bundle.packed is None:
        bundle.packed = {}
    hit = bundle.packed.get(slot)
    if hit is None or hit[0] != key:
        hit = bundle.packed[slot] = (key, pack_params(module))
    return hit[1]


def query_points(
    bundle: ModelBundle,
    typ: str,
    settings: RenderSettings,
    xyz: torch.Tensor,  # (P, xyz_dim)
    dirs: Optional[torch.Tensor] = None,  # (P, 3)
    image_indices: Optional[torch.Tensor] = None,
    *,
    samples: int = 1,
    active: Optional[Sequence[int]] = None,
    ray_experts: Optional[Sequence[Tuple[int, torch.Tensor]]] = None,
    sigma_only: bool = False,
    train: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Evaluate level `typ`'s MLP of `bundle` on flat points -> (P,
    rgb_dim + 1) raw outputs, sigma last (an SH head's coefficients before
    `eval_sh`); with `sigma_only` the (P, 1) sigma column.

    The port's counterpart of the JAX package's `ModelBundle.apply(params,
    typ, xyz, dirs, image_indices, sigma_only=...)`, and the route every
    MLP pass of the renderer takes: `fused_nerf_eval` (`eval_fwd.cu`, in
    f32 `eval_f32.cu`) to width 512, `fused_nerf_eval_wide` (`eval_wide.cu`,
    in f32 `wide_f32.cu`) past it, the eager module for an SH head, past
    the gate's widths (2048 in bf16, 1024 in f32) or with `--no_pallas`
    (`fused_gate`); in train mode the differentiable
    `fused_nerf_train_apply`. The kernels have no sigma-only variant, so
    `sigma_only` computes the full output, as the JAX Pallas kernel does;
    without `dirs` or `image_indices` it feeds +x and index 0, which do not
    move sigma.

    `image_indices` holds one appearance index for every `samples`
    consecutive points (the renderer passes one per ray). A mixture blends
    its submodules by routing weights over all K centroids: densely
    (`mega_apply`), running only the submodules in `active` when given
    (`render/cell_cull.py`: exact); per point routed when the bundle routes
    (`use_routed`) and always in train mode, where `noise` (one value a
    point) is gathered with the points; per ray routed over `ray_experts`
    (`models/mega.py::ray_route_experts`, eval only)."""
    cfg = bundle.config
    if sigma_only:
        if dirs is None and cfg.pos_dir_dim > 0:
            dirs = xyz.new_zeros((xyz.shape[0], 3))
            dirs[:, 0] = 1.0
        if image_indices is None and cfg.appearance_dim > 0:
            image_indices = torch.zeros(xyz.shape[0] // samples, dtype=torch.long,
                                        device=xyz.device)
    flat_xyz = xyz.float().contiguous()
    fused, why = fused_gate(bundle, settings, train, flat_xyz.device.type)
    wide = fused and is_wide(cfg)
    kernel = "wide kernel" if wide else "kernel"
    where = kernel if flat_xyz.is_cuda else f"{kernel}'s plain version"
    mode = "train" if train else "eval"
    mixture = f" x {len(bundle.module)} submodules" if bundle.is_mega else ""
    _log_mlp_path(
        f"MLP path [xyz_dim={cfg.xyz_dim}/{typ}/{mode}]: "
        + (f"fused {mode} ({where})" if fused else f"eager NeRF module ({why})")
        + mixture
    )

    def run(sub: Optional[int], points: torch.Tensor, d: Optional[torch.Tensor],
            indices: Optional[torch.Tensor], per: int, nz: Optional[torch.Tensor],
            ray_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The MLP of level `typ` (of a mixture: of submodule `sub`) on
        `points` (P, cfg.xyz_dim) with dirs `d` (P, 3), one appearance
        index in `indices` for every `per` points (or, for routed points,
        the index in row `ray_rows` of `indices`) and sigma noise `nz` ->
        (P, rgb_dim + 1)."""
        module = bundle.level(typ) if sub is None else bundle.module[sub]
        if fused:
            coords = None if d is None else \
                direction_coords(cfg, points, d).float().contiguous()
            app = None
            if cfg.appearance_dim > 0:
                # One row per index (per ray), then spread over the points: a
                # lookup per point would sum each table row's gradient over
                # every point of its image one after another.
                app = module.appearance(indices)
                if train:
                    app = app.float()  # compute-dtype-exact f32 rows; grads sum in f32
                if ray_rows is not None:
                    app = app[ray_rows]
                else:
                    app = app[:, None].expand(app.shape[0], per, app.shape[-1])
                app = app.reshape(points.shape[0], -1).contiguous()
            if train:
                return fused_nerf_train_apply(module, points, coords, app, nz)
            if wide:
                return fused_nerf_eval_wide(packed_params(bundle, typ, sub), points,
                                            coords, app)
            return fused_nerf_eval(packed_params(bundle, typ, sub), points, coords, app)
        idx = None
        if cfg.appearance_dim > 0:
            idx = indices[ray_rows] if ray_rows is not None else \
                indices[:, None].expand(-1, per).reshape(points.shape[0])
        if settings.remat and torch.is_grad_enabled():
            # The noise is drawn by the caller, so the recompute sees the same.
            return torch.utils.checkpoint.checkpoint(
                module, points, d, idx, nz, use_reentrant=False)
        return module(points, d, idx, nz)

    def take(t: Optional[torch.Tensor], rows: torch.Tensor) -> Optional[torch.Tensor]:
        return None if t is None else t[rows].contiguous()

    out_dim = cfg.rgb_dim + 1
    if not bundle.is_mega:
        out = run(None, flat_xyz, dirs, image_indices, samples, noise)
    else:
        # [routing xyz | model input] for a background mixture.
        points = flat_xyz[:, 3:].contiguous() if bundle.xyz_real else flat_xyz
        weights = cluster_weights(flat_xyz[:, :3], bundle.centroids,
                                  bundle.boundary_margin, bundle.cluster_dim_start)
        if ray_experts is not None and not train:
            out = mega_apply_ray_routed(
                lambda k, rows, rays: run(k, points[rows], take(dirs, rows),
                                          take(image_indices, rays), samples, None),
                weights, ray_experts, samples, out_dim, log=bundle.route_log)
        elif train or bundle.use_routed:
            # A trained mixture is hard-assigned (margin 1): M = 1.
            out = mega_apply_routed(
                lambda k, rows: run(
                    k, points[rows], take(dirs, rows), image_indices, 1,
                    take(noise, rows),
                    torch.div(rows, samples, rounding_mode="floor")),
                weights, bundle.max_experts, out_dim, log=bundle.route_log)
        else:
            out = mega_apply(
                lambda k: run(k, points, dirs, image_indices, samples, None),
                weights, active)
    return out[:, -1:] if sigma_only else out


def _model_eval(
    bundle: ModelBundle,
    typ: str,
    settings: RenderSettings,
    xyz: torch.Tensor,  # (N, S, D)
    rays_d: torch.Tensor,  # (N, 1, 3)
    image_indices: Optional[torch.Tensor],  # (N,)
    train: bool,
    generator: Optional[torch.Generator],
    active: Optional[Sequence[int]] = None,
    ray_experts: Optional[Sequence[Tuple[int, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate level `typ`'s MLP on all samples (`query_points`) ->
    (rgbs (N, S, 3), sigmas (N, S)); with `sh_deg` the SH coefficients
    become rgb here. A mixture runs only the submodules in `active` when
    given, or routes the rays over `ray_experts` (eval)."""
    cfg = bundle.config
    n, s, d = xyz.shape
    dirs = None
    if cfg.pos_dir_dim > 0:
        dirs = rays_d.expand(n, s, 3).reshape(n * s, 3)

    noise = None
    if train and generator is not None and settings.sigma_noise:
        # Uniform [0, 1) pre-activation density noise, rounded to the
        # compute dtype as the JAX package does (PARITY.md 2.1).
        noise = torch.rand((n * s,), generator=generator, device=xyz.device)
        noise = noise.to(cfg.dtype).float()

    out = query_points(bundle, typ, settings, xyz.reshape(n * s, d), dirs,
                       image_indices, samples=s, active=active,
                       ray_experts=ray_experts, train=train, noise=noise)
    if settings.sh_deg is not None:
        k = (settings.sh_deg + 1) ** 2
        coeffs = out[:, :3 * k].reshape(n * s, 3, k)
        sh_dirs = rays_d.expand(n, s, 3).reshape(n * s, 3)
        rgb = torch.sigmoid(eval_sh(settings.sh_deg, coeffs, sh_dirs))
        out = torch.cat([rgb, out[:, 3 * k:]], -1)
    out = out.reshape(n, s, out.shape[-1])
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
    active: Optional[Sequence[int]] = None,
    ray_experts: Optional[Sequence[Tuple[int, torch.Tensor]]] = None,
) -> None:
    """One sampling level: MLP eval + (optional coarse merge) + compositing.
    The coarse raw outputs are stashed in `results` and merged into the
    fine pass. `active`: a mixture's submodules to run (`mega_apply`);
    `ray_experts`: its per-ray routing (`mega_apply_ray_routed`)."""
    merge_prev = "zvals_coarse" in results

    if flip and not merge_prev:
        xyz = torch.flip(xyz, dims=(-2,))
        z_vals = torch.flip(z_vals, dims=(-1,))
        if depth_real is not None:
            depth_real = torch.flip(depth_real, dims=(-1,))

    rgbs, sigmas = _model_eval(bundle, typ, settings, xyz, rays_d,
                               image_indices, train, generator, active, ray_experts)

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
    active: Optional[Sequence[int]] = None,
    ray_experts: Optional[Sequence[Tuple[int, torch.Tensor]]] = None,
) -> Dict[str, torch.Tensor]:
    """Coarse pass + hierarchical fine pass. Under the cascade the coarse
    pass composites its own rgb (and bg_lambda) and the fine level
    evaluates the sorted union of the coarse and fine depths."""
    results: Dict[str, torch.Tensor] = {}
    cascade = settings.use_cascade
    get_var = settings.get_depth_variance

    capped = last_delta[:, 0] < INF_DELTA
    z_max = torch.amax(z_vals, -1)
    last_delta_c = last_delta - torch.where(capped, z_max, 0.0)[:, None]

    _inference(
        results, "coarse", bundle, settings, rays_d, image_indices,
        xyz_coarse, z_vals, last_delta_c,
        composite_rgb=cascade or fine_samples == 0,
        get_depth=(fine_samples == 0) and get_depth,
        get_depth_variance=(fine_samples == 0) and get_var,
        get_weights=fine_samples > 0,
        get_bg_lambda=get_bg_lambda and (cascade or fine_samples == 0),
        flip=flip,
        depth_real=depth_real,
        train=train,
        generator=generator,
        active=active,
        ray_experts=ray_experts,
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
    if cascade:
        fine_z_vals = torch.sort(torch.cat([z_vals, fine_z_vals], -1), -1).values

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
        active=active,
        ray_experts=ray_experts,
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
    fg_bounds: Optional[torch.Tensor] = None,  # (N, 2)
    fg_active: Optional[Sequence[int]] = None,
    fg_ray_support=None,  # (N, K) bool, numpy or tensor
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Render a batch of rays -> (results, bg_rays_present (bool scalar
    tensor)). Results carry `rgb_fine`, `depth_fine` (with `get_depth`),
    `depth_variance_fine` (with `get_depth_variance`), `fg_rgb_fine` /
    `bg_rgb_fine` (with `get_bg_fg_rgb`), ... as the JAX package's
    `render_rays`. `train` enables perturbation and sigma noise drawn from
    `generator` (none without one) and the differentiable fused MLP.

    `fg_bounds`: per-ray [lo, hi] of the occupied foreground interval
    (`render/ray_bounds.tighten_rays`); the fg samples span
    [max(near, lo), max(min(far, hi), near)]. `fg_active`: a fg mixture's
    submodules that can have nonzero weight on these rays
    (`render/cell_cull.py`); the others are not run. `fg_ray_support`:
    which cells (columns) each ray's fg samples can route to
    (`cell_cull.ray_support_masks`, a superset); a fg mixture then routes
    whole rays to their supported cells
    (`mega_apply_ray_routed`; eval only, as in the JAX package). The bg
    mixture is never culled or ray-routed."""
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
        # A mixture background routes on real-world coordinates, which
        # lead its points.
        real = (bg.is_mega and bg.xyz_real, bg.cluster_dim_start == 1)
        bg_pts, bg_depth_real = depth2pts_outside(
            rays_o3, rays_d3, bg_z, sphere_center, sphere_radius, *real
        )
        bg_results = _get_results(
            bg, settings, rays_d3, image_indices, bg_pts, bg_z,
            torch.full((n_rays, 1), INF_DELTA, device=rays.device),
            get_depth=settings.get_depth,
            get_bg_lambda=False,
            flip=True,
            depth_real=bg_depth_real,
            xyz_fine_fn=lambda fz: depth2pts_outside(
                rays_o3, rays_d3, fz, sphere_center, sphere_radius, *real
            ),
            fine_samples=settings.fine_samples // 2,
            train=train,
            generator=jitter,
        )

    if fg_bounds is not None:
        # The tightened interval can only shrink. A collapsed (zero-width)
        # interval means the bake saw nothing on the ray: every fg delta is
        # 0 and the trailing last_delta is zeroed below, so the fg
        # contribution is exactly zero wherever the ray collapsed (the cull
        # boxes rely on it).
        near = torch.maximum(near, fg_bounds[:, 0:1])
        far0 = far
        far = torch.maximum(torch.minimum(far, fg_bounds[:, 1:2]), near)
        # Where the far end shrank, the span past it is declared empty, so
        # the final sample's trailing segment must not span it: cap the
        # (absolute, for values below INF_DELTA) exit depth at one sample
        # spacing past the tightened far. Only sub-INF rays (a background
        # composites behind the fg) are capped: a ray whose last_delta is
        # INF_DELTA ends inside the scene, and its final sample must keep
        # absorbing all residual transmittance (alpha = 1 for any sigma >
        # 0); capping it drops that mass (the JAX package measured a -4 dB
        # darkening of live rays without this rule).
        seg = (far - near) / settings.coarse_samples
        shrunk = (far < far0 - 1e-6 * torch.abs(far0)) & (last_delta < INF_DELTA)
        last_delta = torch.where(shrunk, torch.minimum(last_delta, far + seg), last_delta)
        # Collapsed rays: depth `far` maps to a zero trailing segment.
        last_delta = torch.where(far > near, last_delta, far)

    z_steps = torch.linspace(0.0, 1.0, settings.coarse_samples,
                             device=rays.device)
    z_vals = near * (1.0 - z_steps) + far * z_steps
    z_vals = expand_and_perturb_z_vals(z_vals, perturb, jitter)
    xyz_coarse = rays_o3 + rays_d3 * z_vals[..., None]

    fg_experts = None
    if fg_ray_support is not None and fg.is_mega and not train:
        fg_experts = ray_route_experts(fg_ray_support, rays.device)
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
        active=fg_active,
        ray_experts=fg_experts,
    )

    if bg is not None:
        types = ["fine" if settings.fine_samples > 0 else "coarse"]
        if settings.use_cascade and settings.fine_samples > 0:
            types.append("coarse")
        for typ in types:
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
