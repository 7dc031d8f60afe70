"""The training step: render -> loss -> gradients -> optimizer update.

Counterpart of the JAX package's `parallel/train_step.py`:

- loss = MSE on the fine rgb; under the coarse/fine cascade the mean of
  it and the coarse rgb's MSE (`coarse_loss`); plus the Mip-NeRF 360
  distortion term when `distortion_loss_weight > 0`; metrics
  `photo_loss`, `psnr` (of the fine photo loss), `depth_variance`
  (`coarse_loss`, `distortion`), `loss`;
- `torch.optim.Adam` with optax's defaults (betas 0.9 / 0.999, eps 1e-8)
  over the module's parameters in state-dict order (a cascade's coarse
  level, then its fine level; a mixture's K submodules in order, one Adam
  for all of them), its learning rate `lr * decay^(t / T)` applied per
  step by a `LambdaLR`. A parameter the step did not reach (a mixture's
  submodule that got no point) gets a zero gradient, as optax applies one:
  its moments decay and momentum still moves it, where `torch.optim.Adam`
  would skip it and hold back its step count;
- the background step is skipped when the batch holds no background ray:
  its parameters, Adam state and schedule stay as they were;
- over a data group of D ranks (`group`, `parallel/distributed.py`), each
  rank's gradients, metrics and background flag are summed in one
  all-reduce and divided by D (the JAX `pmean`), after the missing
  gradients got their zeros, so every rank reduces the same tensors (a
  mixture submodule may get points on one rank and none on another). The
  background step is skipped only when no rank saw a background ray (the
  JAX `pmax`). The data-parallel Runner, one program over the global batch
  in the JAX package, reports the psnr of the mean photo loss; the cell
  step (`pmean_psnr`) the mean of the ranks' psnrs, as the JAX `pmean` of
  the cell metrics does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from mega_nerf_tpu_torch.models.factory import ModelBundle
from mega_nerf_tpu_torch.parallel.distributed import Group, all_reduce_
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def make_optimizer(
    module: torch.nn.Module, lr: float, lr_decay_factor: float,
    train_iterations: int,
) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam + per-step exponential decay lr * decay^(t / total)."""
    opt = torch.optim.Adam(module.parameters(), lr=lr, betas=ADAM_BETAS,
                           eps=ADAM_EPS)
    return opt, schedule(opt, lr_decay_factor, train_iterations)


def schedule(opt: torch.optim.Optimizer, lr_decay_factor: float,
             train_iterations: int, steps_done: int = 0):
    """The per-step decay, positioned after `steps_done` updates (with
    `steps_done` > 0 the optimizer's saved state must be loaded first)."""
    if steps_done > 0:
        for group in opt.param_groups:
            group.setdefault("initial_lr", group["lr"])
    return torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: lr_decay_factor ** (t / train_iterations),
        last_epoch=steps_done - 1)


def adam_steps(opt: torch.optim.Optimizer) -> int:
    """Updates an Adam state has taken (0 before the first)."""
    steps = [int(s["step"]) for s in opt.state.values() if "step" in s]
    return max(steps, default=0)


class TrainStep:
    """One training step over fg (+ bg) bundles; holds the optimizers."""

    def __init__(
        self,
        fg: ModelBundle,
        bg: Optional[ModelBundle],
        settings: RenderSettings,
        lr: float,
        lr_decay_factor: float,
        train_iterations: int,
        sphere_center: Optional[torch.Tensor] = None,
        sphere_radius: Optional[torch.Tensor] = None,
        use_appearance: bool = True,
        group: Optional[Group] = None,
        pmean_psnr: bool = False,
    ):
        self.fg, self.bg = fg, bg
        self.group = group if group is not None and group.size > 1 else None
        self.pmean_psnr = pmean_psnr
        self.settings = dataclasses.replace(
            settings, get_depth=False, get_depth_variance=True,
            get_bg_fg_rgb=False)
        self.typ = "fine" if settings.fine_samples > 0 else "coarse"
        self.sphere_center, self.sphere_radius = sphere_center, sphere_radius
        self.use_appearance = use_appearance
        self.lr, self.decay, self.total = lr, lr_decay_factor, train_iterations
        self.fg_opt, self.fg_sched = make_optimizer(
            fg.module, lr, lr_decay_factor, train_iterations)
        self.bg_opt = self.bg_sched = None
        if bg is not None:
            self.bg_opt, self.bg_sched = make_optimizer(
                bg.module, lr, lr_decay_factor, train_iterations)

    def load_optimizer_states(self, states: Dict) -> None:
        """Adam states by the reference names ("nerf", "bg_nerf"), as a port
        `{iter}.pt` holds them or as `runtime/checkpoints.py` maps a JAX
        `.ckpt`'s optax states; each schedule resumes at its optimizer's own
        step count (the background's may lag behind after skipped steps)."""
        pairs = [("nerf", "fg")] + ([("bg_nerf", "bg")] if self.bg else [])
        for name, side in pairs:
            if name not in states:
                continue
            opt = getattr(self, f"{side}_opt")
            opt.load_state_dict(states[name])
            setattr(self, f"{side}_sched",
                    schedule(opt, self.decay, self.total, adam_steps(opt)))

    def optimizer_states(self) -> Dict:
        out = {"nerf": self.fg_opt.state_dict()}
        if self.bg_opt is not None:
            out["bg_nerf"] = self.bg_opt.state_dict()
        return out

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator]):
        """-> (loss, metrics (detached), bg_rays_present)."""
        idx = batch["img_indices"] if self.use_appearance else None
        results, bg_present = render_rays(
            self.fg, self.bg, batch["rays"], idx, self.settings,
            self.sphere_center, self.sphere_radius, train=True,
            generator=generator)
        rgbs = batch["rgbs"]
        photo_loss = torch.mean((results[f"rgb_{self.typ}"] - rgbs) ** 2)
        loss = photo_loss
        metrics = {
            "photo_loss": photo_loss,
            "psnr": -10.0 * torch.log10(photo_loss),
            "depth_variance": torch.mean(results[f"depth_variance_{self.typ}"]),
        }
        if self.settings.use_cascade and self.typ == "fine":
            coarse_loss = torch.mean((results["rgb_coarse"] - rgbs) ** 2)
            metrics["coarse_loss"] = coarse_loss
            loss = (loss + coarse_loss) / 2
        w = self.settings.distortion_loss_weight
        if w > 0:
            distortion = torch.mean(results["distortion_coarse"])
            metrics["distortion"] = distortion
            loss = loss + w * distortion
        metrics["loss"] = loss
        return loss, {k: v.detach() for k, v in metrics.items()}, bg_present

    def gradients(self, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None):
        """Render and backpropagate into every parameter's `.grad`, averaged
        over the data group -> (metrics, a function reading whether any
        rank's batch held a background ray)."""
        opts = [opt for opt in (self.fg_opt, self.bg_opt) if opt is not None]
        for opt in opts:
            opt.zero_grad(set_to_none=True)
        loss, metrics, bg_present = self.loss(batch, generator)
        if self.group is None:
            bg_present = _host_flag(bg_present)
        loss.backward()
        for opt in opts:
            _zero_missing_grads(opt)
        if self.group is not None:
            metrics, bg_present = self._average(opts, metrics, bg_present)
            bg_present = _host_flag(bg_present)
        return metrics, bg_present

    def _average(self, opts, metrics: Dict[str, torch.Tensor],
                 bg_present: torch.Tensor):
        """One all-reduce of every gradient, metric and the bg flag over
        the group, divided by its size -> (metrics, flag of any rank)."""
        grads = [p.grad for opt in opts for g in opt.param_groups for p in g["params"]]
        keys = list(metrics)
        dtype = grads[0].dtype
        flat = torch.cat([t.reshape(-1).to(dtype) for t in grads]
                         + [metrics[k].reshape(1).to(dtype) for k in keys]
                         + [bg_present.reshape(1).to(dtype)])
        all_reduce_(flat, self.group)
        flat /= self.group.size
        offset = 0
        for t in grads:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        out = {k: flat[offset + i] for i, k in enumerate(keys)}
        if not self.pmean_psnr:
            out["psnr"] = -10.0 * torch.log10(out["photo_loss"])
        return out, flat[-1] > 0

    def __call__(self, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, torch.Tensor]:
        """Render, backpropagate, update -> metrics (device scalars)."""
        metrics, bg_present = self.gradients(batch, generator)
        self.fg_opt.step()
        self.fg_sched.step()
        if self.bg_opt is not None and bg_present():
            self.bg_opt.step()
            self.bg_sched.step()
        return metrics


def _zero_missing_grads(opt: torch.optim.Optimizer) -> None:
    """Give every parameter of `opt` without a gradient a zero one."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def _host_flag(flag: torch.Tensor):
    """-> a function returning bool(flag). A CUDA flag is copied into pinned
    host memory without waiting, and the wait happens only when the value is
    read: reading it after the backward is queued leaves the card busy with
    that backward instead of idle while the host decides the bg skip."""
    if flag.device.type != "cuda":
        return lambda: bool(flag)
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    host.copy_(flag, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def read() -> bool:
        done.synchronize()
        return bool(host)

    return read
