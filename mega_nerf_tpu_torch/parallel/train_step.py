"""The training step: render -> loss -> gradients -> optimizer update.

Counterpart of the JAX package's `parallel/train_step.py` for one process:

- loss = MSE on the fine rgb, plus the Mip-NeRF 360 distortion term when
  `distortion_loss_weight > 0`; metrics `photo_loss`, `psnr`,
  `depth_variance` (and `distortion`), `loss`;
- `torch.optim.Adam` with optax's defaults (betas 0.9 / 0.999, eps 1e-8)
  over the module's parameters in state-dict order, its learning rate
  `lr * decay^(t / T)` applied per step by a `LambdaLR`;
- the background step is skipped when the batch holds no background ray:
  its parameters, Adam state and schedule stay as they were.

The cascade (`--use_cascade`) is not ported yet; the model factory raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from mega_nerf_tpu_torch.models.factory import ModelBundle
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
    ):
        self.fg, self.bg = fg, bg
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
        """Adam states by the reference names ("nerf", "bg_nerf"); the
        schedules resume at each optimizer's own step count."""
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
        photo_loss = torch.mean((results[f"rgb_{self.typ}"] - batch["rgbs"]) ** 2)
        loss = photo_loss
        metrics = {
            "photo_loss": photo_loss,
            "psnr": -10.0 * torch.log10(photo_loss),
            "depth_variance": torch.mean(results[f"depth_variance_{self.typ}"]),
        }
        w = self.settings.distortion_loss_weight
        if w > 0:
            distortion = torch.mean(results["distortion_coarse"])
            metrics["distortion"] = distortion
            loss = loss + w * distortion
        metrics["loss"] = loss
        return loss, {k: v.detach() for k, v in metrics.items()}, bg_present

    def __call__(self, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, torch.Tensor]:
        """Render, backpropagate, update -> metrics (device scalars)."""
        for opt in (self.fg_opt, self.bg_opt):
            if opt is not None:
                opt.zero_grad(set_to_none=True)
        loss, metrics, bg_present = self.loss(batch, generator)
        bg_present = _host_flag(bg_present)
        loss.backward()
        self.fg_opt.step()
        self.fg_sched.step()
        if self.bg_opt is not None and bg_present():
            self.bg_opt.step()
            self.bg_sched.step()
        return metrics


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
