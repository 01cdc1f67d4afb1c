"""Learning-rate schedule and the clipped Adam update, as optax computes them.

Counterpart of the JAX package's ``train/setup.py`` (``make_lr_schedule``,
``make_tx``: ``optax.chain(clip_by_global_norm, adam(warmup_cosine))``).
The update is a few lines of the port's own on ``torch._foreach_*`` ops,
not ``torch.optim.Adam``, so that it follows optax's arithmetic:

* the schedule is evaluated at the step count *before* the increment and
  starts at 0, so the first update leaves every parameter unchanged;
* the clip leaves the gradients alone when their global norm is below the
  limit and otherwise scales them by limit / norm, with no epsilon;
* Adam has eps 1e-8, eps_root 0 and optax's bias correction.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional

import torch

from video_vae_tpu_torch.core.config import OptimConfig
from video_vae_tpu_torch.utils.debug import global_norm

ADAM_EPS = 1e-8


def make_lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps, lr·end_factor)."""
    peak = cfg.learning_rate
    warmup = max(1, int(cfg.warmup_steps))
    decay = cfg.decay_steps - warmup
    end = cfg.learning_rate * cfg.end_value_factor
    alpha = 0.0 if peak == 0.0 else end / peak
    if decay <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup  # linear from 0
        done = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * done / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


class Optimizer:
    """Global-norm clip, then Adam with the warmup-cosine learning rate.

    Holds the step count and the f32 first and second moments of each
    parameter. :meth:`update` changes the parameters in place. ``names``
    (the model's parameter paths, from :func:`create_optimizer`) key the
    moments when a JAX optimizer state is loaded.
    """

    def __init__(self, params: Iterable[torch.Tensor], cfg: OptimConfig,
                 names: Optional[Iterable[str]] = None):
        self.params: List[torch.Tensor] = list(params)
        self.names: List[str] = list(names) if names is not None else [str(i) for i in range(len(self.params))]
        if len(self.names) != len(self.params):
            raise ValueError(f"{len(self.names)} names for {len(self.params)} parameters")
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Apply one step for ``grads`` (one per parameter, same order).

        Returns the gradients' f32 global norm before the clip.
        """
        cfg = self.cfg
        norm = global_norm(grads)
        factor = torch.where(norm < cfg.clip_global_norm, 1.0, cfg.clip_global_norm / norm)
        g = torch._foreach_mul([x.float() for x in grads], factor)
        torch._foreach_mul_(self.mu, cfg.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - cfg.b1)
        torch._foreach_mul_(self.nu, cfg.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - cfg.b2)
        lr = self.schedule(self.count)
        self.count += 1
        mu_hat = torch._foreach_div(self.mu, 1.0 - cfg.b1**self.count)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1.0 - cfg.b2**self.count))
        torch._foreach_add_(denom, ADAM_EPS)
        step = torch._foreach_div(mu_hat, denom)
        params = [p.data for p in self.params]
        if all(p.dtype == torch.float32 for p in params):
            torch._foreach_add_(params, step, alpha=-lr)
        else:
            for p, s in zip(params, step):
                p.copy_((p.float() - lr * s).to(p.dtype))
        return norm

    def state_dict(self) -> dict:
        """``{"count": int, "mu": [...], "nu": [...]}``, the moments in parameter order."""
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``count`` and the moments of :meth:`state_dict` in, on the moments' device."""
        for key in ("mu", "nu"):
            if len(state[key]) != len(self.params):
                raise ValueError(f"{key}: {len(state[key])} moments for {len(self.params)} parameters")
            for i, (ours, theirs) in enumerate(zip(getattr(self, key), state[key])):
                if tuple(theirs.shape) != tuple(ours.shape):
                    raise ValueError(f"{key} of {self.names[i]}: shape {tuple(theirs.shape)}, "
                                     f"expected {tuple(ours.shape)}")
                ours.copy_(theirs)
        self.count = int(state["count"])


def create_optimizer(model: torch.nn.Module, cfg: OptimConfig) -> Optimizer:
    """The optimizer over every parameter of ``model``, in ``named_parameters`` order."""
    named = list(model.named_parameters())
    return Optimizer([p for _, p in named], cfg, names=[n.replace(".", "/") for n, _ in named])
