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

Under a mesh (:func:`create_sharded_model`) the optimizer updates each
parameter's fsdp shard and keeps its moments at the shard's shape, as JAX's
``create_optimizer`` places them; the clip's norm is over every shard.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from video_vae_tpu_torch.core.config import OptimConfig
from video_vae_tpu_torch.parallel.mesh import mesh_shape
from video_vae_tpu_torch.parallel.sharding import ParamSharding, model_sharding
from video_vae_tpu_torch.parallel.tensor_parallel import TensorGroup

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
    moments when a JAX optimizer state is loaded. With ``sharding`` (the
    model's :class:`ParamSharding`) the update and the moments are the
    rank's fsdp shards, and the updated shards are all-gathered afterwards.
    """

    def __init__(self, params: Iterable[torch.Tensor], cfg: OptimConfig,
                 names: Optional[Iterable[str]] = None, sharding: Optional[ParamSharding] = None):
        self.params: List[torch.Tensor] = list(params)
        self.names: List[str] = list(names) if names is not None else [str(i) for i in range(len(self.params))]
        if len(self.names) != len(self.params):
            raise ValueError(f"{len(self.names)} names for {len(self.params)} parameters")
        self.cfg = cfg
        self.sharding = sharding if sharding is not None else ParamSharding(list(zip(self.names, self.params)))
        self.schedule = make_lr_schedule(cfg)
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.shards()]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.shards()]

    def shards(self) -> List[torch.Tensor]:
        """The tensors the update writes: each parameter's fsdp shard (a view
        into it; on one device its data)."""
        return [self.sharding.shard(n, p.data) for n, p in zip(self.names, self.params)]

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Apply one step for ``grads`` (one per parameter, same order; under a
        mesh the global batch's gradient of each shard).

        Returns the gradients' f32 global norm before the clip.
        """
        cfg = self.cfg
        norm = self.sharding.grad_norm(grads)
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
        params = self.shards()
        if all(p.dtype == torch.float32 for p in params):
            torch._foreach_add_(params, step, alpha=-lr)
        else:
            for p, s in zip(params, step):
                p.copy_((p.float() - lr * s).to(p.dtype))
        self.sharding.gather_shards(self.params)
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


def create_optimizer(model: nn.Module, cfg: OptimConfig, mesh: Optional[DeviceMesh] = None) -> Optimizer:
    """The optimizer over every parameter of ``model``, in ``named_parameters``
    order; its moments sharded like their parameters where the model was
    built by :func:`create_sharded_model` (``mesh`` is that model's)."""
    named = list(model.named_parameters())
    sharding = model_sharding(model)
    if sharding.mesh is not None and mesh is not None and sharding.mesh is not mesh:
        raise ValueError("the model was sharded over another mesh")
    return Optimizer([p for _, p in named], cfg, names=[n.replace(".", "/") for n, _ in named],
                     sharding=sharding)


def create_sharded_model(model_fn: Callable[[], nn.Module], mesh: Optional[DeviceMesh] = None) -> nn.Module:
    """``model_fn()``, its parameters cut to this rank's place on ``mesh``.

    Every rank builds the model from the same seed, so the weights are the
    one-process model's; then each parameter keeps its compute view (its
    tensor piece, see ``parallel/sharding.py``) and each block's attention
    and MLP get the tensor group where the rules split them. The model's
    ``sharding`` attribute holds the layout. Without a mesh, or on a mesh of
    one rank, the model is returned as built.
    """
    model = model_fn()
    if mesh is None or all(s == 1 for s in mesh_shape(mesh).values()):
        return model
    from video_vae_tpu_torch.models.layers import MLP, Attention

    sharding = ParamSharding(model, mesh)
    tensor = sharding.sizes["tensor"]
    if tensor > 1:
        tp = TensorGroup(sharding.groups["tensor"], tensor)
        for path, module in model.named_modules():
            prefix = path.replace(".", "/") + "/"
            if isinstance(module, Attention):
                if module.num_heads % tensor:
                    raise ValueError(f"{path}: {module.num_heads} heads do not split over tensor={tensor}")
                split = [sharding.axis_dim(prefix + n, "tensor") for n in (
                    "qkv_projection/kernel", "qkv_projection/bias", "out_projection/kernel")]
                if split != [1, 0, 0]:
                    raise ValueError(f"{path}: the rules split its products as {split}")
                module.tensor_parallel = tp
            elif isinstance(module, MLP) and sharding.axis_dim(prefix + "linear1/kernel", "tensor") is not None:
                module.tensor_parallel = tp
    with torch.no_grad():
        for name, p in zip(sharding.names, model.parameters()):
            view = sharding.compute_view(name, p.data)
            p.data = p.data if view is p.data else view.clone(memory_format=torch.contiguous_format)
    model.sharding = sharding
    return model
