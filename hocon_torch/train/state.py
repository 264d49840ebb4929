"""Train state and optimizer: the counterpart of ``hocon/train/state.py``.

A torch optimizer needs its parameters when it is built, so
``make_optimizer`` returns an ``OptimizerSpec`` that builds the optimizer
and its learning-rate schedule from ``model.parameters()``;
``create_train_state`` does that and holds model, optimizer, schedule and
step count together. The updates are optax's: adam / adamw (``OptaxAdam``:
torch's fused AdamW with optax's bias corrections) and sgd with momentum
(``torch.optim.SGD``, the same trace as optax's), a staircase step decay
whose first update uses ``lr``, and global-norm clipping of the gradients before the update
(``optax.clip_by_global_norm``: scaled by max_norm / norm only when the
norm reaches max_norm, with no epsilon). Under a data-parallel mesh the
ranks' gradients are summed first, so the norm, the clip and the update
are the global batch's, the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch
from torch import nn

from hocon_torch.train.sharding import Mesh, reduce_gradients


class OptaxAdam(torch.optim.AdamW):
    """Adam, or AdamW with ``weight_decay``, with optax's bias corrections,
    on torch's fused AdamW kernel.

    optax evaluates the bias corrections ``1 - b^t`` in f32
    (``f32(0.999)^t``) where torch uses double, which moves each update by
    ~1e-5 of itself. Every parameter's step count starts where torch's
    own corrections are exactly 1 (``b^t`` underflows), and each step
    passes optax's in through the rate and epsilon: the update
    (m / bc1) / (sqrt(v / bc2) + eps) equals (lr * sqrt(bc2) / bc1) * m /
    (sqrt(v) + eps * sqrt(bc2)), and the decay rate is rescaled so that
    p *= 1 - lr * wd as in optax's adamw.
    """

    _START_STEP = 1e6  # 0.9^t and 0.999^t are 0 in double from here on

    def __init__(self, params, lr: float, eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=eps,
                         weight_decay=weight_decay, fused=True)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p].update(
                    step=torch.tensor(self._START_STEP, dtype=torch.float32, device=p.device),
                    exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                    exp_avg_sq=torch.zeros_like(p, memory_format=torch.preserve_format),
                )

    @torch.no_grad()
    def step(self, closure=None):
        saved = []
        for group in self.param_groups:
            group["count"] = count = group.get("count", 0) + 1
            b1, b2 = group["betas"]
            # As optax evaluates them: f32 decay ** f32 count (numpy's f32
            # power gives JAX's bits).
            one, n = np.float32(1.0), np.float32(count)
            bc1 = float(one - np.float32(b1) ** n)
            root_bc2 = float(np.sqrt(float(one - np.float32(b2) ** n)))
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            saved.append((lr, eps, wd))
            group["lr"] = lr * root_bc2 / bc1
            group["eps"] = eps * root_bc2
            # At rate 0 the step moves nothing, whatever the decay.
            group["weight_decay"] = wd * lr / group["lr"] if lr else wd
        super().step()
        for group, (lr, eps, wd) in zip(self.param_groups, saved):
            group["lr"], group["eps"], group["weight_decay"] = lr, eps, wd


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What ``hocon.train.state.make_optimizer`` configures."""

    name: str = "adam"
    lr: float = 5e-5
    momentum: float = 0.9
    weight_decay: float = 0.0
    lr_decay_step: int = 0
    lr_decay_gamma: float = 0.5
    grad_clip: float = 0.0

    def __post_init__(self):
        if self.name not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {self.name!r}")

    def build(self, params: Iterable[nn.Parameter]):
        """(optimizer, schedule) over ``params``; step the schedule once
        after every optimizer step."""
        params = list(params)
        if self.name == "adam":
            opt = OptaxAdam(params, lr=self.lr)
        elif self.name == "adamw":  # optax.adamw: decoupled decay scaled by lr
            opt = OptaxAdam(params, lr=self.lr, weight_decay=self.weight_decay)
        else:  # sgd; optax.sgd's trace: t = g + momentum * t
            opt = torch.optim.SGD(params, lr=self.lr, momentum=self.momentum)
        # optax.exponential_decay(staircase=True): lr * gamma^(count // step),
        # count being the number of updates already made.
        step, gamma = self.lr_decay_step, self.lr_decay_gamma
        factor = (lambda t: gamma ** (t // step)) if step > 0 else (lambda t: 1.0)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def make_optimizer(
    name: str = "adam",
    lr: float = 5e-5,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    lr_decay_step: int = 0,
    lr_decay_gamma: float = 0.5,
    grad_clip: float = 0.0,
) -> OptimizerSpec:
    """Reference optimizer surface: adam / adamw / sgd(+momentum), step-decay
    LR, optional global-norm clipping."""
    return OptimizerSpec(name, lr, momentum, weight_decay, lr_decay_step,
                         lr_decay_gamma, grad_clip)


@dataclasses.dataclass
class TrainState:
    """Model (the parameters), optimizer, schedule and update count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: torch.optim.lr_scheduler.LRScheduler
    grad_clip: float = 0.0
    step: int = 0


def create_train_state(model: nn.Module, optimizer: OptimizerSpec) -> TrainState:
    """Build ``optimizer`` over the parameters of ``model``."""
    opt, schedule = optimizer.build(model.parameters())
    return TrainState(model, opt, schedule, optimizer.grad_clip)


@torch.no_grad()
def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.sqrt(torch.stack([torch.sum(t.float() * t.float()) for t in tensors]).sum())


@torch.no_grad()
def apply_gradients(state: TrainState, mesh: Mesh | None = None) -> torch.Tensor:
    """Sum the gradients the parameters hold over the ``mesh``'s ranks, clip
    them, step optimizer and schedule, count the update. Returns the global
    norm of the gradients before clipping. A parameter the loss did not
    reach gets a zero gradient, as JAX gives it, so its optimizer state
    advances as optax's does."""
    params = list(state.model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    reduce_gradients(grads, mesh)
    norm = global_norm(grads)
    if state.grad_clip > 0:
        # Decided on the device: no host sync inside the step.
        keep = norm < state.grad_clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * state.grad_clip))
    state.optimizer.step()
    state.schedule.step()
    state.step += 1
    return norm
