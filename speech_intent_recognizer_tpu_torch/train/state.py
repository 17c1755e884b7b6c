"""Optimizer and learning-rate schedule.

Counterpart of ``speech_intent_recognizer_tpu/train/state.py``, whose optax
chain is, in order: ``clip_by_global_norm(grad_clip)`` on the raw
gradients, ``add_decayed_weights(weight_decay)`` (L2 added to the gradient,
torch Adam's ``weight_decay``), ``scale_by_adam`` and the learning rate
(constant, or a linear warmup with optional cosine decay).  Here:

* the clip is optax's rule (scale by ``max_norm / norm`` when the fp32
  global norm reaches ``max_norm``, no epsilon), applied on the device
  before ``torch.optim.Adam.step``, whose ``weight_decay`` then adds the L2
  term — so the clip sees the raw gradients, as in the chain;
* the schedule gives, for the k-th update (k from 0), the learning rate the
  optax schedule gives at count k.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

# the reference recipe's Adam constants (optax.scale_by_adam defaults)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def lr_schedule(lr: float, warmup_steps: int = 0, schedule: str = "constant",
                total_steps: Optional[int] = None
                ) -> Optional[Callable[[int], float]]:
    """count -> learning rate, as the JAX package's ``create_optimizer``
    builds it: ``optax.linear_schedule`` warmup from 0 (constant), or
    ``optax.warmup_cosine_decay_schedule`` to 0 over ``total_steps``
    (cosine).  None for a constant rate without warmup."""
    if not warmup_steps and schedule == "constant":
        return None
    warm = max(int(warmup_steps), 1)
    if schedule == "constant":
        return lambda count: lr * min(count, warm) / warm
    if schedule != "cosine":
        raise ValueError(f"unknown schedule {schedule!r}")
    if not total_steps:
        raise ValueError("schedule='cosine' requires total_steps")
    decay = int(total_steps) - warm
    if decay <= 0:
        raise ValueError(f"cosine decay needs total_steps > warmup "
                         f"({total_steps} <= {warm})")

    def cosine(count: int) -> float:
        if count < warm:
            return lr * count / warm
        c = min(count - warm, decay)
        return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return cosine


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float) -> None:
    """optax ``clip_by_global_norm`` in place: scale every gradient by
    ``max_norm / norm`` when their fp32 global norm reaches ``max_norm``
    (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``)."""
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


class Optimizer:
    """The reference recipe's Adam chain over a model's parameters."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 5e-5,
                 weight_decay: float = 1e-4, grad_clip: Optional[float] = 1.0,
                 schedule: Optional[Callable[[int], float]] = None):
        self.params = [p for p in params if p.requires_grad]
        self.lr = lr
        self.grad_clip = grad_clip if grad_clip and grad_clip > 0 else None
        self.schedule = schedule
        self.count = 0
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=ADAM_BETAS,
                                     eps=ADAM_EPS,
                                     weight_decay=weight_decay or 0.0)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        """Clip (optax ``clip_by_global_norm``), then the Adam update at
        this count's learning rate."""
        if self.grad_clip is not None:
            clip_by_global_norm_(
                [p.grad for p in self.params if p.grad is not None],
                self.grad_clip)
        lr = self.lr if self.schedule is None else self.schedule(self.count)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def create_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 5e-5,
                     weight_decay: float = 1e-4,
                     grad_clip: Optional[float] = 1.0, warmup_steps: int = 0,
                     schedule: str = "constant",
                     total_steps: Optional[int] = None) -> Optimizer:
    """The JAX package's ``create_optimizer``, over torch parameters."""
    return Optimizer(params, lr=lr, weight_decay=weight_decay,
                     grad_clip=grad_clip,
                     schedule=lr_schedule(lr, warmup_steps, schedule,
                                          total_steps))


def optimizer_from_config(cfg, params: Iterable[torch.nn.Parameter],
                          n_train: int) -> Optimizer:
    """The optimizer a config describes, the cosine horizon resolved from
    the dataset size (total steps = epochs x ceil(n_train / batch)), as the
    JAX ``optimizer_from_config`` does."""
    t = cfg.train
    total = t.epochs * -(-n_train // t.batch_size)
    return create_optimizer(
        params, lr=t.lr, weight_decay=t.weight_decay, grad_clip=t.grad_clip,
        warmup_steps=t.warmup_steps, schedule=t.lr_schedule,
        total_steps=total)
