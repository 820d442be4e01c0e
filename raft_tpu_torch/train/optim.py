"""Optimizer and learning-rate schedule for RAFT training, with optax's
semantics exactly.

Ported from the JAX package's ``raft_tpu/train/optim.py``, which chains
``optax.clip_by_global_norm`` and ``optax.adamw`` under a linear one-cycle
schedule. ``torch.optim.AdamW``, ``OneCycleLR`` and ``clip_grad_norm_``
each differ from that chain, so it is written out here as plain functions
over parameter lists (``torch._foreach_*``):

  * the schedule is ``optax.join_schedules`` of two ``linear_schedule``s,
    evaluated in fp32 at the optimizer's own update count, from 0: the
    first update uses ``max_lr / div_factor``;
  * the clip is ``clip_by_global_norm``: ``(g / |g|) * max_norm`` only
    when ``|g| >= max_norm`` (torch adds 1e-6 to the norm);
  * the update is ``scale_by_adam`` (bias-corrected ``m / (sqrt(v) +
    eps)``, eps outside the root), then ``add_decayed_weights`` on every
    parameter (biases and norm scales included), then ``* -lr``.

The state is ``{"count", "mu", "nu"}``: an int32 0-d tensor (optax's Adam
count and its schedule count, which always agree) and one moment tensor
per parameter. :meth:`Optimizer.update` is pure: it returns new tensors
and changes nothing, so a caller can still choose the old state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

__all__ = ["one_cycle_lr", "make_optimizer", "global_norm", "Optimizer"]

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: fp32 ``(init - end) * (1 - c / T) + end``
    with the count ``c`` clipped to ``[0, T]``."""

    def schedule(count):
        frac = 1 - torch.clamp(count, 0, transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def one_cycle_lr(
    max_lr: float,
    total_steps: int,
    *,
    pct_start: float = 0.05,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Schedule:
    """Linear one-cycle schedule: ``max_lr/div_factor -> max_lr`` over the
    first ``pct_start`` of the steps, then linearly to
    ``max_lr/div_factor/final_div_factor``. Takes the count as an integer
    tensor (or an int) and returns an fp32 tensor on its device."""
    init_lr = max_lr / div_factor
    final_lr = init_lr / final_div_factor
    warmup = max(int(pct_start * total_steps), 1)
    ramp = _linear_schedule(init_lr, max_lr, warmup)
    anneal = _linear_schedule(max_lr, final_lr, max(total_steps - warmup, 1))

    def schedule(count):
        count = torch.as_tensor(count, dtype=torch.int32)
        return torch.where(count < warmup, ramp(count), anneal(count - warmup))

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum of squares of
    every element, as a 0-d fp32 tensor."""
    return torch.sqrt(torch.stack([torch.sum(t * t) for t in tensors]).sum())


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Gradient-clipped AdamW (``make_optimizer``'s result).
    ``learning_rate`` is a float or a schedule of the update count."""

    learning_rate: Union[float, Schedule]
    weight_decay: float = 1e-4
    clip_norm: float = 1.0
    eps: float = 1e-8
    b1: float = 0.9
    b2: float = 0.999

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        """Zero moments and a zero count on the parameters' device."""
        device = params[0].device
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": [torch.zeros_like(p) for p in params],
            "nu": [torch.zeros_like(p) for p in params],
        }

    def lr(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate at update count ``count`` (fp32 tensor)."""
        if callable(self.learning_rate):
            return self.learning_rate(count).to(torch.float32)
        return torch.full((), self.learning_rate, dtype=torch.float32, device=count.device)

    def update(
        self, grads: Sequence[torch.Tensor], state: Dict, params: Sequence[torch.Tensor]
    ) -> Tuple[List[torch.Tensor], Dict]:
        """``(new_params, new_state)`` for ``grads``; nothing is changed in
        place. Makes no host sync."""
        grads, params = list(grads), list(params)
        # clip_by_global_norm
        g_norm = global_norm(grads)
        keep = g_norm < self.clip_norm
        scaled = torch._foreach_mul(torch._foreach_div(grads, g_norm), self.clip_norm)
        grads = [torch.where(keep, g, s) for g, s in zip(grads, scaled)]
        # scale_by_adam
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - self.b1), torch._foreach_mul(state["mu"], self.b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - self.b2),
            torch._foreach_mul(state["nu"], self.b2),
        )
        count = state["count"] + 1
        c = count.to(torch.float32)
        # torch.full fills on the device; torch.tensor would copy from the
        # host and sync the step
        bc1 = 1 - torch.pow(torch.full((), self.b1, dtype=torch.float32, device=c.device), c)
        bc2 = 1 - torch.pow(torch.full((), self.b2, dtype=torch.float32, device=c.device), c)
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), self.eps)
        updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        # add_decayed_weights, then the (negative) learning rate at the
        # count before this update
        updates = torch._foreach_add(updates, torch._foreach_mul(params, self.weight_decay))
        updates = torch._foreach_mul(updates, -self.lr(state["count"]))
        return torch._foreach_add(params, updates), {"count": count, "mu": mu, "nu": nu}


def make_optimizer(
    learning_rate,
    *,
    weight_decay: float = 1e-4,
    clip_norm: float = 1.0,
    eps: float = 1e-8,
    b1: float = 0.9,
    b2: float = 0.999,
) -> Optimizer:
    """Gradient-clipped AdamW; ``learning_rate`` may be a float or a
    schedule (:func:`one_cycle_lr`)."""
    return Optimizer(learning_rate, weight_decay=weight_decay, clip_norm=clip_norm, eps=eps, b1=b1, b2=b2)
