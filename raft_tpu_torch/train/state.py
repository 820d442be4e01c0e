"""Training state: the model, the optimizer state and the step counters.

Ported from the JAX package's ``raft_tpu/train/state.py``. Where the JAX
state is one donated pytree of arrays, the port's holds the model itself
(its parameters and its BatchNorm running statistics are the params and
``batch_stats``), the optimizer state ``{"count", "mu", "nu"}`` and four
device scalars: ``step``, ``skipped_steps`` and ``good_steps`` (int32) and
``grad_ema`` (fp32), which the skip guard of ``train.step`` keeps. A train
step updates it in place, the counterpart of donation.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

__all__ = ["TrainState"]

_SCALARS = ("step", "skipped_steps", "good_steps", "grad_ema")


class TrainState:
    def __init__(self, model: nn.Module, opt_state: Dict, *, step, skipped_steps, good_steps, grad_ema):
        self.model = model
        self.opt_state = opt_state
        self.step = step
        self.skipped_steps = skipped_steps
        self.good_steps = good_steps
        self.grad_ema = grad_ema

    @classmethod
    def create(cls, model: nn.Module, tx) -> "TrainState":
        """A fresh state on the model's device: zero counters, ``tx``'s
        initial optimizer state."""
        device = next(model.parameters()).device
        zero = lambda dtype: torch.zeros((), dtype=dtype, device=device)  # noqa: E731
        return cls(model, tx.init(list(model.parameters())), step=zero(torch.int32),
                   skipped_steps=zero(torch.int32), good_steps=zero(torch.int32), grad_ema=zero(torch.float32))

    def state_dict(self) -> Dict:
        """Every tensor of the state, detached copies on the CPU: the
        model's state_dict (parameters and BatchNorm buffers), the
        optimizer state and the counters."""
        cpu = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
        return {
            "model": {k: cpu(v) for k, v in self.model.state_dict().items()},
            "opt_state": {
                "count": cpu(self.opt_state["count"]),
                "mu": [cpu(t) for t in self.opt_state["mu"]],
                "nu": [cpu(t) for t in self.opt_state["nu"]],
            },
            **{k: cpu(getattr(self, k)) for k in _SCALARS},
        }

    def load_state_dict(self, state: Dict) -> None:
        """Copy ``state`` (from :meth:`state_dict`) into this state's
        tensors, on their devices; shapes and dtypes must match."""
        self.model.load_state_dict(state["model"], strict=True)
        opt = state["opt_state"]
        with torch.no_grad():
            for key in ("mu", "nu"):
                mine = self.opt_state[key]
                if len(opt[key]) != len(mine):
                    raise ValueError(f"optimizer state {key!r} has {len(opt[key])} tensors, want {len(mine)}")
                for dst, src in zip(mine, opt[key]):
                    dst.copy_(src)
            self.opt_state["count"].copy_(opt["count"])
            for k in _SCALARS:
                getattr(self, k).copy_(state[k])
