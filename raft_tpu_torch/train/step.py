"""The train and eval steps.

Ported from the JAX package's ``raft_tpu/train/step.py``
(``make_train_step_fn``, ``make_train_step``, ``make_eval_step``). One
train step runs the forward with every iteration's flow, the sequence
loss, the backward, the global norm of the unclipped gradients, then the
optimizer's update, all under :func:`~raft_tpu_torch.device.fp32_precision`
(outside it cuDNN runs the backward convolutions in TF32 by default). It
updates the :class:`~raft_tpu_torch.train.state.TrainState` in place and
returns it with its metrics, 0-d tensors left on the device: the step makes
no host sync, so the host can run ahead to the trainer's log boundary.

Batch contract (NCHW): ``image1``/``image2`` ``(B, 3, H, W)`` in [-1, 1],
``flow`` ``(B, 2, H, W)``, optional ``valid`` ``(B, H, W)``.

``numerics_policy='skip'`` arms the divergence guard: the candidate
update is computed, then chosen on the device by ``torch.where``, so a
step with a nonfinite gradient, loss or gradient norm (or, with
``spike_factor > 0``, a gradient norm above ``spike_factor`` times the
running EMA once ``spike_warmup`` updates were applied) leaves the
parameters, the optimizer's count and moments and the BatchNorm buffers
bitwise as they were. The schedule's count is the optimizer's, so after a
skip the learning rate lags ``state.step``, as in the JAX step.

``corr_impl='dense'`` and ``'fused'`` (fp32 and bf16 levels) train: the
fused block's kernel runs the forward and the dense formulation's autograd
the backward (``kernels.lookup_xtap.project_fused_diff``). ``'pallas'``
does not: K3 defines no gradient in either package.

:func:`make_window_step_fn` runs ``window_size`` such steps over a stacked
window of batches, in order, with their metrics stacked on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from raft_tpu_torch.device import cudnn_benchmark, fp32_precision
from raft_tpu_torch.models.corr import CorrBlock
from raft_tpu_torch.train.loss import flow_metrics, sequence_loss
from raft_tpu_torch.train.optim import Optimizer, global_norm
from raft_tpu_torch.train.state import TrainState
from raft_tpu_torch.utils.debug import nonfinite_count, nonfinite_leaf_counts

__all__ = [
    "make_train_step_fn",
    "make_train_step",
    "make_window_step_fn",
    "make_window_step",
    "make_eval_step",
    "check_trainable",
]

Batch = Dict[str, torch.Tensor]


def check_trainable(model) -> None:
    """Raise unless the model's correlation block can be differentiated:
    the ``dense`` block, and the ``fused`` one on fp32 or bf16 levels."""
    from raft_tpu_torch.kernels.lookup_xtap import FusedLookupCorrBlock

    block = model.corr_block
    if isinstance(block, FusedLookupCorrBlock) and block.quantize:
        raise ValueError("corr_dtype='int8' is inference-only (the quantized lookup defines no gradient); "
                         "train with corr_dtype 'float32' or 'bfloat16'")
    if type(block) not in (CorrBlock, FusedLookupCorrBlock):
        raise NotImplementedError(
            f"training through {type(block).__name__} (corr_impl='pallas') is not supported: K3, its pyramid "
            "kernel, defines no gradient, in the JAX package as here (there its block trains only at widths "
            "where it falls back to XLA, w/8 % 128 != 0); train with corr_impl='dense' or 'fused'"
        )


def make_train_step_fn(
    model,
    tx: Optimizer,
    *,
    num_flow_updates: int = 12,
    gamma: float = 0.8,
    max_flow: float = 400.0,
    check_numerics: bool = False,
    numerics_policy: str = "raise",
    spike_factor: float = 0.0,
    ema_decay: float = 0.99,
    spike_warmup: int = 20,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step ``(state, batch) -> (state, metrics)`` for ``model``
    (the one ``state.model`` holds).

    The step runs in ``device.cudnn_benchmark()``: cuDNN times its
    algorithms at each convolution shape the first time it meets it, and
    PyTorch keeps that choice for the process. Its heuristic otherwise
    sends raft_large's fp32 update-block convs to an FFT-tiling algorithm
    of ~8300 launches a call (``tools/train_profile.py --heuristic``).

    ``check_numerics`` adds ``nonfinite_grads`` (one int32 count) and
    ``_nonfinite_leaves`` (per-parameter counts, in ``named_parameters``
    order); ``numerics_policy='skip'`` adds the guard's ``skipped`` and
    ``grad_ema`` and, as the guard reads it, ``nonfinite_grads``.
    """
    if numerics_policy not in ("raise", "skip"):
        raise ValueError(f"numerics_policy must be 'raise' or 'skip', got {numerics_policy!r}")
    check_trainable(model)
    params = list(model.parameters())
    buffers = [b for b in model.buffers()]
    skip = numerics_policy == "skip"

    def step(state: TrainState, batch: Batch):
        with cudnn_benchmark(), fp32_precision():
            model.train()
            old_buffers = [b.clone() for b in buffers] if skip else None
            flow_preds = model(batch["image1"], batch["image2"], num_flow_updates=num_flow_updates, emit_all=True)
            loss, metrics = sequence_loss(flow_preds, batch["flow"], batch.get("valid"), gamma=gamma,
                                          max_flow=max_flow)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            del flow_preds
            with torch.no_grad():
                new_params, new_opt = tx.update(grads, state.opt_state, params)
                grad_norm = global_norm(grads)
                metrics = {k: v.detach() for k, v in metrics.items()}
                metrics["grad_norm"] = grad_norm
                skipped_steps, good_steps, grad_ema = state.skipped_steps, state.good_steps, state.grad_ema
                if check_numerics or skip:
                    metrics["nonfinite_grads"] = nonfinite_count(grads)
                if check_numerics:
                    metrics["_nonfinite_leaves"] = nonfinite_leaf_counts(grads)
                if skip:
                    apply = (metrics["nonfinite_grads"] == 0) & torch.isfinite(loss) & torch.isfinite(grad_norm)
                    if spike_factor > 0:
                        # the EMA is trusted only after a few applied updates
                        apply = apply & ~((good_steps >= spike_warmup) & (grad_norm > spike_factor * grad_ema))
                    # apply or skip the WHOLE update: a skipped step keeps
                    # params, the optimizer state and the BN buffers bitwise
                    sel = lambda new, old: torch.where(apply, new, old)  # noqa: E731
                    new_params = [sel(n, o) for n, o in zip(new_params, params)]
                    new_opt = {
                        "count": sel(new_opt["count"], state.opt_state["count"]),
                        "mu": [sel(n, o) for n, o in zip(new_opt["mu"], state.opt_state["mu"])],
                        "nu": [sel(n, o) for n, o in zip(new_opt["nu"], state.opt_state["nu"])],
                    }
                    for b, old in zip(buffers, old_buffers):
                        b.copy_(sel(b, old))
                    applied = apply.to(torch.int32)
                    skipped_steps = skipped_steps + (1 - applied)
                    good_steps = good_steps + applied
                    # the EMA sees applied grad norms only; its first sample
                    # seeds it
                    gn = torch.where(torch.isfinite(grad_norm), grad_norm, torch.zeros_like(grad_norm))
                    grad_ema = torch.where(
                        apply,
                        torch.where(good_steps <= 1, gn, ema_decay * grad_ema + (1.0 - ema_decay) * gn),
                        grad_ema,
                    )
                    metrics["skipped"] = 1.0 - apply.to(torch.float32)
                    metrics["grad_ema"] = grad_ema
                torch._foreach_copy_(params, new_params)
        state.opt_state = new_opt
        state.step = state.step + 1
        state.skipped_steps, state.good_steps, state.grad_ema = skipped_steps, good_steps, grad_ema
        return state, metrics

    return step


def make_train_step(model, tx: Optimizer, **kw):
    """The train step (:func:`make_train_step_fn`): the JAX package jits its
    step here; the port runs it eagerly (capturing it as a CUDA graph is
    ROADMAP work)."""
    return make_train_step_fn(model, tx, **kw)


def make_window_step_fn(model, tx: Optimizer, *, window_size: int, **kw):
    """The ``window_size``-step body ``(state, window) -> (state,
    metrics)`` (the JAX ``make_window_step_fn``, ``lax.scan`` there): the
    per-step body of :func:`make_train_step_fn` (``**kw`` are its
    arguments) run on ``window[key][i]`` for ``i`` in order, so the skip
    guard's counters, its EMA and a skipped step's metrics are the
    per-step loop's by construction. Every leaf of the window has a
    leading ``(window_size,)`` axis: images ``(k, B, 3, H, W)``, flow
    ``(k, B, 2, H, W)``, valid ``(k, B, H, W)``. The metrics come out
    stacked, ``(k, ...)`` per key, on the device: nothing syncs the host
    inside the window."""
    if window_size < 1:
        raise ValueError(f"window_size must be >= 1, got {window_size}")
    step_fn = make_train_step_fn(model, tx, **kw)

    def window_step(state: TrainState, window: Batch):
        for key, value in window.items():
            if value.shape[0] != window_size:
                raise ValueError(f"window[{key!r}] has {value.shape[0]} steps, window_size is {window_size}")
        per_step = []
        for i in range(window_size):
            state, metrics = step_fn(state, {key: value[i] for key, value in window.items()})
            per_step.append(metrics)
        return state, {key: torch.stack([m[key] for m in per_step]) for key in per_step[0]}

    return window_step


def make_window_step(model, tx: Optimizer, *, window_size: int, **kw):
    """The window step (:func:`make_window_step_fn`), eager, as
    :func:`make_train_step` is."""
    return make_window_step_fn(model, tx, window_size=window_size, **kw)


def make_eval_step(model, *, num_flow_updates: int = 32):
    """Eval step ``batch -> (flow, metrics)``: the final flow only
    (``emit_all=False``) and its EPE metrics, in eval mode, without
    gradients."""

    def step(batch: Batch):
        model.eval()
        with torch.inference_mode():
            flow = model(batch["image1"], batch["image2"], num_flow_updates=num_flow_updates, emit_all=False)
            return flow, flow_metrics(flow, batch["flow"], batch.get("valid"))

    return step
