"""Training: loss, optimizer, state, steps, stability, the Trainer."""

from raft_tpu_torch.train.loss import flow_metrics, sequence_loss
from raft_tpu_torch.train.optim import make_optimizer, one_cycle_lr
from raft_tpu_torch.train.stability import (
    DivergenceError,
    RollbackAttempt,
    StabilityMonitor,
    StabilityPolicy,
    perturb_seed,
)
from raft_tpu_torch.train.state import TrainState
from raft_tpu_torch.train.step import make_eval_step, make_train_step, make_train_step_fn
from raft_tpu_torch.train.trainer import STAGES, TrainConfig, Trainer

__all__ = [
    "flow_metrics",
    "sequence_loss",
    "make_optimizer",
    "one_cycle_lr",
    "TrainState",
    "make_eval_step",
    "make_train_step",
    "make_train_step_fn",
    "DivergenceError",
    "RollbackAttempt",
    "StabilityMonitor",
    "StabilityPolicy",
    "perturb_seed",
    "STAGES",
    "TrainConfig",
    "Trainer",
]
