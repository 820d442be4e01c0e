"""The training driver: config, loop, checkpoints, logging, in-loop eval.

Ported from the JAX package's ``raft_tpu/train/trainer.py``: input
pipeline -> train step -> metric logging at log boundaries -> checkpoint
and resume. The stage presets encode the RAFT C -> T -> S/K/H curriculum;
each stage is one ``TrainConfig``, with every field and default of the
JAX one (``device`` is the port's own).

Ported: the loop, per step or, with ``window_size=k > 1``, per stacked
window of ``k`` steps (``train.step.make_window_step``; log, checkpoint and
eval intervals and ``num_steps`` must be multiples of ``k``, and a run
resumes only at a window start); log boundaries with one metrics fetch each
(the step itself makes no host sync); checkpoints every
``checkpoint_every`` steps and resume from the latest; ``numerics_policy``
``'raise'`` and ``'skip'`` with the rollback ladder; in-loop eval through
the port's ``validate`` with the best-EPE export (``best.pt``, a torch
state_dict that ``checkpoint=`` reads); SIGTERM/SIGINT preemption saved at
the next window boundary, in one process; ``corr_impl`` ``'dense'`` and
``'fused'`` with ``remat_policy``; the device-time ledger of the window
step (``ledger_sample_every``, family ``train_window_step/<k>``).

Observability, as in the JAX trainer: a metrics registry with the phase
histograms (``data_wait``, ``dispatch``, ``metric_fetch``, ``checkpoint``,
``eval``, in ms), a flight recorder (``trainer.recorder``) that the
stability ladder and the stall watchdog dump through, and one
``train_window`` trace per dispatch window (``trainer.tracer``, every
window sampled, the last 64 kept). ``watchdog_timeout`` arms a
:class:`~raft_tpu_torch.utils.faults.Watchdog` around the blocking
host-side regions (``data/next``, ``train/step``, ``train/device_sync``
at the boundary's metrics fetch, where a step queued on the card is
actually waited for, ``checkpoint/save``, ``checkpoint/preempt``,
``rollback``, ``eval``); a stall raises ``StallError`` and writes every
thread's stack to ``<log_dir>/stall_stacks.log``.

``profile_port`` is refused on purpose: ``jax.profiler.start_server``
serves a live profile to a remote TensorBoard and PyTorch has no such
server (a profile is taken in-process with ``torch.profiler``; the
``train/window_dispatch`` range of :mod:`raft_tpu_torch.obs.profile`
marks the dispatches in it). ``corr_impl='pallas'`` does not train (K3
defines no gradient).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import signal
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.checkpoint.manager import CheckpointManager
from raft_tpu_torch.data.augment import AugmentConfig, FlowAugmentor
from raft_tpu_torch.data.datasets import ConcatDataset, RepeatDataset, Sintel
from raft_tpu_torch.data.pipeline import TrainPipeline
from raft_tpu_torch.device import resolve_device
from raft_tpu_torch.eval.validate import validate
from raft_tpu_torch.models.zoo import CONFIGS, build_raft
from raft_tpu_torch.obs import DeviceTimeLedger, FlightRecorder, MetricsRegistry, Tracer, logger_sink, profile
from raft_tpu_torch.train.optim import make_optimizer, one_cycle_lr
from raft_tpu_torch.train.stability import StabilityMonitor, StabilityPolicy
from raft_tpu_torch.train.state import TrainState
from raft_tpu_torch.train.step import make_train_step, make_window_step
from raft_tpu_torch.utils.debug import NumericsError, format_report, nonfinite_report
from raft_tpu_torch.utils.faults import DataFaultPolicy, Watchdog
from raft_tpu_torch.utils.logging import MetricLogger

__all__ = ["TrainConfig", "STAGES", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    arch: str = "raft_large"
    stage: str = "chairs"
    num_steps: int = 100_000
    global_batch_size: int = 8
    learning_rate: float = 4e-4
    weight_decay: float = 1e-4
    clip_norm: float = 1.0
    num_flow_updates: int = 12
    gamma: float = 0.8
    max_flow: float = 400.0
    crop_size: Tuple[int, int] = (368, 496)
    seed: int = 0
    # infra
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 5_000
    log_every: int = 100
    log_dir: Optional[str] = None  # durable scalars (JSONL)
    # jax.profiler.start_server's port in the JAX package; refused here
    # (no PyTorch counterpart: profile in-process with torch.profiler)
    profile_port: Optional[int] = None
    remat: bool = False
    # selective-remat policy under remat=True ('dots', 'dots_no_batch',
    # 'corr': models.raft.REMAT_POLICIES)
    remat_policy: Optional[str] = None
    # 'dense' or 'fused' (K1's forward, the dense formulation's backward);
    # 'pallas' raises (K3 defines no gradient)
    corr_impl: str = "dense"
    # storage dtype for the correlation pyramid (None | 'bfloat16');
    # 'int8' is inference-only
    corr_dtype: Optional[str] = None
    # conv/activation compute dtype (None=fp32 | 'bfloat16'); params, norm
    # statistics, flow arithmetic and the loss stay fp32
    compute_dtype: Optional[str] = None
    # the JAX package's data-axis mesh; the port trains on one device, so
    # this changes nothing (multi-device training is ROADMAP work)
    data_mesh: bool = True
    # steps a dispatch: window_size=k > 1 runs k train steps over a
    # stacked batch window (train.step.make_window_step), metrics stacked
    # on the device until the log boundary's one fetch; log_every,
    # checkpoint_every, eval_every and num_steps must be multiples of k
    window_size: int = 1
    # In-loop validation: every `eval_every` steps (0 = never) the port's
    # validate() runs on the eval dataset, eval/* scalars are logged and
    # the best-EPE weights exported to `<checkpoint_dir>/best.pt`.
    eval_every: int = 0
    eval_num_flow_updates: int = 32
    # Padding/metric protocol for in-loop eval ('sintel' = split vertical
    # pad + unmasked EPE, 'downstream' = bottom-only pad + masked EPE).
    # None infers it from the dataset: all-Sintel -> 'sintel', else
    # 'downstream'.
    eval_mode: Optional[str] = None
    # NaN/inf watchdog: adds an on-device nonfinite-grad counter to every
    # step and raises NumericsError (with a per-leaf report) at the log
    # boundary it trips.
    check_numerics: bool = False
    # --- fault tolerance ---
    # Data-pipeline fault policy: 'skip' quarantines samples that fail to
    # load (transient OSErrors retried with backoff first; bounded by
    # data_bad_sample_budget distinct bad samples) and refills the batch;
    # 'raise' propagates after the transient retries (fail-fast).
    # data/skipped + data/retries counters surface at the log boundary.
    data_fault_policy: str = "skip"
    data_bad_sample_budget: int = 64
    data_max_retries: int = 2
    # In-loop eval failures (OOM, one bad val sample): 'skip' logs an
    # eval/failed scalar and keeps training; 'raise' kills the run.
    eval_fault_policy: str = "skip"
    # stall watchdog (utils.faults.Watchdog): seconds a guarded host-side
    # region (data fetch, dispatch, boundary metrics fetch, checkpoint,
    # rollback, eval) may block before StallError; None disables
    watchdog_timeout: Optional[float] = None
    # --- divergence resilience (the model-fault ladder)
    # 'raise': the pre-existing fail-fast behavior (check_numerics raises
    # NumericsError at the log boundary). 'skip': the in-step guard
    # (train/step.py) applies-or-skips the whole update on device: a
    # non-finite gradient burst or a grad-norm spike costs one step, not
    # the run; skips surface as the train/skipped counter at boundaries.
    numerics_policy: str = "raise"
    # Skip updates whose gradient global-norm exceeds spike_factor x the
    # EMA of applied-step grad norms (0 disables; only under 'skip'). The
    # EMA needs spike_warmup applied updates before the detector arms.
    spike_factor: float = 20.0
    spike_warmup: int = 20
    # More than skip_budget skipped steps inside one log window = the run
    # is persistently diverging: roll back to the last known-good
    # checkpoint, perturb the data-order seed, and optionally scale the LR
    # by rollback_lr_scale. After max_rollbacks breaches, raise
    # DivergenceError with the full attempt trail.
    skip_budget: int = 5
    max_rollbacks: int = 3
    rollback_lr_scale: float = 1.0
    # Eval-EPE regression tolerated before a checkpoint stops being tagged
    # known-good (fraction of the best EPE so far; only with eval_every).
    good_epe_slack: float = 0.2
    # device-time ledger (obs.ledger): every Kth window dispatch is timed
    # between CUDA events (family 'train_window_step/<k>'), a deliberate
    # host sync; 0 (the default) keeps the loop sync-free
    ledger_sample_every: int = 0
    # where to train (the port's own field): the card unless 'cpu'
    device: Optional[str] = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# Stage presets: (crop, lr, steps, batch, iters, sparse GT, scale range)
# following the RAFT schedule.
STAGES: Dict[str, Dict] = {
    "chairs": dict(
        crop_size=(368, 496), learning_rate=4e-4, num_steps=100_000,
        global_batch_size=8, num_flow_updates=12, sparse=False,
        min_scale=-0.1, max_scale=1.0,
    ),
    "things": dict(
        crop_size=(400, 720), learning_rate=1.25e-4, num_steps=100_000,
        global_batch_size=6, num_flow_updates=12, sparse=False,
        min_scale=-0.4, max_scale=0.8,
    ),
    "sintel": dict(
        crop_size=(368, 768), learning_rate=1.25e-4, num_steps=100_000,
        global_batch_size=6, num_flow_updates=12, sparse=False,
        min_scale=-0.2, max_scale=0.6,
    ),
    "kitti": dict(
        crop_size=(288, 960), learning_rate=1e-4, num_steps=50_000,
        global_batch_size=6, num_flow_updates=12, sparse=True,
        min_scale=-0.2, max_scale=0.4,
    ),
}


class Trainer:
    """Owns the model, the state and the pipeline; :meth:`run` trains.

    One process, one device (``config.device``). ``init_from`` is a
    state_dict to start from (``models.zoo.load_checkpoint`` reads either
    weight format). ``eval_fn(model) -> metrics`` replaces the default
    in-loop eval, which runs the port's ``validate`` on ``eval_dataset``.
    """

    @staticmethod
    def model_config(config: TrainConfig):
        """The TrainConfig's model knobs as a RAFTConfig. ``compute_dtype``
        changes only conv/activation compute: without an explicit
        ``corr_dtype`` the pyramid storage is pinned to fp32 here."""
        model_cfg = CONFIGS[config.arch].replace(
            remat=config.remat, remat_policy=config.remat_policy,
            corr_impl=config.corr_impl, corr_dtype=config.corr_dtype,
        )
        if config.compute_dtype is not None:
            model_cfg = model_cfg.replace(compute_dtype=config.compute_dtype)
            if config.corr_dtype is None:
                model_cfg = model_cfg.replace(corr_dtype="float32")
        return model_cfg

    @staticmethod
    def _check_ported(config: TrainConfig) -> None:
        """Raise for ``corr_impl='pallas'`` and for ``profile_port`` (a
        deliberate difference from the JAX trainer); neither falls back."""
        if config.corr_impl == "pallas":
            raise NotImplementedError(
                "training at corr_impl='pallas' is not supported: K3, its pyramid kernel, defines no gradient "
                "(train.step.check_trainable); train with corr_impl='dense' or 'fused'"
            )
        if config.profile_port is not None:
            raise NotImplementedError(
                "profile_port has no counterpart in raft_tpu_torch: jax.profiler.start_server serves a live profile "
                "to a remote TensorBoard and PyTorch has no profiler server; take the profile in-process with "
                "torch.profiler (the dispatches carry raft_tpu_torch.obs.profile's train/window_dispatch range)"
            )

    def __init__(self, config: TrainConfig, dataset, *, init_from=None, eval_dataset=None, eval_fn=None):
        if config.corr_dtype == "int8":
            raise ValueError("corr_dtype='int8' is inference-only; train with 'bfloat16'")
        if config.compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be None, 'float32' or 'bfloat16', got {config.compute_dtype!r}"
            )
        for name in ("data_fault_policy", "eval_fault_policy"):
            if getattr(config, name) not in ("skip", "raise"):
                raise ValueError(f"{name} must be 'skip' or 'raise', got {getattr(config, name)!r}")
        if config.numerics_policy not in ("raise", "skip"):
            raise ValueError(f"numerics_policy must be 'raise' or 'skip', got {config.numerics_policy!r}")
        if config.window_size < 1:
            raise ValueError(f"window_size must be >= 1, got {config.window_size}")
        if config.ledger_sample_every < 0:
            raise ValueError(f"ledger_sample_every must be >= 0 (0 = off), got {config.ledger_sample_every}")
        if config.window_size > 1:
            # boundaries (log, checkpoint, eval, preemption) fall only on
            # window starts: a misaligned interval would shift them all
            k = config.window_size
            for name, every in (("log_every", config.log_every),
                                ("checkpoint_every", config.checkpoint_every if config.checkpoint_dir else 0),
                                ("eval_every", config.eval_every), ("num_steps", config.num_steps)):
                if every and every % k:
                    raise ValueError(f"{name}={every} is not a multiple of window_size={k}; boundaries are "
                                     "window-aligned")
        self._check_ported(config)
        self.config = config
        self.device = resolve_device(config.device)
        self.model = build_raft(self.model_config(config), device=self.device)
        if init_from is not None:
            self.model.load_state_dict(init_from, strict=True)
        self.lr_schedule = one_cycle_lr(config.learning_rate, config.num_steps)
        self.tx = make_optimizer(self.lr_schedule, weight_decay=config.weight_decay, clip_norm=config.clip_norm)

        stability_policy = StabilityPolicy(
            skip_budget=config.skip_budget, max_rollbacks=config.max_rollbacks,
            rollback_lr_scale=config.rollback_lr_scale,
        )
        # the observability spine: per-window traces (data wait, dispatch,
        # metric fetch, checkpoint and eval spans), phase histograms, and
        # a flight recorder that the stability ladder and the stall
        # watchdog dump through
        self.metrics = MetricsRegistry("train")
        self.recorder = FlightRecorder(proc="trainer")
        self.tracer = Tracer(1.0, capacity=64, prefix="trn", on_finish=self.recorder.add_trace)
        self._phase_hist = {
            name: self.metrics.histogram(f"{name}_ms")
            for name in ("data_wait", "dispatch", "metric_fetch", "checkpoint", "eval")
        }
        self._obs_counters = self.metrics.counter_group("counters", ("windows", "boundaries", "checkpoints", "evals"))
        self.watchdog: Optional[Watchdog] = None
        self.stability = (
            StabilityMonitor(stability_policy, base_seed=config.seed, recorder=self.recorder)
            if config.numerics_policy == "skip" else None
        )
        self._lr_scale = 1.0
        self._eval_ok = True
        self._pending_good: list = []
        self._preempted = False

        self.state = TrainState.create(self.model, self.tx)
        self._make_step_fns()
        # the device-time ledger: the trainer's one device family is the
        # window step, every Kth dispatch timed
        self.ledger = DeviceTimeLedger(config.ledger_sample_every, device=self.device, registry=self.metrics)

        self.manager = None
        self._resumed = False
        if config.checkpoint_dir:
            self.manager = CheckpointManager(
                os.path.abspath(config.checkpoint_dir), max_to_keep=3,
                save_interval_steps=config.checkpoint_every,
            )
            self._resumed = self.manager.restore(self.state) is not None
            if self._resumed:
                print(f"resumed from step {int(self.state.step)}")

        self.eval_fn = eval_fn
        self.eval_model = self.model
        if self.eval_fn is None and eval_dataset is not None:
            self.eval_fn = self._default_eval(eval_dataset)
        if config.eval_every and self.eval_fn is None:
            raise ValueError("eval_every is set but neither eval_dataset nor eval_fn was passed to Trainer")
        self.best_epe = float("inf")
        if config.checkpoint_dir and self._resumed:
            # a resumed run must not let a worse eval overwrite the best
            # export (a stale best.json of a fresh run is ignored)
            best_json = os.path.join(os.path.abspath(config.checkpoint_dir), "best.json")
            if os.path.exists(best_json):
                try:
                    with open(best_json) as f:
                        self.best_epe = float(json.load(f)["epe"])
                except (ValueError, KeyError, TypeError, OSError):
                    pass

        stage = STAGES.get(config.stage, {})
        self._augmentor = FlowAugmentor(AugmentConfig(
            crop_size=config.crop_size, sparse=stage.get("sparse", False),
            min_scale=stage.get("min_scale", -0.2), max_scale=stage.get("max_scale", 0.5),
        ))
        self._dataset = dataset
        self.pipeline = self._build_pipeline(seed=config.seed, start_step=int(self.state.step))

    def _default_eval(self, eval_dataset):
        """``validate`` on ``eval_dataset`` through an all-fp32 twin of the
        model when training runs reduced precision (the parameters are the
        same tensors' values, so the twin loads them each eval)."""
        config = self.config
        if config.compute_dtype not in (None, "float32") or config.corr_dtype not in (None, "float32"):
            self.eval_model = build_raft(
                self.model_config(config).replace(compute_dtype="float32", corr_dtype="float32", remat=False,
                                                remat_policy=None),
                device=self.device,
            )
        eval_mode = config.eval_mode
        if eval_mode is None:
            def _all_sintel(ds) -> bool:
                if isinstance(ds, Sintel):
                    return True
                if isinstance(ds, ConcatDataset):
                    return bool(ds.parts) and all(_all_sintel(p) for p in ds.parts)
                if isinstance(ds, RepeatDataset):
                    return _all_sintel(ds.base)
                return False

            eval_mode = "sintel" if _all_sintel(eval_dataset) else "downstream"
        elif eval_mode not in ("sintel", "downstream"):
            raise ValueError(f"eval_mode must be None, 'sintel' or 'downstream', got {config.eval_mode!r}")

        def default_eval(model):
            if self.eval_model is not model:
                self.eval_model.load_state_dict(model.state_dict())
            return validate(self.eval_model, eval_dataset, num_flow_updates=config.eval_num_flow_updates,
                            mode=eval_mode, fps_pairs=0)

        return default_eval

    def _step_kw(self):
        config = self.config
        return dict(
            num_flow_updates=config.num_flow_updates, gamma=config.gamma, max_flow=config.max_flow,
            check_numerics=config.check_numerics, numerics_policy=config.numerics_policy,
            spike_factor=config.spike_factor, spike_warmup=config.spike_warmup,
        )

    def _make_step_fns(self) -> None:
        """The per-step function and, at ``window_size > 1``, the window
        step, both over ``self.tx``."""
        self.step_fn = make_train_step(self.model, self.tx, **self._step_kw())
        self.window_fn = (make_window_step(self.model, self.tx, window_size=self.config.window_size,
                                           **self._step_kw()) if self.config.window_size > 1 else None)

    def _build_pipeline(self, *, seed: int, start_step: int) -> TrainPipeline:
        """The pipeline's state is ``(seed, step)``: a rollback rebuilds it
        with a perturbed seed at the restored step."""
        config = self.config
        return TrainPipeline(
            self._dataset, config.global_batch_size, augmentor=self._augmentor, seed=seed, device=self.device,
            start_step=start_step,
            fault_policy=DataFaultPolicy(
                mode=config.data_fault_policy, max_bad_samples=config.data_bad_sample_budget,
                max_retries=config.data_max_retries,
            ),
            window_size=config.window_size,
        )

    @staticmethod
    def _host_window(window) -> list:
        """A list of ``(n_steps, metrics)`` dispatches, per-step metrics
        (``n=1``) or a window step's stacked ``(n, ...)`` ones, -> one host
        dict per step, in step order, in ONE device-to-host copy.
        ``"_"``-prefixed metrics (per-leaf counts) stay arrays; the rest
        become floats."""
        if not window:
            return []
        keys = list(window[0][1])
        flat = torch.cat([m[k].reshape(-1).to(torch.float64) for _, m in window for k in keys]).cpu().numpy()
        out, pos = [], 0
        for n, m in window:
            cols = {}
            for k in keys:
                size = m[k].numel()
                cols[k] = flat[pos:pos + size].reshape(n, -1)
                pos += size
            out.extend({k: cols[k][i].copy() if k.startswith("_") else float(cols[k][i, 0]) for k in keys}
                       for i in range(n))
        return out

    def _check_window(self, step: int, window) -> None:
        """Raise NumericsError if a step of the window saw nonfinite
        gradients or a nonfinite loss (``check_numerics``), naming the
        step and the first offending gradient tensors."""
        names = [n for n, _ in self.model.named_parameters()]
        for i, m in enumerate(window):
            if m.get("nonfinite_grads", 0.0) > 0 or not math.isfinite(m.get("loss", 0.0)):
                first_bad = step - len(window) + i + 1
                counts = m.get("_nonfinite_leaves")
                grad_leaves = "(no per-leaf data)"
                if counts is not None:
                    offenders = [f"{n}: {int(c)} nonfinite" for n, c in zip(names, counts.tolist()) if c]
                    grad_leaves = ("; ".join(offenders[:5]) + (
                        f"; ... {len(offenders) - 5} more leaves" if len(offenders) > 5 else "")
                    ) or "(all gradient leaves finite)"
                report = nonfinite_report(dict(self.model.named_parameters()))
                raise NumericsError(
                    f"nonfinite numerics at step {first_bad} (loss={m.get('loss')}, "
                    f"nonfinite_grads={m.get('nonfinite_grads')}); offending gradient leaves: {grad_leaves}; "
                    f"param tree after the poisoned update:\n{format_report(report)}\n"
                    "To localize the producing op, re-run the failing batch under "
                    "torch.autograd.detect_anomaly(). To skip bad steps instead of dying, set "
                    "numerics_policy='skip'.",
                    report,
                )

    def _rollback(self, at_step: int, window_skips: int, guard, log_fn, logger) -> None:
        """Persistent-divergence recovery: restore the last known-good
        checkpoint, perturb the data-order seed, scale the LR when
        ``rollback_lr_scale < 1``; DivergenceError when the budget is
        spent or nothing can be restored. The restore runs in a
        ``rollback`` watchdog section: a wedged restore dumps stacks and
        raises ``StallError``."""
        mon = self.stability
        mon.check_escalation(at_step, window_skips)
        if self.manager is None:
            mon.fail(at_step, window_skips, "no checkpoint_dir configured: nothing to roll back to")
        new_seed = mon.next_seed()
        lr_scale = mon.next_lr_scale()
        with guard("rollback", scale=5.0):
            if self.manager.restore_known_good(self.state, before=at_step) is None:
                mon.fail(at_step, window_skips, "no retained checkpoint to roll back to")
            # the trajectory past the restore point is abandoned
            to_step = int(self.state.step)
            for s in sorted(self.manager.all_steps(), reverse=True):
                if s > to_step:
                    self.manager.delete(s)
            if self.config.rollback_lr_scale != 1.0:
                self._lr_scale = lr_scale
                base = self.lr_schedule
                self.tx = make_optimizer(lambda count, s=lr_scale: base(count) * s,
                                         weight_decay=self.config.weight_decay, clip_norm=self.config.clip_norm)
                self._make_step_fns()
            self.pipeline = self._build_pipeline(seed=new_seed, start_step=to_step)
        attempt = mon.record_rollback(at_step, to_step, window_skips, seed=new_seed, lr_scale=lr_scale)
        self._pending_good = []
        self._eval_ok = True
        print(f"stability: rollback {len(mon.rollbacks)}/{mon.policy.max_rollbacks}: {attempt.describe()}")
        scalars = {"stability/rollback_to": float(attempt.to_step)}
        log_fn(at_step, scalars)
        if logger is not None:
            logger.log(at_step, scalars)

    def _run_eval(self, step: int, log_fn, logger) -> None:
        """In-loop validation; a failure logs ``eval/failed`` and training
        goes on unless ``eval_fault_policy='raise'``. The model is put
        back in train mode after it (``validate`` leaves it in eval mode,
        in which BatchNorm would normalize by its running statistics)."""
        try:
            self._eval_and_export(step, log_fn, logger)
        except Exception as e:
            if self.config.eval_fault_policy == "raise":
                raise
            print(f"eval at step {step} failed ({type(e).__name__}: {e}); continuing (eval_fault_policy='skip')")
            failed = {"eval/failed": 1.0}
            log_fn(step, failed)
            if logger is not None:
                logger.log(step, failed)
        finally:
            self.model.train()

    def _eval_and_export(self, step: int, log_fn, logger) -> None:
        metrics = self.eval_fn(self.model)
        scalars = {f"eval/{k}": float(v) for k, v in metrics.items() if np.isfinite(float(v))}
        log_fn(step, scalars)
        if logger is not None:
            logger.log(step, scalars)
        epe = metrics.get("epe")
        if epe is None or not np.isfinite(float(epe)):
            self._eval_ok = epe is None  # a nonfinite EPE has regressed
            return
        # a checkpoint is a rollback target only while the latest eval EPE
        # stays within good_epe_slack of the best
        self._eval_ok = (self.best_epe == float("inf")
                         or float(epe) <= self.best_epe * (1.0 + self.config.good_epe_slack))
        if float(epe) < self.best_epe:
            self.best_epe = float(epe)
            if self.config.checkpoint_dir:
                d = os.path.abspath(self.config.checkpoint_dir)
                os.makedirs(d, exist_ok=True)
                # weights before metadata, each by atomic replace: a kill
                # mid-write never leaves a torn best.pt behind a whole
                # best.json
                tmp = os.path.join(d, ".best.pt.tmp")
                torch.save({k: v.detach().cpu() for k, v in self.model.state_dict().items()}, tmp)
                os.replace(tmp, os.path.join(d, "best.pt"))
                tmp_j = os.path.join(d, ".best.json.tmp")
                with open(tmp_j, "w") as f:
                    json.dump({"step": step, "epe": self.best_epe}, f)
                os.replace(tmp_j, os.path.join(d, "best.json"))

    def _next_batch(self, data_iter, step: int):
        """The next batch (or window) from the pipeline for ``step``; a
        seam (``FaultInjector.patch_batches`` fires its ``data.next``
        site here, inside the ``data/next`` watchdog section)."""
        return next(data_iter)

    def _install_preemption_handler(self):
        """SIGTERM/SIGINT set a flag; the loop checkpoints and returns at
        the next step boundary. Returns the function that puts the old
        handlers back."""
        self._preempted = False
        saved = {}

        def _handler(signum, _frame):
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                saved[sig] = signal.signal(sig, _handler)
            except ValueError:  # not the main thread: the flag still works
                pass

        def restore():
            for sig, old in saved.items():
                signal.signal(sig, old)

        return restore

    def run(self, log_fn=None) -> TrainState:
        cfg = self.config
        log_fn = log_fn or (lambda step, m: print(
            f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items())))
        start = int(self.state.step)
        # with window_size=k > 1 every iteration below advances k steps
        # through one window dispatch, the per-step loop with a stride;
        # boundaries are window-aligned (checked at construction), and a
        # run resumes, or rolls back, only to a window start
        wsize = cfg.window_size
        if wsize > 1 and start % wsize:
            raise ValueError(
                f"resumed at step {start}, which is not a multiple of window_size={wsize} (a checkpoint from a "
                f"differently windowed run?); resume with window_size=1 or a divisor of {start} to realign"
            )
        logger = None
        if cfg.log_dir:
            logger = MetricLogger(cfg.log_dir)
            # postmortem bundles (watchdog trip, divergence death) persist
            # through the logger's structured events file
            self.recorder.add_sink(logger_sink(logger))
        self.model.train()
        t0 = time.perf_counter()
        window: list = []
        data_iter = iter(self.pipeline)
        restore_handlers = self._install_preemption_handler() if self.manager is not None else (lambda: None)
        # stall watchdog: armed around every blocking host-side region
        # below, two attribute writes a region, no device sync
        self.watchdog = None
        if cfg.watchdog_timeout:
            dump = os.path.join(cfg.log_dir, "stall_stacks.log") if cfg.log_dir else None
            self.watchdog = Watchdog(cfg.watchdog_timeout, dump_path=dump, recorder=self.recorder)

        def guard(name, scale=1.0):
            if self.watchdog is None:
                return contextlib.nullcontext()
            return self.watchdog.section(name, scale=scale)

        try:
            step = start
            stretch_next = True  # the first dispatch warms up (cuDNN trials); also post-rollback
            while step < cfg.num_steps:
                if self.manager is not None and self._preempted:
                    with guard("checkpoint/preempt"):
                        if self.manager.latest_step() != step:
                            self.manager.save(step, self.state, force=True)
                    print(f"preempted: checkpointed step {step}, exiting")
                    return self.state
                # the first dispatch runs cuDNN's trials and the first fetch
                # warms the prefetch pipeline: legitimately slow ONCE, so the
                # deadline is stretched there instead of loosening the steady
                # state; steady-state deadlines scale with the window
                scale = (20.0 if stretch_next else 1.0) * wsize
                stretch_next = False
                # one trace a dispatch window, spans over the host's phases
                wtrace = self.tracer.start("train_window", rid=step)
                t_a = time.monotonic()
                with guard("data/next", scale=scale):
                    batch = self._next_batch(data_iter, step)
                t_b = time.monotonic()
                with guard("train/step", scale=scale), profile.annotate("train/window_dispatch"):
                    fn = self.window_fn or self.step_fn
                    self.state, metrics = self.ledger.run(("train_window_step", wsize),
                                                          lambda: fn(self.state, batch))
                t_c = time.monotonic()
                if wtrace is not None:
                    wtrace.add_span("data_wait", t_a, t_b)
                    wtrace.add_span("dispatch", t_b, t_c, steps=wsize)
                self._phase_hist["data_wait"].observe((t_b - t_a) * 1e3)
                self._phase_hist["dispatch"].observe((t_c - t_b) * 1e3)
                self._obs_counters["windows"] += 1
                window.append((wsize, metrics))
                end = step + wsize
                at_log = end % cfg.log_every == 0
                hwin = None
                if at_log or (cfg.check_numerics and self.manager is not None
                              and end % cfg.checkpoint_every == 0):
                    t_mf = time.monotonic()
                    # the boundary's one fetch: where the host actually waits
                    # for the steps queued on the card, so a device stall
                    # shows in this section
                    with guard("train/device_sync", scale=scale):
                        hwin = self._host_window(window)
                    if wtrace is not None:
                        wtrace.add_span("metric_fetch", t_mf)
                    self._phase_hist["metric_fetch"].observe((time.monotonic() - t_mf) * 1e3)
                    self._obs_counters["boundaries"] += 1
                    if cfg.check_numerics and cfg.numerics_policy == "raise":
                        # never persist a poisoned state as the latest
                        self._check_window(end, hwin)
                if self.manager is not None:
                    t_ck = time.monotonic()
                    with guard("checkpoint/save"):
                        if self.manager.save(end, self.state):
                            self._pending_good.append(end)
                            self._obs_counters["checkpoints"] += 1
                    if wtrace is not None:
                        wtrace.add_span("checkpoint", t_ck)
                    self._phase_hist["checkpoint"].observe((time.monotonic() - t_ck) * 1e3)
                if at_log:
                    # skipped steps carry their bad batch's NaN loss in
                    # their metrics (the state never saw it): keep them out
                    # of the means
                    applied = [m for m in hwin if not m.get("skipped", 0.0)] or hwin
                    mean = {k: float(np.mean([m[k] for m in applied])) for k in hwin[0] if not k.startswith("_")}
                    dt = time.perf_counter() - t0
                    mean["pairs_per_s"] = len(hwin) * cfg.global_batch_size / max(dt, 1e-9)
                    mean["lr"] = float(self.lr_schedule(step)) * self._lr_scale
                    if self.pipeline.fault_policy is not None:
                        mean.update({k: float(v) for k, v in self.pipeline.counters.items()})
                    window_skips = int(round(sum(m.get("skipped", 0.0) for m in hwin)))
                    breached = False
                    if self.stability is not None:
                        mean["train/skipped"] = float(window_skips)
                        mean["stability/rollbacks"] = float(len(self.stability.rollbacks))
                        breached = self.stability.breached(window_skips)
                    window_finite = all(math.isfinite(m.get("loss", 0.0)) for m in applied)
                    if self._pending_good:
                        # tagged known-good: the window around the save
                        # closed finite, within budget, with no regressed eval
                        if window_finite and not breached and self._eval_ok:
                            for s in self._pending_good:
                                self.manager.tag_good(s, {"loss": mean.get("loss")})
                        self._pending_good = []
                    log_fn(end, mean)
                    if logger is not None:
                        logger.log(end, mean)
                    window = []
                    t0 = time.perf_counter()
                    if breached:
                        self._rollback(end, window_skips, guard, log_fn, logger)
                        if wtrace is not None:
                            wtrace.finish(ok=True, step=end, rollback=True)
                        data_iter.close()
                        data_iter = iter(self.pipeline)
                        step = int(self.state.step)
                        stretch_next = True
                        t0 = time.perf_counter()
                        continue
                if cfg.eval_every and end % cfg.eval_every == 0:
                    t_eval = time.perf_counter()
                    t_ev = time.monotonic()
                    with guard("eval", scale=20.0):  # the whole held-out split
                        self._run_eval(end, log_fn, logger)
                    if wtrace is not None:
                        wtrace.add_span("eval", t_ev)
                    self._phase_hist["eval"].observe((time.monotonic() - t_ev) * 1e3)
                    self._obs_counters["evals"] += 1
                    t0 += time.perf_counter() - t_eval  # eval is not training time
                if wtrace is not None:
                    wtrace.finish(ok=True, step=end)
                step = end
        finally:
            restore_handlers()
            data_iter.close()
            if self.watchdog is not None:
                # closed but kept: stall_count / last_stall stay readable
                self.watchdog.close()
            if logger is not None:
                logger.close()
        if self.manager is not None:
            if cfg.check_numerics and cfg.numerics_policy == "raise" and window:
                self._check_window(cfg.num_steps, self._host_window(window))
            if self.manager.latest_step() != cfg.num_steps:
                self.manager.save(cfg.num_steps, self.state, force=True)
        return self.state
