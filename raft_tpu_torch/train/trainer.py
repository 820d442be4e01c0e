"""The training driver: config, loop, checkpoints, logging, in-loop eval.

Ported from the JAX package's ``raft_tpu/train/trainer.py``: input
pipeline -> train step -> metric logging at log boundaries -> checkpoint
and resume. The stage presets encode the RAFT C -> T -> S/K/H curriculum;
each stage is one ``TrainConfig``, with every field and default of the
JAX one (``device`` is the port's own).

Ported: the per-step loop; log boundaries with one metrics fetch each
(the step itself makes no host sync); checkpoints every
``checkpoint_every`` steps and resume from the latest; ``numerics_policy``
``'raise'`` and ``'skip'`` with the rollback ladder; in-loop eval through
the port's ``validate`` with the best-EPE export (``best.pt``, a torch
state_dict that ``checkpoint=`` reads); SIGTERM/SIGINT preemption saved at
the next step boundary, in one process.

Not ported yet, each raising ``NotImplementedError`` from
:meth:`Trainer._check_ported`: ``window_size > 1``, ``remat_policy``,
training at ``fused``/``pallas``, ``watchdog_timeout``, ``profile_port``
and ``ledger_sample_every > 0``. The JAX trainer's traces, metrics
registry and flight recorder have no knob and no port yet (ROADMAP queue 1
item 3f).
"""

from __future__ import annotations

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
from raft_tpu_torch.train.optim import make_optimizer, one_cycle_lr
from raft_tpu_torch.train.stability import StabilityMonitor, StabilityPolicy
from raft_tpu_torch.train.state import TrainState
from raft_tpu_torch.train.step import make_train_step
from raft_tpu_torch.utils.debug import NumericsError, format_report, nonfinite_report
from raft_tpu_torch.utils.faults import DataFaultPolicy
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
    profile_port: Optional[int] = None  # not ported: raises
    remat: bool = False
    # selective-remat policy under remat=True: not ported, raises
    remat_policy: Optional[str] = None
    # 'dense' only: 'fused' and 'pallas' raise (their kernels have no
    # backward yet)
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
    # fused multi-step dispatch: 1 only (not ported, raises)
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
    # stall watchdog: not ported, raises when set
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
    # device-time ledger sampling of train steps: 0 only (not ported,
    # raises)
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
        """Raise for the JAX trainer's knobs the port does not have yet,
        each naming its ROADMAP item; none falls back."""
        unported = [
            (config.window_size > 1, "window_size > 1 (the fused window step)", "queue 1 item 2d"),
            (config.remat_policy is not None, "remat_policy (selective remat)", "queue 1 item 2d"),
            (config.corr_impl in ("fused", "pallas"), f"training at corr_impl={config.corr_impl!r} "
             "(its kernels have no backward)", "queue 2 item 1 and queue 1 item 2e"),
            (config.watchdog_timeout is not None, "watchdog_timeout (the stall watchdog)", "queue 1 item 3g"),
            (config.profile_port is not None, "profile_port (the live profiler server)", "queue 1 item 3f"),
            (config.ledger_sample_every > 0, "ledger_sample_every > 0 (the device-time ledger of train "
             "steps)", "queue 1 item 3f"),
        ]
        for bad, what, item in unported:
            if bad:
                raise NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")

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
        self.stability = (
            StabilityMonitor(stability_policy, base_seed=config.seed)
            if config.numerics_policy == "skip" else None
        )
        self._lr_scale = 1.0
        self._eval_ok = True
        self._pending_good: list = []
        self._preempted = False

        self.state = TrainState.create(self.model, self.tx)
        self.step_fn = make_train_step(self.model, self.tx, **self._step_kw())

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
                self.model_config(config).replace(compute_dtype="float32", corr_dtype="float32", remat=False),
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
        """A window of per-step device metrics -> one host dict per step,
        in ONE device-to-host copy. ``"_"``-prefixed metrics (per-leaf
        counts) stay arrays; the rest become floats."""
        if not window:
            return []
        keys = list(window[0])
        flat = torch.cat([m[k].reshape(-1).to(torch.float64) for m in window for k in keys]).cpu().numpy()
        out, pos = [], 0
        for m in window:
            rec = {}
            for k in keys:
                n = m[k].numel()
                rec[k] = flat[pos:pos + n].copy() if k.startswith("_") else float(flat[pos])
                pos += n
            out.append(rec)
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

    def _rollback(self, at_step: int, window_skips: int, log_fn, logger) -> None:
        """Persistent-divergence recovery: restore the last known-good
        checkpoint, perturb the data-order seed, scale the LR when
        ``rollback_lr_scale < 1``; DivergenceError when the budget is
        spent or nothing can be restored."""
        mon = self.stability
        mon.check_escalation(at_step, window_skips)
        if self.manager is None:
            mon.fail(at_step, window_skips, "no checkpoint_dir configured: nothing to roll back to")
        new_seed = mon.next_seed()
        lr_scale = mon.next_lr_scale()
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
            self.step_fn = make_train_step(self.model, self.tx, **self._step_kw())
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
        logger = MetricLogger(cfg.log_dir) if cfg.log_dir else None
        start = int(self.state.step)
        self.model.train()
        t0 = time.perf_counter()
        window: list = []
        data_iter = iter(self.pipeline)
        restore_handlers = self._install_preemption_handler() if self.manager is not None else (lambda: None)
        try:
            step = start
            while step < cfg.num_steps:
                if self.manager is not None and self._preempted:
                    if self.manager.latest_step() != step:
                        self.manager.save(step, self.state, force=True)
                    print(f"preempted: checkpointed step {step}, exiting")
                    return self.state
                batch = next(data_iter)
                self.state, metrics = self.step_fn(self.state, batch)
                window.append(metrics)
                at_log = (step + 1) % cfg.log_every == 0
                hwin = None
                if at_log or (cfg.check_numerics and self.manager is not None
                              and (step + 1) % cfg.checkpoint_every == 0):
                    hwin = self._host_window(window)
                    if cfg.check_numerics and cfg.numerics_policy == "raise":
                        # never persist a poisoned state as the latest
                        self._check_window(step + 1, hwin)
                if self.manager is not None and self.manager.save(step + 1, self.state):
                    self._pending_good.append(step + 1)
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
                    log_fn(step + 1, mean)
                    if logger is not None:
                        logger.log(step + 1, mean)
                    window = []
                    t0 = time.perf_counter()
                    if breached:
                        self._rollback(step + 1, window_skips, log_fn, logger)
                        data_iter.close()
                        data_iter = iter(self.pipeline)
                        step = int(self.state.step)
                        t0 = time.perf_counter()
                        continue
                if cfg.eval_every and (step + 1) % cfg.eval_every == 0:
                    t_eval = time.perf_counter()
                    self._run_eval(step + 1, log_fn, logger)
                    t0 += time.perf_counter() - t_eval  # eval is not training time
                step += 1
        finally:
            restore_handlers()
            data_iter.close()
            if logger is not None:
                logger.close()
        if self.manager is not None:
            if cfg.check_numerics and cfg.numerics_policy == "raise" and window:
                self._check_window(cfg.num_steps, self._host_window(window))
            if self.manager.latest_step() != cfg.num_steps:
                self.manager.save(cfg.num_steps, self.state, force=True)
        return self.state
