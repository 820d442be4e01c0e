"""Fault-tolerance primitives: the stall watchdog, the data path's fault
policy, and deterministic fault injection.

The port's own copy of the JAX package's ``raft_tpu/utils/faults.py``:

  * :class:`Watchdog` — heartbeat stall detector armed around blocking
    regions (the trainer's data fetch, step, metrics fetch, checkpoint
    saves; the serving engine's dispatches and the host's waits on
    them); on timeout it dumps all-thread stacks via :mod:`faulthandler`
    and raises :class:`StallError` in the main thread, or, in callback
    mode, calls back on its own thread (the serving engine fails the
    stalled dispatch's requests there while its worker survives).
  * :class:`DataFaultPolicy`: what the input pipeline does with a sample
    that fails to load: retry transient ``OSError``s with capped
    exponential backoff, quarantine-and-skip deterministic parse errors,
    bounded by a bad-sample budget (``data.pipeline.TrainPipeline``);
  * :func:`retry_transient`: the backoff loop;
  * :class:`BadSampleBudgetError` and :class:`CheckpointRestoreError`
    (``checkpoint.manager``);
  * :class:`FaultInjector` / :func:`tear_checkpoint` — deterministic fault
    injection for the chaos tests and the card's smoke run: data reads,
    training steps and batches, the data fetch, the serving engine's
    dispatch seams and per-request flows, the router's heartbeat and
    dispatch seams, checkpoint commits.

Not ported yet: ``NetworkFaultInjector`` (it drives remote replicas,
ROADMAP queue 1 item 4b-ii).

Nothing here touches the fault-free hot path: the watchdog costs two
attribute writes per guarded region, the data policy engages only on
exceptions, and the injector is never installed outside tests.
"""

from __future__ import annotations

import collections
import dataclasses
import faulthandler
import os
import signal
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Optional, Tuple

__all__ = [
    "StallError",
    "BadSampleBudgetError",
    "CheckpointRestoreError",
    "DataFaultPolicy",
    "Watchdog",
    "FaultInjector",
    "retry_transient",
    "tear_checkpoint",
]


class StallError(RuntimeError):
    """A guarded region stayed blocked past the watchdog timeout."""


class BadSampleBudgetError(RuntimeError):
    """The data pipeline quarantined more distinct samples than allowed."""


class CheckpointRestoreError(RuntimeError):
    """No retained checkpoint restored and validated.

    ``attempts`` is the ``[(step, repr(error)), ...]`` trail of every step
    tried (newest first) so the failure is diagnosable from the message
    alone.
    """

    def __init__(self, msg: str, attempts: Tuple = ()):
        super().__init__(msg)
        self.attempts = tuple(attempts)


# Golden-ratio conjugate: frac(k * phi) is a low-discrepancy sequence in
# [0, 1): successive retry attempts get well-spread jitter fractions from
# the attempt counter alone, no RNG.
_JITTER_PHI = 0.6180339887498949


def retry_transient(
    fn: Callable[[], Any],
    *,
    attempts: int = 3,
    base_delay: float = 0.5,
    max_delay: float = 8.0,
    transient: Tuple[type, ...] = (OSError, TimeoutError),
    jitter: float = 0.25,
    max_elapsed: Optional[float] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Call ``fn()``, retrying ``transient`` errors with capped exponential
    backoff plus multiplicative jitter. The last failure re-raises; anything
    outside ``transient`` (deterministic parse errors, real bugs) propagates
    immediately.

    The jitter is **deterministic**: attempt ``k`` sleeps
    ``min(base * 2^k, max_delay) * (1 + jitter * frac((k + 1) * phi))`` —
    a counter-derived golden-ratio fraction instead of ``random()``, so
    retry schedules are reproducible in tests and the hot reconnect path
    never touches an RNG. ``max_elapsed`` is a wall-budget on the whole
    loop: once the elapsed time
    plus the next backoff would cross it, the current failure re-raises
    instead of sleeping: the budget bounds *time*, ``attempts`` bounds
    *tries*, and whichever is hit first ends the loop.
    """
    delay = base_delay
    t0 = time.monotonic()
    for attempt in range(attempts):
        try:
            return fn()
        except transient as e:
            if attempt == attempts - 1:
                raise
            pause = min(delay, max_delay) * (
                1.0 + jitter * ((attempt + 1) * _JITTER_PHI % 1.0)
            )
            if max_elapsed is not None and (
                time.monotonic() - t0 + pause > max_elapsed
            ):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(pause)
            delay *= 2.0
    raise AssertionError("unreachable")  # pragma: no cover


@dataclasses.dataclass(frozen=True)
class DataFaultPolicy:
    """What the input pipeline does when ``dataset[idx]`` raises.

    * ``transient`` errors (network/filesystem flakes — ``OSError`` and
      subclasses) are retried up to ``max_retries`` extra times with capped
      exponential backoff.
    * ``deterministic`` errors (parse failures — ``ValueError``: bad magic,
      corrupt header, truncated payload) are never retried; the bytes on
      disk will not change.
    * After retries are exhausted (or immediately, for deterministic
      errors): ``mode='skip'`` quarantines the index — it is skipped
      without re-reading on every future draw — and refills the batch slot
      from the index stream; ``mode='raise'`` propagates (fail-fast, the
      pre-fault-policy behavior, still with transient retries).
    * The run fails with :class:`BadSampleBudgetError` once more than
      ``max_bad_samples`` *distinct* samples are quarantined: mass
      corruption is a storage incident, not something to skip through.

    Counters (``data/skipped`` = skipped draws, ``data/retries`` = transient
    retries) surface through the trainer's log boundary.
    """

    mode: str = "skip"  # 'skip' | 'raise'
    max_bad_samples: int = 64
    max_retries: int = 2
    base_delay: float = 0.1
    max_delay: float = 5.0
    transient: Tuple[type, ...] = (OSError,)
    deterministic: Tuple[type, ...] = (ValueError,)

    def __post_init__(self):
        if self.mode not in ("skip", "raise"):
            raise ValueError(
                f"DataFaultPolicy.mode must be 'skip' or 'raise', got {self.mode!r}"
            )


class Watchdog:
    """Heartbeat stall watchdog for blocking host-side regions.

    Usage::

        wd = Watchdog(timeout=300, dump_path="stalls.log")
        with wd.section("train/step"):
            state, metrics = step_fn(state, batch)   # may hang
        ...
        wd.close()

    A daemon thread polls the armed section's deadline. On expiry it dumps
    all-thread stacks via :func:`faulthandler.dump_traceback` (to
    ``dump_path`` when given, else stderr) and interrupts the main thread —
    via a dedicated signal (``SIGUSR1``) whose handler raises
    :class:`StallError` — so an interruptible hang (queue wait, sleep,
    retry loop) becomes a raised, diagnosable error at the stalled call
    site. A hang inside a C extension that never returns to the
    interpreter cannot be unwound from Python; the stack dump (the
    diagnosis) still happens, which is the difference between "the job
    said nothing for six hours" and a pointed bug report.

    Arming/disarming is two attribute writes under a lock — safe to wrap
    around every step. Construct on the main thread (signal handler
    installation); elsewhere it degrades to ``_thread.interrupt_main``.

    On the card a dispatch returns once its work is queued, so a section
    around a launch alone never sees a device hang: guard the host's
    *wait* on the dispatch (an event or stream synchronize, a copy to the
    host) as well. A trip cannot cancel work already queued on the card;
    the caller decides what the abandoned work may still write.

    **Callback mode** (multi-threaded servers): interrupting the main
    thread is the right escalation for a single-threaded trainer, but in a
    server it would kill the wrong thread. ``section(name,
    on_timeout=cb)`` instead invokes ``cb(name)`` on the watcher thread
    after the stack dump — the serve engine uses this to fail the in-flight
    batch's requests with a typed deadline error while the worker thread
    survives. Pass ``install_handler=False`` to skip signal-handler
    installation entirely for a callback-only watchdog (safe to construct
    off the main thread; plain sections then fall back to
    ``interrupt_main``).
    """

    def __init__(
        self,
        timeout: float,
        *,
        poll: Optional[float] = None,
        dump_path: Optional[str] = None,
        signum: int = signal.SIGUSR1,
        install_handler: bool = True,
        recorder=None,
    ):
        if timeout <= 0:
            raise ValueError(f"timeout must be positive, got {timeout}")
        # optional obs.FlightRecorder: every trip records a
        # structured watchdog_trip event AND dumps a postmortem bundle —
        # the 5 s of fault-ladder context before the stall, captured at
        # the moment it still exists
        self.recorder = recorder
        self.timeout = float(timeout)
        self.poll = poll if poll is not None else max(0.05, min(self.timeout / 4.0, 1.0))
        self.dump_path = dump_path
        self.stall_count = 0
        self.last_stall: Optional[str] = None
        self._pending: Optional[str] = None  # stalled-section name, set pre-interrupt
        # (name, deadline, on_timeout-or-None)
        self._armed: Optional[Tuple[str, float, Optional[Callable]]] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._signum = signum
        self._main = threading.main_thread()
        self._old_handler = None
        self._handler_installed = False
        if install_handler:
            try:
                self._old_handler = signal.signal(signum, self._on_signal)
                self._handler_installed = True
            except ValueError:  # not on the main thread
                pass
        self._thread = threading.Thread(
            target=self._watch, name="raft-watchdog", daemon=True
        )
        self._thread.start()

    # -- main-thread side -------------------------------------------------

    def _on_signal(self, signum, frame):
        name = self._pending
        self._pending = None
        if name is None:
            # not our interrupt (external SIGUSR1): defer to the previous
            # handler instead of swallowing it
            if callable(self._old_handler):
                self._old_handler(signum, frame)
            return
        raise StallError(self._message(name))

    def _message(self, name: str) -> str:
        where = self.dump_path or "stderr"
        return (
            f"watchdog: {name!r} stalled for more than {self.timeout:g}s; "
            f"all-thread stacks dumped to {where}"
        )

    @contextmanager
    def section(self, name: str, *, scale: float = 1.0, on_timeout=None):
        """Arm the watchdog around a blocking region.

        ``scale`` stretches the deadline for regions that are legitimately
        slow once (first-step jit compilation, first eval) without loosening
        the steady-state timeout. ``on_timeout`` (callback mode) is invoked
        as ``on_timeout(name)`` on the *watcher* thread instead of
        interrupting the main thread — the worker-thread-safe escalation for
        servers; trainer sections (no callback) behave exactly as before.
        """
        self.beat(name, scale=scale, on_timeout=on_timeout)
        try:
            yield self
        except KeyboardInterrupt:
            # interrupt_main fallback path (no handler installed): convert
            # our own interrupt to the typed error, pass real Ctrl+C through
            pending, self._pending = self._pending, None
            if pending is not None:
                raise StallError(self._message(pending)) from None
            raise
        finally:
            self.disarm()

    def beat(
        self, name: Optional[str] = None, *, scale: float = 1.0, on_timeout=None
    ) -> None:
        """(Re-)arm: push the deadline ``timeout * scale`` seconds out.

        A bare ``beat()`` inside an armed section keeps the section's name
        *and* its callback.
        """
        with self._lock:
            if name is None and self._armed is not None:
                name = self._armed[0]
                if on_timeout is None:
                    on_timeout = self._armed[2]
            self._armed = (
                name or "<unnamed>",
                time.monotonic() + self.timeout * scale,
                on_timeout,
            )

    def disarm(self) -> None:
        with self._lock:
            self._armed = None

    def close(self) -> None:
        """Stop the watcher thread and restore the signal handler."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        if self._handler_installed:
            try:
                signal.signal(self._signum, self._old_handler or signal.SIG_DFL)
            except ValueError:  # pragma: no cover - close() off-main-thread
                pass
            self._handler_installed = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- watcher-thread side ----------------------------------------------

    def _watch(self):
        while not self._stop.wait(self.poll):
            with self._lock:
                armed = self._armed
            if armed is None:
                continue
            name, deadline, on_timeout = armed
            if time.monotonic() < deadline:
                continue
            self.stall_count += 1
            self.last_stall = name
            self._dump_stacks(name)
            if self.recorder is not None:
                try:
                    self.recorder.record(
                        "watchdog_trip", section=name,
                        timeout_s=self.timeout, stalls=self.stall_count,
                    )
                    self.recorder.dump(f"watchdog_trip:{name}")
                except Exception:  # telemetry never masks the stall
                    pass
            if on_timeout is not None:
                # callback mode: escalate on the watcher thread, never
                # interrupt the main thread (it is not the stalled one)
                try:
                    on_timeout(name)
                except Exception:  # a broken callback must not kill the watcher
                    pass
            else:
                self._pending = name
                self._interrupt_main()
            with self._lock:
                # fire once per arm; the next section()/beat() re-arms
                if self._armed is armed:
                    self._armed = None

    def _dump_stacks(self, name: str) -> None:
        header = (
            f"\n=== watchdog: {name!r} exceeded {self.timeout:g}s at "
            f"{time.strftime('%Y-%m-%d %H:%M:%S')}; all-thread stacks ===\n"
        )
        try:
            if self.dump_path:
                os.makedirs(os.path.dirname(self.dump_path) or ".", exist_ok=True)
                with open(self.dump_path, "a") as f:
                    f.write(header)
                    f.flush()
                    faulthandler.dump_traceback(file=f, all_threads=True)
            else:
                sys.stderr.write(header)
                faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        except Exception:  # the dump must never mask the stall itself
            pass

    def _interrupt_main(self) -> None:
        if self._handler_installed and self._main.ident is not None:
            try:
                signal.pthread_kill(self._main.ident, self._signum)
                return
            except (AttributeError, ValueError, OSError):  # pragma: no cover
                pass
        import _thread  # pragma: no cover - non-main-thread fallback

        _thread.interrupt_main()  # pragma: no cover


# ---------------------------------------------------------------------------
# Fault injection (chaos tests)
# ---------------------------------------------------------------------------

_UNSET = object()


def _restore(obj, name: str, own) -> None:
    """Put back what ``obj`` held under ``name`` before a patch: its own
    attribute, or none (the class's method shows through again)."""
    if own is _UNSET:
        vars(obj).pop(name, None)
    else:
        setattr(obj, name, own)


class FaultInjector:
    """Deterministic fault injection for the chaos tests.

    Faults are *planned* against named sites keyed by 0-based call index,
    then *installed* with monkeypatch-style ``patch_*`` context managers
    (originals restored on exit — never active outside the ``with``)::

        inj = FaultInjector()
        inj.on("io.read", when=lambda i, path: i % 100 == 7,
               action=ValueError("injected: corrupt sample"))
        inj.on("train.step", when=3, action=0.5)           # 0.5s stall
        inj.on("ckpt.commit", when=2, action=FaultInjector.tear)
        with inj.patch_reads(), inj.patch_step(trainer):
            trainer.run()

    ``action`` may be an exception instance/class (raised), a number
    (seconds slept — latency injection), or a callable taking the site
    context. ``counts``/``fired`` record observed traffic per site.
    """

    def __init__(self):
        self.counts: collections.Counter = collections.Counter()
        self.fired: collections.Counter = collections.Counter()
        self._plans = collections.defaultdict(list)
        self._lock = threading.Lock()

    def on(self, site: str, when, action) -> "FaultInjector":
        """Schedule ``action`` at the matching calls of ``site``.

        ``when``: an int call index, a container of indices, or a
        predicate ``(index, context) -> bool``.
        """
        with self._lock:
            self._plans[site].append((when, action))
        return self

    def fire(self, site: str, ctx: Any = None) -> None:
        """Instrumentation point: count the call, apply any matching plan."""
        with self._lock:
            idx = self.counts[site]
            self.counts[site] = idx + 1
            plans = list(self._plans.get(site, ()))
        for when, action in plans:
            if self._matches(when, idx, ctx):
                with self._lock:
                    self.fired[site] += 1
                self._apply(action, ctx)

    @staticmethod
    def _matches(when, idx: int, ctx) -> bool:
        if callable(when):
            return bool(when(idx, ctx))
        if isinstance(when, int):
            return idx == when
        return idx in when

    @staticmethod
    def _apply(action, ctx) -> None:
        if isinstance(action, BaseException):
            raise action
        if isinstance(action, type) and issubclass(action, BaseException):
            raise action("injected fault")
        if isinstance(action, (int, float)):
            time.sleep(float(action))
            return
        action(ctx)

    @staticmethod
    def tear(ctx) -> None:
        """``ckpt.commit`` action: tear the just-committed checkpoint."""
        manager, step = ctx
        tear_checkpoint(manager.directory, step)

    @staticmethod
    def nan_grads(ctx) -> None:
        """``step.nan_grads`` action: poison the batch so the backward pass
        produces NaN gradients (what a bf16 overflow burst looks like from
        the optimizer's side). Replaces ``image1`` in the step's batch
        dict (a tensor on the step's device) with NaNs."""
        import torch

        ctx["image1"] = torch.full_like(torch.as_tensor(ctx["image1"]), float("nan"))

    @staticmethod
    def nan_flow(ctx) -> None:
        """``infer.nan_flow`` action: poison one serve request's output flow
        (what a numerically pathological input looks like from the engine's
        side). Mutates the per-request flow array in place; pair with a
        ``when`` predicate keyed on ``ctx['rid']`` so the same request stays
        poisoned across the batch pass *and* its single-isolation retry."""
        ctx["flow"][...] = float("nan")

    @staticmethod
    def replica_dead(ctx) -> None:
        """``router.heartbeat`` action: make one replica's probe report a
        dead worker (``healthy=False``) without touching the engine, which
        is what a crashed serving worker looks like from the router's
        health loop. Mutates the probe's health dict in place; pair with a
        ``when`` predicate keyed on ``ctx['replica']``."""
        ctx["health"]["healthy"] = False

    @staticmethod
    def loss_spike(ctx, scale: float = 100.0) -> None:
        """``step.loss_spike`` action: blow the input images far out of
        their [-1, 1] contract so the loss and the gradient global-norm
        jump by orders of magnitude while staying FINITE — the grad-norm
        spike the EMA detector must catch. (Scaling the ground-truth flow
        would not work: the sequence loss is L1, whose gradient magnitude
        is scale-invariant in the flow error.)"""
        for k in ("image1", "image2"):
            ctx[k] = ctx[k] * float(scale)

    # -- installation -----------------------------------------------------

    @contextmanager
    def patch_reads(self):
        """Route data-file reads through site ``'io.read'`` (ctx = path).

        Patches both ``data.io`` and the names ``data.datasets`` imported
        from it, so reads through either module are seen.
        """
        from raft_tpu_torch.data import datasets as ds_mod
        from raft_tpu_torch.data import io as io_mod

        def wrap(fn):
            def inner(path, *a, **kw):
                self.fire("io.read", path)
                return fn(path, *a, **kw)

            return inner

        targets = [
            (io_mod, "read_image"), (io_mod, "read_flow"),
            (ds_mod, "read_image"), (ds_mod, "read_flow"),
        ]
        originals = [(mod, name, getattr(mod, name)) for mod, name in targets]
        try:
            for mod, name, orig in originals:
                setattr(mod, name, wrap(orig))
            yield self
        finally:
            for mod, name, orig in originals:
                setattr(mod, name, orig)

    @contextmanager
    def patch_step(self, trainer):
        """Route ``trainer.step_fn`` (and, at ``window_size > 1``,
        ``trainer.window_fn``) dispatches through site ``'train.step'``
        (latency injection: a numeric action stalls the host before
        dispatch, exactly what a hung collective looks like from the
        training loop's side)."""
        names = [n for n in ("step_fn", "window_fn") if getattr(trainer, n, None) is not None]
        originals = {n: getattr(trainer, n) for n in names}

        def wrap(fn):
            def wrapped(state, batch):
                self.fire("train.step")
                return fn(state, batch)

            return wrapped

        for n in names:
            setattr(trainer, n, wrap(originals[n]))
        try:
            yield self
        finally:
            for n in names:
                setattr(trainer, n, originals[n])

    @contextmanager
    def patch_batches(self, trainer):
        """Route the trainer's batches through the model-fault sites and
        its data fetch through the data site:

        * ``'step.nan_grads'`` and ``'step.loss_spike'`` — fired on every
          batch entering ``trainer.step_fn`` (ctx = the step's batch dict,
          tensors on the step's device; actions replace entries), so
          NaN-grad bursts and grad-norm spikes are injectable without
          touching the step — pair with the :meth:`nan_grads` /
          :meth:`loss_spike` actions. Both sites see every step; plans
          pick the steps that fault. At ``window_size=k > 1`` the window
          is split into its steps on the device, the sites fire once per
          STEP (the per-step loop's call-index numbering, so one plan
          drives both), and the window is restacked.
        * ``'data.next'`` — fired as the trainer fetches each batch or
          window from its pipeline (ctx = the step the fetch serves),
          inside the trainer's ``data/next`` watchdog section: a numeric
          action is a stalled input pipeline.

        Also wraps ``trainer._make_step_fns`` so the sites survive a
        rollback that rebuilds the step (``rollback_lr_scale < 1``).
        """
        import torch

        def fire_sites(batch):
            batch = dict(batch)
            self.fire("step.nan_grads", batch)
            self.fire("step.loss_spike", batch)
            return batch

        def wrap(fn):
            def wrapped(state, batch):
                return fn(state, fire_sites(batch))

            return wrapped

        def wrap_window(fn):
            def wrapped(state, window):
                keys = list(window)
                subs = [fire_sites({k: window[k][i] for k in keys}) for i in range(window[keys[0]].shape[0])]
                return fn(state, {k: torch.stack([s[k] for s in subs]) for k in keys})

            return wrapped

        def install():
            trainer.step_fn = wrap(trainer.step_fn)
            if trainer.window_fn is not None:
                trainer.window_fn = wrap_window(trainer.window_fn)

        orig_step, orig_window = trainer.step_fn, trainer.window_fn
        orig_make, orig_next = trainer._make_step_fns, trainer._next_batch

        def make_step_fns():
            orig_make()
            install()

        def next_batch(data_iter, step):
            self.fire("data.next", step)
            return orig_next(data_iter, step)

        install()
        trainer._make_step_fns = make_step_fns
        trainer._next_batch = next_batch
        try:
            yield self
        finally:
            trainer.step_fn, trainer.window_fn = orig_step, orig_window
            del trainer._make_step_fns  # restore the class methods
            del trainer._next_batch

    @contextmanager
    def patch_engine(self, engine):
        """Route a serve engine's execution seams through the inference
        fault sites:

        * ``'infer.slow_apply'`` — fired before every dispatch (ctx =
          ``{'batch': B, 'iters': n, 'stage': s}`` with ``stage`` one of
          ``'pair'``/``'encode'``/``'iterate'`` — the whole-request
          forward and the stream path's two stages — or, for the
          iteration pool, ``'pool_begin'``/``'pool_begin_features'``/
          ``'pool_step'``/``'pool_final'`` — admission, per-tick
          refinement, and retirement dispatches), on the engine's worker
          thread, where the dispatch's device work is enqueued; a numeric
          action stalls the worker pre-dispatch, an exception action
          models a failed dispatch the worker must survive, and a
          callable may enqueue work of its own on the card (a
          ``torch.cuda._sleep`` ahead of the replay is a device stall).
        * ``'infer.nan_flow'`` — fired on every per-request output
          (ctx = ``{'rid': id, 'flow': mutable (H, W, 2) array}``); pair
          with the :meth:`nan_flow` action and an rid-keyed ``when`` to
          poison exactly one request through batch pass and single retry.
        """
        import numpy as np

        def seam(name, stage, batch_of, iters_of=lambda *a: 0):
            orig = getattr(engine, name)

            def run(*a):
                self.fire("infer.slow_apply", {"batch": int(batch_of(*a)), "iters": int(iters_of(*a)),
                                               "stage": stage})
                return orig(*a)

            return name, vars(engine).get(name, _UNSET), run

        seams = [
            seam("_run_batch", "pair", lambda p1, p2, it: p1.shape[0], lambda p1, p2, it: it),
            seam("_run_encode", "encode", lambda frames: frames.shape[0]),
            seam("_run_iterate", "iterate", lambda f1, f2, cx, it: f1.shape[0], lambda f1, f2, cx, it: it),
            seam("_run_pool_begin", "pool_begin", lambda p1, p2: p1.shape[0]),
            seam("_run_pool_begin_features", "pool_begin_features", lambda f1, f2, cx, ini: f1.shape[0]),
            seam("_run_pool_step", "pool_step", lambda pool: pool.state["coords1"].shape[0], lambda pool: 1),
            seam("_run_pool_final", "pool_final", lambda c1, hid: c1.shape[0]),
        ]
        orig_req = engine._request_flow

        def request_flow(req, flow):
            flow = np.array(flow)  # mutable copy so actions can poison it
            self.fire("infer.nan_flow", {"rid": req.rid, "flow": flow})
            return orig_req(req, flow)

        seams.append(("_request_flow", vars(engine).get("_request_flow", _UNSET), request_flow))
        for name, _, run in seams:
            setattr(engine, name, run)
        try:
            yield self
        finally:
            for name, orig, _ in seams:
                _restore(engine, name, orig)

    @contextmanager
    def patch_router(self, router):
        """Route a :class:`~raft_tpu_torch.serve.router.ServeRouter`'s seams
        through the serving tier's fault sites:

        * ``'router.heartbeat'`` — fired per monitor probe, *after* the
          replica's ``health()`` returns (ctx = ``{'replica': id,
          'health': mutable dict}``). Actions: mutate the health dict
          (:meth:`replica_dead` models a crashed worker the router must
          evict), raise (a failing probe), or a number (seconds slept: a
          stalled heartbeat; past ``heartbeat_timeout_s`` the router
          evicts).
        * ``'router.dispatch'`` — fired on the caller's thread just before
          each replica dispatch (ctx = ``{'replica': id, 'kind':
          'pair'|'tiled'|'stream', 'attempt_inflight': n}``). A numeric
          action is a slow replica; an exception a replica-side dispatch
          failure the router must re-route (counted against the replica's
          error-rate budget).

        The engine seams (:meth:`patch_engine`) still compose: patch one
        replica's engine to poison flows or stall dispatches inside it
        while the router sites watch the tier.
        """
        orig_probe = router._probe_health
        orig_before = router._before_dispatch

        def probe(rep):
            ctx = {"replica": rep.replica_id, "health": orig_probe(rep)}
            self.fire("router.heartbeat", ctx)
            return ctx["health"]

        def before_dispatch(rep, kind):
            self.fire("router.dispatch", {"replica": rep.replica_id, "kind": kind, "attempt_inflight": rep.inflight})
            return orig_before(rep, kind)

        seams = [(name, vars(router).get(name, _UNSET), fn)
                 for name, fn in (("_probe_health", probe), ("_before_dispatch", before_dispatch))]
        for name, _, fn in seams:
            setattr(router, name, fn)
        try:
            yield self
        finally:
            for name, orig, _ in seams:
                _restore(router, name, orig)

    @contextmanager
    def patch_checkpoint_commits(self, manager):
        """Route durable saves through site ``'ckpt.commit'``
        (ctx = ``(manager, step)``), fired once the save has committed, so
        a ``tear`` action corrupts a fully committed checkpoint — the
        bitrot/partial-flush case an atomic rename cannot catch."""
        orig, own = manager.save, vars(manager).get("save", _UNSET)

        def wrapped(step, state, **kw):
            saved = orig(step, state, **kw)
            if saved:
                self.fire("ckpt.commit", (manager, step))
            return saved

        manager.save = wrapped
        try:
            yield self
        finally:
            _restore(manager, "save", own)


def tear_checkpoint(directory: str, step: int) -> str:
    """Simulate a torn write: truncate the largest file under the committed
    ``step`` directory to half its size. Returns the mangled path.

    This models the failure an atomic rename cannot protect against — a
    committed checkpoint whose payload is damaged (lost page-cache flush
    on hard power-off, storage bitrot) — and is what the restore
    validation's fallback chain exists to survive.
    """
    step_dir = os.path.join(str(directory), str(step))
    if not os.path.isdir(step_dir):
        raise FileNotFoundError(step_dir)
    victim, size = None, -1
    for root, _, files in os.walk(step_dir):
        for fn in files:
            p = os.path.join(root, fn)
            s = os.path.getsize(p)
            if s > size:
                victim, size = p, s
    if victim is None:
        raise FileNotFoundError(f"no files under {step_dir}")
    with open(victim, "r+b") as f:
        f.truncate(max(1, size // 2))
    return victim
