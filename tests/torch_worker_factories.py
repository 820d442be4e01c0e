"""Picklable engine factories for spawned serving workers (no JAX here).

A spawned worker unpickles its factory by re-importing the factory's
module, so this module imports neither ``jax`` nor ``raft_tpu`` at its top
level: a port worker must never load JAX. ``tests/test_torch_serve_worker.py``
imports both packages and hands these factories to the workers; the
serving tier's tests share the stub engine.

* :class:`TinyEngineFactory`: the port's ``ServeEngine`` over the tiny CPU
  model of ``tests/test_torch_serve.py`` (``TINY``, ``CONFIG``: kept equal
  to that module's, which the worker tests assert), its weights read from
  a torch file the parent wrote, two CPU threads in the child.
* :class:`StubEngine`: a pure-Python engine with the surface the serving
  tier and a worker drive (``submit_many`` with done-callbacks, streams,
  drain, stats, recorder, tracer), built from either package's serving
  classes (``pkg`` ``'jax'`` or ``'port'``, imported where it runs), so
  both packages' routers, autoscalers, rollouts and worker clients meet
  the same scripted outcomes. :class:`StubFactory` builds it in a worker.
"""

from __future__ import annotations

import threading
from types import SimpleNamespace
from typing import Any, Dict, Optional

import numpy as np

TINY = dict(
    feature_encoder_widths=(8, 8, 12, 16, 24),
    context_encoder_widths=(8, 8, 12, 16, 40),
    motion_corr_widths=(16,),
    motion_flow_widths=(16, 8),
    motion_out_channels=20,
    gru_hidden=24,
    flow_head_hidden=16,
    corr_levels=2,
)
BUCKET, HW = (48, 64), (45, 60)
CONFIG = dict(
    buckets=(BUCKET,), ladder=(3, 2, 1), max_batch=4, pool_capacity=3, queue_capacity=8,
    max_wait_ms=4.0, default_deadline_ms=30000.0, cooldown_batches=1, recover_after=1,
    high_watermark=1.0, low_watermark=0.25,
)
THREADS = 2  # a spawned child does not inherit torch.set_num_threads


def tiny_model(weights_path: Optional[str] = None, device="cpu"):
    """The port's tiny model, its weights from ``weights_path``."""
    import torch

    import raft_tpu_torch as rt

    model = rt.build_raft(rt.RAFT_SMALL.replace(corr_radius=3, **TINY), device=device)
    if weights_path is not None:
        model.load_state_dict(torch.load(weights_path, map_location=device, weights_only=True), strict=True)
    return model


class TinyEngineFactory:
    """``factory(**overrides) -> ServeEngine`` (unstarted) over the tiny
    model on ``device``, for ``backend='process'`` replicas and
    ``ProcessEngineClient``."""

    def __init__(self, weights_path: str, device: str = "cpu", **cfg_kw):
        self.weights_path = weights_path
        self.device = device
        self.cfg_kw = dict(cfg_kw)

    def __call__(self, **overrides):
        import torch

        from raft_tpu_torch.serve import ServeConfig, ServeEngine

        torch.set_num_threads(THREADS)
        kw = dict(CONFIG, **self.cfg_kw)
        kw.update(overrides)
        return ServeEngine(tiny_model(self.weights_path, self.device), ServeConfig(**kw), device=self.device)


# -- the stub engine -------------------------------------------------------


def _classes(pkg: str) -> Dict[str, Any]:
    """The serving classes of one package, imported where the stub runs."""
    if pkg == "jax":
        from raft_tpu.obs import FlightRecorder, Tracer
        from raft_tpu.serve import errors
        from raft_tpu.serve.config import ServeConfig
    elif pkg == "port":
        from raft_tpu_torch.obs import FlightRecorder, Tracer
        from raft_tpu_torch.serve import errors
        from raft_tpu_torch.serve.config import ServeConfig
    else:
        raise ValueError(f"pkg must be 'jax' or 'port', got {pkg!r}")
    return dict(errors=errors, ServeConfig=ServeConfig, FlightRecorder=FlightRecorder, Tracer=Tracer)


# label -> what the stub does with a pair whose first pixel is that label
STUB_SCRIPT = {3: "shed", 5: "poison", 7: "invalid", 9: "deadline", 11: "fault", 13: "shape"}


class _Handle:
    """A finished request handle as ``submit_many`` returns it."""

    def __init__(self, result=None, error=None):
        self.result, self.error, self.trace = result, error, None


class StubEngine:
    """A deterministic pure-Python engine with the surface the serving tier
    and a worker process drive, raising package ``pkg``'s own typed errors
    (``'jax'`` or ``'port'``, imported where the stub runs), so both
    packages' tiers and clients meet the same outcomes.

    A request's label is the first element of its first image (the tier
    tests submit plain ints). ``script`` maps ``(name, label)`` or
    ``label`` to ``'shed'`` (``Overloaded`` with ``retry_after_ms`` = 10 x
    label), ``'poison'``, ``'invalid'``, ``'deadline'``, ``'shape'`` (the
    typed errors) or ``'fault'`` (a replica-side ``RuntimeError``). A
    served request's flow is ``flow`` (``None``: label / 4) at the image's
    height and width (2 x 2 for a label); a stream's first frame primes.
    A ``shadow=True`` request is counted in the ``shadow_*`` twins. The
    config is the package's ``ServeConfig`` at ``CONFIG`` with a 1 s
    default deadline and ``overrides``."""

    def __init__(self, pkg: str, name: str = "stub", script=None, *, variables_hash: str = "h0",
                 flow: Optional[float] = 0.0, **overrides):
        c = _classes(pkg)
        self.errors = c["errors"]
        self.name, self.script, self.flow = name, script or {}, flow
        self.overrides, self.variables_hash = overrides, variables_hash
        self.config = c["ServeConfig"](**dict(CONFIG, default_deadline_ms=1000.0, **overrides))
        self.recorder = c["FlightRecorder"]()
        self.tracer = c["Tracer"](0.0)
        self._lock = threading.Lock()
        self._rid = self._sid = 0
        self.running = self.draining = False
        self.streams = set()  # streams that have their first frame
        self.level = self.queue_depth = 0
        self.counters = dict(submitted=0, completed=0, shed=0, shed_slow_path=0, expired=0, frames=0,
                             shadow_submitted=0, shadow_completed=0, shadow_shed=0, shadow_expired=0)

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self.running = True
        return self

    def close(self, graceful: bool = False, timeout: Optional[float] = None) -> None:
        self.running = False

    def drain(self, *, timeout: Optional[float] = 30.0) -> bool:
        self.draining = True
        return True

    # -- serving -----------------------------------------------------------

    def _serve(self, image, primed: bool = False, shadow: bool = False):
        e = self.errors
        if not self.running:
            raise e.EngineStopped("stub stopped")
        if self.draining:
            raise e.Draining("stub draining", retry_after_ms=50.0)
        a = np.asarray(image)
        label = int(a.reshape(-1)[0])
        pre = "shadow_" if shadow else ""
        with self._lock:
            self._rid += 1
            rid = self._rid
            self.counters[pre + "submitted"] += 1
        what = self.script.get((self.name, label), self.script.get(label))
        if what in ("shed", "deadline"):
            with self._lock:
                self.counters[pre + ("shed" if what == "shed" else "expired")] += 1
        if what == "shed":
            raise e.Overloaded(f"stub shed {label}", retry_after_ms=10.0 * label)
        if what == "poison":
            raise e.PoisonedInput(f"stub poisoned {label}")
        if what == "invalid":
            raise e.InvalidInput(f"stub invalid {label}")
        if what == "deadline":
            raise e.DeadlineExceeded(f"stub deadline {label}")
        if what == "fault":
            raise RuntimeError(f"stub replica fault {label}")
        if what == "shape":
            raise e.ShapeRejected(f"stub shape {a.shape}", supported_buckets=(BUCKET,), nearest=BUCKET)
        with self._lock:
            self.counters[pre + "completed"] += 1
        hw = a.shape[:2] if a.ndim >= 2 else (2, 2)
        value = label / 4.0 if self.flow is None else self.flow
        # every ServeResult field (what the wire reads), and the replica
        return SimpleNamespace(
            flow=None if primed else np.full(hw + (2,), value, np.float32), rid=rid, bucket=BUCKET,
            num_flow_updates=1, level=0, degraded=False, latency_ms=0.0, slow_path=False, retried_single=False,
            primed=primed, exit_reason="target", trace_id=None, residuals=(0.5, float(label)), warm_started=False,
            replica=self.name,
        )

    def submit(self, image1, image2, *, deadline_ms=None, num_flow_updates=None, shadow=False, **kw):
        return self._serve(image1, shadow=shadow)

    def submit_many(self, items):
        handles = []
        for it in items:
            try:
                h = _Handle(result=self._serve(it["image1"], shadow=bool(it.get("shadow", False))))
            except Exception as err:  # noqa: BLE001 -- finished with its error, as the engine's handles
                h = _Handle(error=err)
            cb = it.get("on_done")
            if cb is not None:
                cb(h)
            handles.append(h)
        return handles

    def open_stream(self):
        with self._lock:
            self._sid += 1
            return SimpleNamespace(stream_id=self._sid)

    def submit_frame(self, stream_id, frame, *, deadline_ms=None, num_flow_updates=None, shadow=False, **kw):
        with self._lock:
            self.counters["frames"] += 1
            primed = stream_id not in self.streams
            self.streams.add(stream_id)
        return self._serve(frame, primed, shadow=shadow)

    def close_stream(self, stream_id) -> None:
        self.streams.discard(stream_id)

    # -- introspection -----------------------------------------------------

    def health(self) -> dict:
        return {"ready": self.running, "healthy": self.running, "draining": self.draining,
                "queue_depth": self.queue_depth, "queue_capacity": self.config.queue_capacity, "level": self.level,
                "watchdog_trips": 0}

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters, boot={"source": "stub", "name": self.name},
                        variables_hash=self.variables_hash)

    def alerts(self) -> dict:
        return {"active": []}

    def prometheus(self) -> str:
        return f'# TYPE serve_counters counter\nserve_counters{{key="submitted"}} {self.counters["submitted"]}\n'


class StubFactory:
    """``factory(**overrides) -> StubEngine`` of package ``pkg`` running
    ``STUB_SCRIPT``, its flows label / 4, its weights' hash ``stub-<name>``."""

    def __init__(self, pkg: str, name: str = "stub"):
        self.pkg, self.name = pkg, name

    def __call__(self, **overrides):
        return StubEngine(self.pkg, self.name, STUB_SCRIPT, variables_hash=f"stub-{self.name}", flow=None,
                          **overrides)
