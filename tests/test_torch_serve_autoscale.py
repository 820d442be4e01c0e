"""The port's autoscaler against the JAX package's, and the engine's
teardown (F7) and stop-time logging (R4), on the CPU.

Both autoscalers run over the same stub fleets (``StubEngine`` of
``tests/test_torch_serve_router.py``) under one fake clock (each module's
``time`` replaced), so a seeded trace of signals meets the same
hysteresis, bounds and cooldowns. Then a flood and an idle spell through
each package's router and monitor (20 ms beats): the same actions, 1 -> 2
-> 1.

F7: a stopped engine sits in no reference cycle. With the collector off,
an engine that served a request and failed another (a stored error raised
to its caller), stopped and dropped, is gone at once, in both engine
modes. R4: with ``log_every_batches=0`` and a logger, the worker serves
and the counters are logged once, at ``stop()``.
"""

import gc
import json
import time
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("raft_tpu")

from test_torch_serve import TINY, _config, _image  # noqa: E402
from test_torch_serve_router import PKGS, _stub_router  # noqa: E402
from torch_worker_factories import StubEngine  # noqa: E402

from raft_tpu.serve import autoscale as jax_autoscale  # noqa: E402

import raft_tpu_torch as rt  # noqa: E402
from raft_tpu_torch.serve import DeadlineExceeded, ServeEngine  # noqa: E402
from raft_tpu_torch.serve import autoscale as port_autoscale  # noqa: E402
from raft_tpu_torch.utils.logging import MetricLogger  # noqa: E402

torch.set_num_threads(2)

MODULES = {"port": port_autoscale, "jax": jax_autoscale}


class StubRouter:
    """The router surface the autoscaler reads, with scripted stats and
    health; the scale verbs are recorded."""

    def __init__(self):
        self.calls, self.replicas, self._stats, self._health = [], [], {}, {}

    def attach_autoscaler(self, scaler):
        self.scaler = scaler

    def stats(self):
        return self._stats

    def health(self):
        return self._health

    def add_replica(self, **kw):
        self.calls.append(("add", kw["reason"]))

    def remove_replica(self, rid, **kw):
        self.calls.append(("remove", rid, kw["reason"]))


@pytest.fixture
def clock(monkeypatch):
    """One fake monotonic clock for both autoscale modules."""
    now = [1000.0]
    for mod in MODULES.values():
        monkeypatch.setattr(mod, "time", SimpleNamespace(monotonic=lambda: now[0]))
    return now


def _trace(seed=0, n=80):
    """Alternating spells of 10 evaluations: pressure (random sheds, misses,
    occupancy, degradation, QoS high-class rates) and calm (mostly quiet
    queues)."""
    rng = np.random.default_rng(seed)
    sigs = []
    for k in range(n):
        calm = (k // 10) % 2 == 1
        sigs.append({
            "shed_rate": 0.0 if calm else float(rng.choice([0.0, 0.0, 0.01, 0.05])),
            "slo_miss_rate": 0.0 if calm else float(rng.choice([0.0, 0.0, 0.0, 0.1])),
            "occupancy": float(rng.choice([0.05, 0.1, 0.3] if calm else [0.05, 0.1, 0.5, 0.9])),
            "degraded_level": 0.0 if calm else float(rng.choice([0.0, 0.0, 0.3, 1.0])),
            "replica_count": int(rng.integers(0, 6)),
            "warmed_up": k > 0,
            "qos_high_class": bool(rng.random() < 0.2),
        })
    return sigs


def _decisions(pkg, clock, sigs):
    mod = MODULES[pkg]
    router = StubRouter()
    router.replicas = [SimpleNamespace(replica_id=f"r{i}", state=s, backend="thread")
                       for i, s in enumerate(["healthy", "draining", "healthy", "unhealthy"])]
    cfg = mod.AutoscaleConfig(min_replicas=1, max_replicas=4, up_after=2, down_after=3, cooldown_s=2.5)
    scaler = mod.Autoscaler(router, cfg)
    out = []
    for sig in sigs:
        clock[0] += 1.0
        d = scaler.decide(dict(sig), clock[0])
        if d["action"] != "hold":
            d["signals"] = sig
            scaler._apply(d)
            scaler._action_thread.join()
        out.append(d)
    return out, router.calls, scaler.scale_ups, scaler.scale_downs


def test_decide_matches_jax(clock):
    """A seeded trace of 80 evaluations (below the floor, at the cap, QoS
    high-class rates, cold first evaluation): the same verdicts, reasons
    and streaks, the same scale calls (the newest healthy replica is the
    victim), cooldowns included."""
    sigs = _trace()
    port, want = _decisions("port", clock, sigs), _decisions("jax", clock, sigs)
    assert port == want
    actions = {d["action"] for d in port[0]}
    assert actions == {"up", "down", "hold"} and any("cooldown" in d["reason"] for d in port[0])
    assert port[3] >= 1 and all(c[1] == "r2" for c in port[1] if c[0] == "remove")


def _signal_seq(pkg, clock):
    """Signals of a stub fleet between bursts of scripted traffic."""
    router = _stub_router(pkg, heartbeat_interval_s=60.0).start()
    scaler = MODULES[pkg].Autoscaler(router)
    out = []
    try:
        engines = [rep.engine for rep in router.replicas]
        for step, (sub, shed, depth, level) in enumerate([(0, 0, 0, 0), (30, 3, 4, 1), (10, 0, 8, 2), (0, 0, 0, 0)]):
            for i, eng in enumerate(engines):
                eng.counters["submitted"] += sub * (i + 1)
                eng.counters["shed"] += shed
                eng.counters["expired"] += step
                eng.queue_depth, eng.level = depth, level * i
            clock[0] += 2.0
            out.append(scaler.signals())
        engines[1].running = False  # an unhealthy engine still counts in the fleet
        out.append(scaler.signals())
    finally:
        router.close()
    return out


def test_signals_match_jax(clock):
    """Arrival rate, shed and SLO-miss rates from the aggregate's deltas,
    occupancy and degradation from the replicas' health: the same signal
    vectors over the same stub fleet."""
    port, want = _signal_seq("port", clock), _signal_seq("jax", clock)
    assert port == want
    assert port[0]["warmed_up"] is False and port[1]["arrival_rps"] == 90.0 and port[2]["occupancy"] == 1.0


def _scale_cycle(pkg):
    """A flood (every queue full) then idle, through the router's monitor
    at 20 ms beats: the autoscaler's actions and the fleet sizes seen."""
    router = _stub_router(pkg, names=("r0",), heartbeat_interval_s=0.02)
    router.start()
    mod = MODULES[pkg]
    scaler = mod.Autoscaler(router, mod.AutoscaleConfig(
        min_replicas=1, max_replicas=2, eval_interval_s=0.05, up_after=2, down_after=2, cooldown_s=0.2))
    sizes = []
    try:
        for want, depth in ((2, 8), (1, 0)):
            deadline = time.monotonic() + 10.0
            while len(router.replicas) != want and time.monotonic() < deadline:
                for rep in router.replicas:
                    if rep.engine is not None:
                        rep.engine.queue_depth = depth
                time.sleep(0.01)
            sizes.append(len(router.replicas))
        snap = scaler.snapshot()
        events = [(e["kind"], e["replica"]) for e in router.recorder.events() if e["kind"].startswith("scale")]
        explain = scaler.explain()
    finally:
        router.close()
    return sizes, [(a["action"], a["replica_count"]) for a in snap["actions"]], events, sorted(explain[-1])


def test_flood_scales_up_then_idle_scales_down_like_jax():
    """1 -> 2 under the flood, 2 -> 1 when idle, in both tiers: the same
    actions, scale events and ``explain()`` record keys."""
    port, want = _scale_cycle("port"), _scale_cycle("jax")
    assert port[0] == want[0] == [2, 1]
    assert port[1] == want[1] == [("up", 1), ("down", 2)]
    assert port[2] == want[2] == [("scale_up", "r1"), ("scale_down", "r1")]
    assert port[3] == want[3]


def test_autoscaler_frees_with_its_router():
    """The autoscaler holds its router weakly: a closed router and its
    autoscaler are freed at once with the collector off; a dangling
    autoscaler says so."""
    router = _stub_router("port", heartbeat_interval_s=60.0).start()
    scaler = port_autoscale.Autoscaler(router)
    assert router.stats()["autoscaler"]["attached"] is True
    gc.disable()
    try:
        router.close()
        ref = weakref.ref(router)
        del router
        assert ref() is None
        with pytest.raises(ReferenceError):
            scaler.signals()
    finally:
        gc.enable()


# -- F7 and R4 -------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    """The tiny model of ``tests/test_torch_serve.py`` with seeded weights
    (the teardown and logging checks need no JAX counterpart)."""
    torch.manual_seed(0)
    return rt.build_raft(rt.RAFT_SMALL.replace(corr_radius=3, **TINY), device="cpu")


@pytest.mark.parametrize("cap", [3, 0], ids=["pool", "whole-request"])
def test_stopped_engine_is_freed_without_a_collection(model, cap):
    """With the collector off: start an engine, serve one request, fail one
    (its deadline expires; the stored error reaches the caller), stop and
    drop it. Weakrefs to it, its metrics registry, recorder, alert engine,
    ledger, queue and pools are dead at once; its stats, health and
    Prometheus text still answer after stop()."""
    rng = np.random.default_rng(40)
    gc.disable()
    try:
        eng = ServeEngine(model, _config(pool_capacity=cap), device="cpu").start()
        res = eng.submit(_image(rng), _image(rng))
        with pytest.raises(DeadlineExceeded):
            eng.submit(_image(rng), _image(rng), deadline_ms=1e-3)
        eng.stop()
        eng.stop()  # idempotent
        assert eng.stats()["completed"] == 1 and not eng.health()["healthy"]
        assert 'serve_counters{key="completed"} 1' in eng.prometheus() and eng.alerts()["active"] == []
        # the engine and the observability objects that point at each other
        refs = [weakref.ref(x) for x in (eng, eng.metrics, eng.recorder, eng._alerts, eng.ledger, eng._queue,
                                         *eng._pools.values())]
        del eng
        assert [r() for r in refs] == [None] * len(refs) and res.flow is not None
    finally:
        gc.enable()


def test_log_every_batches_zero_logs_once_at_stop(model, tmp_path):
    """R4: at ``log_every_batches=0`` with a logger the worker serves (the
    JAX engine's ``step % 0`` raises in its loop) and the counters go to
    the logger once, at stop()."""
    rng = np.random.default_rng(41)
    logger = MetricLogger(str(tmp_path))
    with ServeEngine(model, _config(log_every_batches=0), device="cpu", logger=logger) as eng:
        results = [eng.submit(_image(rng), _image(rng)) for _ in range(3)]
        assert eng.health()["healthy"] and not (tmp_path / "scalars.jsonl").read_text()
    logger.close()
    lines = [json.loads(x) for x in (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert all(r.flow is not None for r in results)
    assert len(lines) == 1 and lines[0]["serve/completed"] == 3.0 and lines[0]["serve/worker_errors"] == 0.0


def test_stub_engine_matches_both_packages_errors():
    """The stub raises each package's own typed errors (the routers
    classify by their own classes)."""
    for pkg, p in PKGS.items():
        eng = StubEngine(pkg, "r0", {("r0", 1): "shed"}).start()
        with pytest.raises(p.errors.Overloaded):
            eng.submit(1, 1)
        eng.close()
        with pytest.raises(p.errors.EngineStopped):
            eng.submit(0, 0)
