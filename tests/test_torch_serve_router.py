"""The port's in-process serving tier (replica, router, fault seams) against
the JAX package's, on the CPU.

The JAX router, replica and autoscaler duck-type their engine, so both
packages' tiers run over the same pure-Python ``StubEngine`` of
``tests/torch_worker_factories.py`` (no XLA compile): each stub raises its
own package's typed errors and follows a script keyed on the replica and
the request's label, so a submission sequence meets the same sheds and
faults in both tiers. With the monitor's heartbeat at 60 s
the dispatch scores move only by sheds, and the picks are deterministic.

Then two of the port's engines at ``tests/test_torch_serve.py``'s tiny CPU
config behind a router: the routed flows against ``RAFT.forward`` (1e-5,
oneDNN off, as that file) and the JAX ``model.apply`` (1e-3); a replica
declared dead under a burst (re-routed, none lost); a draining restart
under load (none dropped; a stream keeps its home or re-primes).
"""

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("raft_tpu")

import jax  # noqa: E402
from test_torch_serve import HW, _config, _image, _nchw, _nhwc, _padded, no_onednn, tiny  # noqa: E402,F401
from torch_worker_factories import StubEngine  # noqa: E402

from raft_tpu.serve import errors as jax_errors  # noqa: E402
from raft_tpu.serve import replica as jax_replica  # noqa: E402
from raft_tpu.serve import router as jax_router  # noqa: E402
from raft_tpu.utils.faults import FaultInjector as JaxFaultInjector  # noqa: E402

from raft_tpu_torch.obs import validate_bundle  # noqa: E402
from raft_tpu_torch.serve import (  # noqa: E402
    ConsistentHashRing,
    Overloaded,
    Replica,
    ReplicaState,
    RouterConfig,
    ServeEngine,
    ServeError,
    ServeRouter,
)
from raft_tpu_torch.serve import errors as port_errors  # noqa: E402
from raft_tpu_torch.serve import replica as port_replica  # noqa: E402
from raft_tpu_torch.serve import router as port_router  # noqa: E402
from raft_tpu_torch.utils.faults import FaultInjector  # noqa: E402

torch.set_num_threads(2)

PKGS = {
    "jax": SimpleNamespace(router=jax_router, replica=jax_replica, errors=jax_errors, faults=JaxFaultInjector),
    "port": SimpleNamespace(router=port_router, replica=port_replica, errors=port_errors, faults=FaultInjector),
}
QUIET = dict(heartbeat_interval_s=60.0)  # no beat during a scripted sequence


def _stub_router(pkg, names=("r0", "r1", "r2"), script=None, built=None, **cfg):
    """A router of ``pkg`` over stub replicas; ``built`` collects every
    engine the factories build."""
    p = PKGS[pkg]

    def factory_for(name):
        def factory(**overrides):
            eng = StubEngine(pkg, name, script, **overrides)
            if built is not None:
                built.append(eng)
            return eng
        return factory

    reps = [p.replica.Replica(n, factory_for(n), error_window=4) for n in names]
    return p.router.ServeRouter(reps, p.router.RouterConfig(**cfg))


def _outcome(call):
    try:
        res = call()
    except Exception as e:  # noqa: BLE001 -- the outcome is the error's type
        return (type(e).__name__, getattr(e, "retry_after_ms", None))
    return (res.replica, res.primed)


# -- the ring and the configs --------------------------------------------------


@pytest.mark.parametrize("vnodes", [64, 7])
def test_ring_matches_jax_key_for_key(vnodes):
    """1000 seeded keys map to the same member in both rings over the same
    member sets; removing a member remaps only its own keys, and re-adding
    it restores the mapping."""
    keys = [str(k) for k in np.random.default_rng(0).integers(0, 2**40, 1000)]
    rings = [ConsistentHashRing(vnodes), jax_router.ConsistentHashRing(vnodes)]
    for ring in rings:
        for m in ("r0", "r1", "r2", "r3"):
            ring.add(m)
    before = [[ring.lookup(k) for k in keys] for ring in rings]
    for ring in rings:
        ring.remove("r2")
    after = [[ring.lookup(k) for k in keys] for ring in rings]
    assert before[0] == before[1] and after[0] == after[1]
    assert rings[0].members() == rings[1].members() == {"r0", "r1", "r3"}
    assert all(b == a or b == "r2" for b, a in zip(before[0], after[0]))
    assert sum(b == "r2" for b in before[0]) > 100
    rings[0].add("r2")
    assert [rings[0].lookup(k) for k in keys] == before[0]
    assert ConsistentHashRing(vnodes).lookup("x") is None


CONFIG_CASES = [
    ("router", {}), ("router", dict(virtual_nodes=0)), ("router", dict(heartbeat_interval_s=0)),
    ("router", dict(heartbeat_timeout_s=-1)), ("router", dict(error_rate_budget=0.0)),
    ("router", dict(error_rate_budget=1.5)), ("router", dict(error_window=0)),
    ("router", dict(watchdog_trip_budget=0)), ("router", dict(cooldown_s=-0.1)), ("router", dict(max_attempts=0)),
    ("router", dict(alert_short_window_s=10.0, alert_long_window_s=5.0)),
    ("autoscale", {}), ("autoscale", dict(min_replicas=0)), ("autoscale", dict(min_replicas=3, max_replicas=2)),
    ("autoscale", dict(eval_interval_s=0)), ("autoscale", dict(up_shed_rate=1.5)),
    ("autoscale", dict(up_slo_miss_rate=-0.1)), ("autoscale", dict(up_degraded_level=-1.0)),
    ("autoscale", dict(up_degraded_level=None)), ("autoscale", dict(down_occupancy=0.8, up_occupancy=0.7)),
    ("autoscale", dict(up_after=0)), ("autoscale", dict(cooldown_s=-1.0)),
]


@pytest.mark.parametrize("which,kw", CONFIG_CASES, ids=[f"{w}-{'-'.join(k) or 'defaults'}" for w, k in CONFIG_CASES])
def test_config_validation_equal(which, kw):
    """``RouterConfig`` and ``AutoscaleConfig`` accept and refuse the same
    knobs as JAX's, with the same messages; accepted ones hold the same
    values."""
    from raft_tpu.serve import autoscale as jax_autoscale

    from raft_tpu_torch.serve import autoscale as port_autoscale

    cls = {"router": (port_router.RouterConfig, jax_router.RouterConfig),
           "autoscale": (port_autoscale.AutoscaleConfig, jax_autoscale.AutoscaleConfig)}[which]
    out = []
    for c in cls:
        try:
            out.append(dataclasses.asdict(c(**kw)))
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


# -- the replica ---------------------------------------------------------------


def _replica_trace(pkg):
    """A replica's lifecycle over a stub factory, snapshot after each step
    (clock fields dropped)."""
    p = PKGS[pkg]
    built = []

    def factory(**overrides):
        built.append(StubEngine(pkg, "r0", variables_hash=f"h{len(built)}", **overrides))
        return built[-1]

    rep = p.replica.Replica("r0", factory, error_window=3)
    snaps = []

    def snap():
        s = rep.snapshot()
        snaps.append({k: v for k, v in s.items() if k not in ("heartbeat_age_s", "cooldown_remaining_s")})

    snap()
    rep.start()
    snap()
    rep.note_ok()
    rep.note_error()
    rep.note_deadline_miss()
    rep.note_shed("interactive")
    rep.note_shed()
    snaps.append((rep.error_rate(), rep.window_full(), rep.trip_delta(2), rep.trip_delta(3), rep.trip_delta(1)))
    rep.note_error()
    snaps.append((rep.error_rate(), rep.window_full(), rep.score_base))
    snap()
    rep.stop_engine(graceful=True)
    rep.start(ladder=(2,))
    snap()
    snaps.append((built[0].running, built[1].running, built[1].overrides, rep.supports_init_flow))
    return snaps


def test_replica_state_machine_matches_jax():
    """Build, boot, outcomes, error window, trip baseline, shed score,
    teardown and a rebuild with overrides: the same snapshots."""
    assert _replica_trace("port") == _replica_trace("jax")


@pytest.mark.parametrize("backend", ["process", "remote"])
def test_unported_backends_name_their_item(backend):
    """``backend='remote'`` raises naming ROADMAP item 4b-ii, in the replica
    and the router. ``'process'`` is ported (item 4b-i): its replica builds
    an unstarted worker client with the worker options, and the router's
    replicas carry both. An unknown backend is a ``ValueError``."""
    factory = partial(StubEngine, "port", "r0")
    if backend == "remote":
        with pytest.raises(NotImplementedError, match="item 4b-ii"):
            Replica("r0", factory, backend=backend)
        with pytest.raises(NotImplementedError, match="item 4b-ii"):
            ServeRouter.from_factory(factory, 2, backend=backend)
    else:
        rep = Replica("r0", factory, backend=backend, worker_options=dict(ring_slots=2))
        eng = rep.build()
        assert type(eng).__name__ == "ProcessEngineClient" and eng.pid is None and eng._ring_slots == 2
        assert rep.snapshot()["backend"] == "process" and rep.snapshot()["pid"] is None
        router = ServeRouter.from_factory(factory, 2, backend=backend, worker_options=dict(ring_slots=2))
        assert [(r.backend, r.worker_options) for r in router.replicas] == [("process", dict(ring_slots=2))] * 2
    with pytest.raises(ValueError, match="backend must be"):
        Replica("r0", factory, backend="threads")


def test_unported_router_entry_points_raise():
    """The remote entry points raise, naming their ROADMAP item (4b-ii): a
    remote replica, and a remote rollout candidate; no candidate was
    booted, and the rollout block reads inactive, as JAX's does with no
    candidate. (A process candidate is ported: tests/test_torch_serve_worker.py.)"""
    router = _stub_router("port", **QUIET).start()
    try:
        with pytest.raises(NotImplementedError, match="item 4b-ii"):
            router.add_remote_replica("localhost:1")
        for kw in (dict(backend="remote"), dict(backend="remote", worker_options={})):
            with pytest.raises(NotImplementedError, match="item 4b-ii"):
                router.add_candidate(**kw)
        assert router.rollout is None and not router._rollout_pending
        assert router.stats()["rollout"] == {"active": False}
        assert 'router_rollout_active 0' in router.prometheus()
    finally:
        router.close()


# -- the routers over stub engines ---------------------------------------------


SCRIPT = {
    ("r0", 1): "shed", ("r0", 2): "shed", ("r1", 2): "shed", ("r2", 2): "shed",   # 2: every replica sheds
    ("r1", 4): "fault", ("r0", 5): "poison", ("r2", 7): "shed", ("r0", 8): "fault",
    ("r1", 11): "shed", ("r2", 11): "fault", ("r0", 11): "shed",                  # 11: sheds + a fault
}


def _pick_sequence(pkg):
    router = _stub_router(pkg, script=SCRIPT, **QUIET).start()
    try:
        out = []
        for k in range(16):
            out.append(_outcome(partial(router.submit, k, k)))
            sid = k % 3
            if k % 2:
                out.append(_outcome(partial(router.submit_frame, sid, k)))
        router.close_stream(0)
        out.append(_outcome(partial(router.submit_frame, 0, 99)))
        st = router.stats()
        out.append(st["router"])
        out.append({rid: {k: s[k] for k in ("dispatched", "errors", "sheds_by_class", "state")}
                    for rid, s in st["replicas"].items()})
        out.append(st["qos"]["shed_all_replicas"])
        return out
    finally:
        router.close()


def test_router_picks_match_jax():
    """One submission sequence (pairs and stream frames) meets the same
    scripted sheds, faults and poisons in both tiers: the same replica
    serves each request, the same errors reach the caller (an all-shed
    carrying the smallest retry hint, a poison never re-routed), and the
    counters agree."""
    port, want = _pick_sequence("port"), _pick_sequence("jax")
    assert port == want
    assert ("Overloaded", 10.0 * 2) in port and ("PoisonedInput", None) in port


def _evict_events(pkg, fault):
    """Replica r1 is declared dead (or its probe stalls) on its first
    heartbeat; the monitor, at 20 ms, evicts it and readmits it after the
    cooldown with a rebuilt engine. Returns the lifecycle events."""
    p = PKGS[pkg]
    built = []
    router = _stub_router(pkg, names=("r0", "r1"), built=built, heartbeat_interval_s=0.02,
                          heartbeat_timeout_s=0.1, cooldown_s=0.1)
    inj = p.faults()
    action = p.faults.replica_dead if fault == "dead" else 0.3
    fired = []
    inj.on("router.heartbeat", when=lambda i, c: c["replica"] == "r1" and not fired and not fired.append(i),
           action=action)
    router.start()
    try:
        with inj.patch_router(router):
            deadline = time.monotonic() + 10.0
            while router.stats()["router"]["readmissions"] < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
        if pkg == "port":  # the seams restored by deleting the instance attributes
            assert "_probe_health" not in vars(router) and "_before_dispatch" not in vars(router)
        res = router.submit(0, 0)
        events = [(e["kind"], e.get("replica"), e.get("reason"), e.get("rebuilt"), e.get("generation"))
                  for e in router.recorder.events() if e["kind"] in ("evict", "readmit", "heartbeat_miss")]
        st = router.stats()
        return events, st["router"]["evictions"], st["obs"]["postmortem_dumps"], len(built), res.replica
    finally:
        router.close()


@pytest.mark.parametrize("fault", ["dead", "stall"])
def test_evict_readmit_sequence_matches_jax(fault):
    port, want = _evict_events("port", fault), _evict_events("jax", fault)
    assert port == want
    kinds = [e[:2] for e in port[0]]
    assert ("evict", "r1") in kinds and kinds[-1] == ("readmit", "r1")
    assert port[0][-1][3:] == (True, 2)  # rebuilt through the factory: generation 2
    assert port[1:4] == (1, 1, 3)


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) and k not in ("engines",) else None for k, v in d.items()}


def test_stats_and_health_keys_match_jax():
    """``stats()`` and ``health()`` have JAX's key sets, recursively, over
    the same stub fleet after the same traffic. (JAX's ``rollout`` block
    is ``{"active": False}`` with no candidate, as the port's always is:
    no key is left out.)"""
    out = []
    for pkg in ("port", "jax"):
        router = _stub_router(pkg, script=SCRIPT, **QUIET).start()
        try:
            for k in range(4):
                _outcome(partial(router.submit, k, k))
            out.append((_keys(router.stats()), _keys(router.health())))
        finally:
            router.close()
    assert out[0] == out[1]


def test_postmortem_bundle_and_prometheus():
    """An operator bundle validates; the scrape carries the router's series
    and each replica's, labelled ``replica=``."""
    router = _stub_router("port", **QUIET).start()
    try:
        router.submit(0, 0)
        bundle = router.dump_postmortem("operator")
        text = router.prometheus()
    finally:
        router.close()
    assert validate_bundle(bundle) == []
    assert set(bundle["extra"]["replicas"]) == {"r0", "r1", "r2"}
    assert 'router_counters{key="routed"} 1' in text and "router_healthy_count 3" in text
    assert sum(f'replica="r{i}"' in text for i in range(3)) == 3


# -- two of the port's engines behind the router --------------------------------


def _engine_router(tiny, n=2, cooldown_s=0.1, **cfg_kw):
    cfg = _config(**cfg_kw)
    built = []

    def factory(**overrides):
        built.append(ServeEngine(tiny[2], dataclasses.replace(cfg, **overrides), device="cpu"))
        return built[-1]

    router = ServeRouter.from_factory(factory, n, RouterConfig(heartbeat_interval_s=0.02, cooldown_s=cooldown_s))
    return router, built


def test_routed_flows_match_model_and_jax(tiny, no_onednn):
    """4 pairs from 4 threads through a 2-replica router: each flow equals
    the port's RAFT.forward and the JAX model.apply of the same padded
    pair; both replicas served."""
    jm, variables, pm = tiny
    rng = np.random.default_rng(30)
    pairs = [(_image(rng), _image(rng)) for _ in range(4)]
    router, _ = _engine_router(tiny)
    with router, ThreadPoolExecutor(4) as ex:
        results = list(ex.map(lambda p: router.submit(*p), pairs))
        served = {rid: e["completed"] for rid, e in router.stats()["engines"].items()}
    assert sorted(served) == ["r0", "r1"] and sum(served.values()) == 4
    p1 = np.concatenate([_padded(a) for a, _ in pairs])
    p2 = np.concatenate([_padded(b) for _, b in pairs])
    jwant = np.asarray(jax.jit(partial(jm.apply, train=False, emit_all=False, num_flow_updates=3))(variables, p1, p2))
    with torch.inference_mode():
        want = _nhwc(pm(_nchw(p1), _nchw(p2), num_flow_updates=3, emit_all=False))
    for j, res in enumerate(results):
        assert res.num_flow_updates == 3
        np.testing.assert_allclose(res.flow, want[j, : HW[0], : HW[1]], rtol=0, atol=1e-5)
        np.testing.assert_allclose(res.flow, jwant[j, : HW[0], : HW[1]], rtol=0, atol=1e-3)


def _slow_model(tiny, s):
    return tiny[2].update_block.register_forward_hook(lambda mod, inp, out: time.sleep(s))


def test_replica_dead_under_a_burst_reroutes_none_lost(tiny):
    """While 8 requests are in flight, ``replica_dead`` declares r1 dead on
    a probe that sees it busy: it is evicted (one bundle), its requests
    fail EngineStopped inside it and are re-routed, every accepted request
    ends with a flow, and readmission builds a fresh engine."""
    rng = np.random.default_rng(31)
    pairs = [(_image(rng), _image(rng)) for _ in range(8)]
    router, built = _engine_router(tiny, cooldown_s=0.2)
    inj = FaultInjector()
    inj.on("router.heartbeat", when=lambda i, c: (c["replica"] == "r1" and router._by_id["r1"].inflight > 0
                                                  and not inj.fired["router.heartbeat"]),
           action=FaultInjector.replica_dead)
    handle = _slow_model(tiny, 0.02)
    try:
        with router, inj.patch_router(router), ThreadPoolExecutor(8) as ex:
            results = list(ex.map(lambda p: router.submit(*p), pairs))
            deadline = time.monotonic() + 10.0
            while router.stats()["router"]["readmissions"] < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            st = router.stats()
            bundles = [b for b in router.recorder.bundles() if b["reason"] == "evict:r1"]
    finally:
        handle.remove()
    assert len(results) == 8 and all(r.flow.shape == HW + (2,) and np.isfinite(r.flow).all() for r in results)
    assert st["router"]["evictions"] == 1 and st["router"]["readmissions"] == 1
    assert st["router"]["rerouted"] >= 1 and st["router"]["completed"] == 8
    assert len(bundles) == 1 and validate_bundle(bundles[0]) == []
    assert len(built) == 3 and st["replicas"]["r1"]["generation"] == 2
    assert not built[-1] is built[1] and built[1]._stop.is_set()


def test_draining_restart_under_load_drops_none(tiny):
    """``restart_replica`` under a burst drops no accepted request (queued
    ones re-route as ``Draining``); a stream homed on the restarted
    replica keeps its home or re-primes, then serves flow; the weights
    listener fires with the new generation and the fleet's weights hash
    holds."""
    rng = np.random.default_rng(32)
    router, built = _engine_router(tiny)
    fired = []
    handle = _slow_model(tiny, 0.01)
    try:
        with router, ThreadPoolExecutor(6) as ex:
            router.add_weights_listener(lambda **kw: fired.append(kw))
            h0 = router.variables_hash
            stream = router.open_stream()
            first = stream.submit(_image(rng))
            home = router._stream_homes[stream.stream_id]
            futs = [ex.submit(router.submit, _image(rng), _image(rng)) for _ in range(6)]
            router.restart_replica(home)
            results = [f.result(timeout=60) for f in futs]
            after = [stream.submit(_image(rng)) for _ in range(2)]
            st = router.stats()
    finally:
        handle.remove()
    assert first.primed and all(np.isfinite(r.flow).all() for r in results) and len(results) == 6
    assert after[-1].flow.shape == HW + (2,) and not after[-1].primed
    assert after[0].primed or after[0].flow is not None
    assert st["router"]["restarts"] == 1 and st["router"]["completed"] == 9
    assert fired == [dict(replica_id=home, generation=2)] and router.variables_hash == h0 is not None
    assert len(built) == 3 and st["replicas"][home]["state"] == ReplicaState.HEALTHY


def test_stream_affinity_one_home(tiny):
    """Every frame of a routed stream lands on its ring home; the home's
    encoder cache hits after the prime; a closed stream leaves no cached
    state."""
    rng = np.random.default_rng(33)
    router, _ = _engine_router(tiny, n=2)
    with router:
        with router.open_stream() as stream:
            res = [stream.submit(_image(rng)) for _ in range(3)]
            home = router._stream_homes[stream.stream_id]
        st = router.stats()
        cached = {rid: len(rep.engine._streams) for rid, rep in router._by_id.items()}
    assert res[0].primed and all(r.flow.shape == HW + (2,) for r in res[1:])
    assert st["engines"][home]["completed"] == 3 and st["router"]["stream_remaps"] == 0
    assert st["engines"][home]["encode_cache_hits"] >= 2
    assert cached == {"r0": 0, "r1": 0}


def test_all_replicas_shed_is_overloaded_and_closed_router_frees_engines(tiny):
    """A router whose replicas are all stopped under it answers
    ``Overloaded`` (no healthy replica) once they are evicted; after
    ``close()`` nothing holds the router or its engines (no reference
    cycle), with the collector off."""
    import gc
    import weakref

    router, built = _engine_router(tiny, cooldown_s=60.0)
    router.start()
    for rep in router.replicas:
        rep.engine.stop()
    with pytest.raises(ServeError):
        router.submit(_image(np.random.default_rng(34)), _image(np.random.default_rng(35)))
    with pytest.raises(Overloaded, match="no healthy replica"):
        router.submit(_image(np.random.default_rng(34)), _image(np.random.default_rng(35)))
    gc.disable()
    try:
        router.close()
        refs = [weakref.ref(router)] + [weakref.ref(e) for e in built]
        del router, built, rep
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()
