"""The port's guarded rollout (``serve/rollout.py``, the router's canary pick
and mirror, the engines' ``shadow=`` seam) against the JAX package's, on the
CPU.

The units first: ``RolloutConfig`` validation, ``_every``, ``_flow_diff`` on
seeded flows and ``_DiffGate.evaluate()`` over one scripted sample
sequence under one fake clock, each equal in both packages. Then the whole
ladder in both tiers over ``tests/test_torch_serve_router.py``'s
``StubEngine``: every stage is driven by hand (hold times 0, the gate on a
fake clock, the monitor's heartbeat at 60 s), and the only waits are for the
mirror queue to drain. Then the ``shadow=`` seam of the port's engine in
both modes against the JAX engine's counters for the same submissions, and
one real ladder over two of the port's tiny engines (flows within 1e-5 of
``RAFT.forward``, oneDNN off, as ``tests/test_torch_serve.py``), with the
candidate's engine freed by reference counting alone after promotion,
rollback and ``close()``.
"""

import copy
import dataclasses
import gc
import threading
import time
import weakref
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("raft_tpu")

from test_torch_serve import BUCKET, HW, _config, _image, _nchw, _nhwc, _padded, no_onednn, tiny  # noqa: E402,F401
from test_torch_serve_router import PKGS, QUIET, _outcome, _stub_router  # noqa: E402
from torch_worker_factories import StubEngine  # noqa: E402

from raft_tpu.serve import ServeConfig as JaxServeConfig  # noqa: E402
from raft_tpu.serve import ServeEngine as JaxServeEngine  # noqa: E402
from raft_tpu.serve import rollout as jax_rollout  # noqa: E402

from raft_tpu_torch.obs import validate_bundle  # noqa: E402
from raft_tpu_torch.serve import (  # noqa: E402
    RolloutAborted,
    RolloutStage,
    RouterConfig,
    ServeEngine,
    ServeRouter,
)
from raft_tpu_torch.serve import rollout as port_rollout  # noqa: E402

torch.set_num_threads(2)

ROLLOUT = {"jax": jax_rollout, "port": port_rollout}
# the ladder's own knobs for a scripted run: every mirror and every other
# pair a canary, a floor of 2 samples, no hold; latency and iterations are
# not what the stubs exercise
LADDER = dict(mirror_fraction=1.0, canary_fraction=0.5, min_samples=2, shadow_hold_s=0.0, canary_hold_s=0.0,
              short_window_s=1.0, long_window_s=10.0, latency_ratio=1000.0, iters_delta=1000.0)


def _rollout_config(pkg, **kw):
    return ROLLOUT[pkg].RolloutConfig(**dict(LADDER, **kw))


def _drain(ctrl, timeout_s=30.0):
    """Wait until the mirror lane has served what was queued: the gate holds
    one sample per mirror admitted (every request at ``mirror_fraction``
    1.0, less the sheds) and one per canary outcome."""
    router = ctrl.router
    t0 = time.monotonic()
    while len(ctrl.gate._ring) < ctrl._mirror_seq - router._counters["mirror_shed"] + ctrl.canary_routed:
        assert time.monotonic() - t0 < timeout_s, "the mirror queue did not drain"
        time.sleep(0.002)


def _clean_snapshot(snap):
    """A ladder snapshot without its clock readings."""
    out = dict(snap, stage_history=[{k: v for k, v in h.items() if k != "t_s"} for h in snap["stage_history"]])
    out["candidate"] = {k: v for k, v in snap["candidate"].items()
                        if k not in ("heartbeat_age_s", "cooldown_remaining_s")}
    return out


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


# -- the units -----------------------------------------------------------------


CONFIG_CASES = [
    {}, dict(mirror_fraction=0.0), dict(mirror_fraction=1.5), dict(canary_fraction=0.0), dict(canary_fraction=2.0),
    dict(mirror_queue_depth=0), dict(min_samples=0), dict(short_window_s=0.0),
    dict(short_window_s=10.0, long_window_s=5.0), dict(flow_diff_mean_px=-1.0), dict(flow_diff_p99_px=0.0),
    dict(latency_ratio=0.0), dict(iters_delta=-2.0), dict(error_rate=0.0),
    dict(auto_promote=False, candidate_deadline_ms=250.0, mirror_fraction=1.0),
]


@pytest.mark.parametrize("kw", CONFIG_CASES, ids=["-".join(k) or "defaults" for k in CONFIG_CASES])
def test_rollout_config_validation_equal(kw):
    """``RolloutConfig`` accepts and refuses the same knobs in both
    packages, with the same messages; accepted ones hold the same values."""
    out = []
    for pkg in ("port", "jax"):
        try:
            out.append(dataclasses.asdict(ROLLOUT[pkg].RolloutConfig(**kw)))
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


def test_every_matches_jax():
    fractions = [1.0, 0.75, 0.5, 0.34, 0.25, 0.125, 0.1, 0.01, 1e-4]
    assert [port_rollout._every(f) for f in fractions] == [jax_rollout._every(f) for f in fractions]
    assert port_rollout._every(0.125) == 8


def _flows(case):
    rng = np.random.default_rng(40)
    a = rng.normal(0.0, 3.0, (64, 80, 2)).astype(np.float32)
    if case == "equal":
        return a, a.copy()
    if case == "shifted":
        return a, a + rng.normal(0.0, 0.5, a.shape).astype(np.float32) + np.float32([3.0, 4.0])
    if case == "shape":
        return a, a[:56]
    if case == "none":
        return None, a
    b = a.copy()
    b[16, 24, 1] = np.nan  # on the 1/8 grid
    return a, b


@pytest.mark.parametrize("case", ["equal", "shifted", "shape", "none", "nan"])
def test_flow_diff_matches_jax(case):
    """Equal flows differ by 0, a shifted flow by its subsampled endpoint
    error (mean and p99), and an incomparable pair (a shape mismatch, a
    missing or non-finite flow) gives None: the same in both packages."""
    live, cand = _flows(case)
    got, want = port_rollout._flow_diff(live, cand), jax_rollout._flow_diff(live, cand)
    assert got == want
    if case == "equal":
        assert got == (0.0, 0.0)
    elif case == "shifted":
        assert 4.0 < got[0] < got[1] < 8.0
    else:
        assert got is None


def _gate_trace(pkg):
    """One scripted sample sequence under one clock; the verdict after each
    step: below the floor, a short burst (the short window over, the long
    not: no breach), a sustained breach, errors, then the windows aging
    out."""
    t = [0.0]
    gate = ROLLOUT[pkg]._DiffGate(ROLLOUT[pkg].RolloutConfig(
        min_samples=4, short_window_s=1.0, long_window_s=30.0, flow_diff_mean_px=10.0, flow_diff_p99_px=10.0,
        error_rate=0.5), now=lambda: t[0])
    out = [gate.evaluate()]
    for i in range(3):
        t[0] = float(i)
        gate.add(flow_mean=99.0, flow_p99=99.0)
    out.append(gate.evaluate())  # over threshold, under the floor
    for i in range(40, 60):  # the first three age out of the long window
        t[0] = float(i)
        gate.add(flow_mean=0.0, flow_p99=0.0, lat_live_ms=10.0, lat_cand_ms=12.0, iters_live=8, iters_cand=9)
    out.append(gate.evaluate())
    t[0] = 60.0
    for _ in range(3):
        gate.add(flow_mean=50.0, flow_p99=50.0)
    out.append(gate.evaluate())  # the short window breaches, the long does not
    for i in range(40):
        t[0] = 61.0 + i
        gate.add(flow_mean=50.0, flow_p99=60.0)
    out.append(gate.evaluate())  # sustained: both windows
    for i in range(40):
        t[0] = 140.0 + 0.1 * i
        gate.add(error=True, lat_cand_ms=5.0)
    out.append(gate.evaluate())
    t[0] = 1000.0
    out.append(gate.evaluate())  # every sample aged out
    return out


def test_gate_evaluate_matches_jax():
    """``_DiffGate.evaluate()`` over one scripted sequence under one fake
    clock gives equal dicts in both packages: no verdict under the sample
    floor, a short burst rejected, a sustained breach, an error breach."""
    port, want = _gate_trace("port"), _gate_trace("jax")
    assert port == want
    assert [(v["ready"], v["breach"]) for v in port] == [
        (False, None), (False, None), (True, None), (True, None), (True, "flow_mean"), (True, "errors"),
        (False, None)]


# -- the ladder over stub engines, both tiers ------------------------------------


def _stub_candidate(pkg, case):
    """The candidate factory (None: the first replica's) and the ladder's
    knobs for each case."""
    if case == "perturbed":
        return (lambda **ov: StubEngine(pkg, "cand", flow=5.0, variables_hash="h-perturbed", **ov)), {}
    if case == "hash_mismatch":
        hashes = iter(["h-cand", "h-other", "h-third"])  # a factory whose weights move between calls
        return (lambda **ov: StubEngine(pkg, "cand", variables_hash=next(hashes), **ov)), {}
    if case == "crash":
        # label 5 is the first canary pick: it faults on the candidate and is
        # re-served by an incumbent; parked in canary until the crash
        return (lambda **ov: StubEngine(pkg, "cand", {("cand", 5): "fault"}, variables_hash="h-cand", **ov),
                dict(auto_promote=False, error_rate=1.0))
    return None, {}


def _stub_ladder(pkg, case):
    """A two-replica stub fleet walks one ladder; returns what the caller
    saw, the stages, the snapshot, the counters and the recorder's event
    kinds."""
    p = PKGS[pkg]
    factory, knobs = _stub_candidate(pkg, case)
    router = _stub_router(pkg, names=("r0", "r1"), **QUIET).start()
    try:
        ctrl = router.add_candidate(factory, rollout_config=_rollout_config(pkg, **knobs))
        ctrl.gate._now = lambda: 0.0
        with pytest.raises(p.errors.ServeError, match="already shadow"):
            router.add_candidate()  # one ladder at a time
        out = [_outcome(partial(router.submit, k, k)) for k in range(4)]
        _drain(ctrl)
        ctrl.maybe_observe()
        stage = ctrl.stage
        if stage == "canary":
            out += [_outcome(partial(router.submit, k, k)) for k in range(4, 8)]
            _drain(ctrl)
            if case == "crash":
                inj = p.faults()
                inj.on("router.heartbeat", when=lambda i, c: c["replica"] == "candidate", action=p.faults.replica_dead)
                with inj.patch_router(router):
                    if pkg == "port":
                        router._beat()
                    else:  # the JAX monitor's candidate beat, then its control beat
                        router._heartbeat(ctrl.candidate)
                        ctrl.maybe_observe()
                out.append(("candidate beats seen", inj.fired["router.heartbeat"]))
            else:
                ctrl.maybe_observe()
        try:
            end = ctrl.wait(timeout=30.0)["stage"]
        except Exception as e:  # noqa: BLE001 -- the outcome is the abort
            end = (type(e).__name__, e.stage, e.reason)
        out += [_outcome(partial(router.submit, k, k)) for k in range(8, 10)]  # after the ladder: none lost
        ctrl._mirror_thread.join(timeout=10.0)
        st = router.stats()
        return dict(
            outcomes=out, stage=stage, end=end, mirror_alive=ctrl._mirror_thread.is_alive(),
            snapshot=_clean_snapshot(st["rollout"]), keys=_keys(st["rollout"]), router=st["router"],
            replicas={rid: (s["generation"], s["variables_hash"]) for rid, s in st["replicas"].items()},
            engines={rid: {k: v for k, v in e.items() if k.startswith("shadow")} for rid, e in st["engines"].items()},
            kinds=[e["kind"] for e in router.recorder.events()],
            bundles=[b["reason"] for b in router.recorder.bundles()],
            candidate_engine=ctrl.candidate.engine is None,
        )
    finally:
        router.close()


@pytest.mark.parametrize("case", ["promote", "perturbed", "crash", "hash_mismatch"])
def test_stub_ladder_matches_jax(case):
    """The same traffic walks the same ladder in both tiers: the same
    replicas (or the candidate) serve each request, the same stages,
    snapshot (clock readings aside, key set included), router counters,
    generations and hashes, shadow counters and recorder event kinds.

    * promote: shadow -> canary -> promoting -> promoted; every replica
      rebuilt onto the candidate's hash; the candidate took real canary
      requests and the incumbents saw no shadow request;
    * perturbed: a candidate whose flow is 5 px off breaches ``flow_mean``
      in shadow and rolls back; no replica touched;
    * crash: ``replica_dead`` on the candidate's beat (the patched
      heartbeat sees the candidate) in canary gives ``candidate_crash``;
      the canary request the candidate failed was re-served by an
      incumbent, and nothing was lost;
    * hash_mismatch: a replica rebuilt by the candidate's factory comes
      back on another hash: ``promote_hash_mismatch``, and the replica is
      restored onto its own factory.
    """
    port, want = _stub_ladder("port", case), _stub_ladder("jax", case)
    port_cand, want_cand = port.pop("candidate_engine"), want.pop("candidate_engine")
    assert port == want
    assert port_cand  # the retired candidate let go of its engine (the JAX one keeps it)
    assert not port["mirror_alive"] and set(port["keys"]) == {
        "active", "stage", "abort_reason", "stage_history", "candidate", "overrides", "mirrored", "mirror_shed",
        "mirror_errors", "canary_routed", "canary_errors", "promoted_replicas", "rollbacks", "gate"}
    lost = [o for o in port["outcomes"] if isinstance(o, tuple) and o[0] in ("ServeError", "Overloaded")]
    assert not lost
    stages = [h["stage"] for h in port["snapshot"]["stage_history"]]
    if case == "promote":
        assert stages == ["shadow", "canary", "promoting", "promoted"] and port["end"] == "promoted"
        assert port["replicas"] == {"r0": (2, "h0"), "r1": (2, "h0")}
        assert port["router"]["canary_routed"] == 2 and port["snapshot"]["promoted_replicas"] == ["r0", "r1"]
        assert port["router"]["mirrored"] == 6 and all(v == 0 for e in port["engines"].values() for v in e.values())
        assert "rollout_promoted" in port["kinds"]
    elif case == "perturbed":
        assert stages == ["shadow", "rolled_back"] and port["end"] == ("RolloutAborted", "shadow", "flow_mean")
        assert port["snapshot"]["gate"]["long"]["flow_mean_px"] == pytest.approx(5.0 * np.sqrt(2.0), abs=1e-4)
        assert port["replicas"] == {"r0": (1, "h0"), "r1": (1, "h0")}
        assert "rollout_breach" in port["kinds"] and "rollout_rollback:flow_mean" in port["bundles"]
    elif case == "crash":
        assert stages == ["shadow", "canary", "rolled_back"]
        assert port["end"] == ("RolloutAborted", "canary", "candidate_crash")
        assert ("candidate beats seen", 1) in port["outcomes"] and port["router"]["evictions"] == 1
        assert port["outcomes"][5][0] in ("r0", "r1") and port["outcomes"][7] == ("cand", False)
        assert port["snapshot"]["canary_errors"] == 1 and port["router"]["rerouted"] == 1
        assert port["replicas"] == {"r0": (1, "h0"), "r1": (1, "h0")}
    else:
        assert stages == ["shadow", "canary", "promoting", "rolled_back"]
        assert port["end"] == ("RolloutAborted", "promoting", "promote_hash_mismatch")
        assert port["replicas"] == {"r0": (3, "h0"), "r1": (1, "h0")}
        assert port["snapshot"]["promoted_replicas"] == []


def _surfaces(pkg):
    """What an operator sees of a live ladder: the gauge, the candidate's
    series labelled ``replica="candidate"``, the stats block; a closed
    stream dropped on the candidate too (its mirrored frames left state
    there); the same after the ladder ends."""
    router = _stub_router(pkg, names=("r0",), **QUIET).start()
    try:
        ctrl = router.add_candidate(rollout_config=_rollout_config(pkg))
        stream = router.open_stream()
        frames = [_outcome(partial(stream.submit, k)) for k in range(3)]
        _drain(ctrl)
        cand_streams = set(ctrl.candidate.engine.streams)
        stream.close()
        live = (router.prometheus(), router.stats()["rollout"]["active"], cand_streams,
                set(ctrl.candidate.engine.streams))
        ctrl.shutdown()
        return frames, live, (router.prometheus(), router.stats()["rollout"]["active"])
    finally:
        router.close()


def test_router_surfaces_the_ladder():
    (frames, live, ended), want = _surfaces("port"), _surfaces("jax")
    assert frames == want[0] and live[1:] == want[1][1:] and ended[1] == want[2][1]
    assert live[1:] == (True, {0}, set()) and ended[1] is False
    assert "router_rollout_active 1" in live[0] and "router_rollout_active 0" in ended[0]
    assert 'serve_counters{replica="candidate",key="submitted"} 0' in live[0]
    # the candidate's series, line for line the JAX router's while the ladder
    # is live; once it ended, the port's candidate has let go of its engine
    # (the JAX one keeps its stopped engine and scrapes it)
    assert {ln for ln in live[0].splitlines() if "candidate" in ln} == {
        ln for ln in want[1][0].splitlines() if "candidate" in ln}
    assert 'replica="candidate"' not in ended[0] and 'replica="candidate"' in want[2][0]


def _mirror_shed(pkg):
    """A wedged mirror worker with a queue of one: every further mirror is
    shed at once on the caller's thread."""
    router = _stub_router(pkg, names=("r0",), **QUIET).start()
    try:
        ctrl = router.add_candidate(rollout_config=_rollout_config(pkg, mirror_queue_depth=1, min_samples=10**6))
        started, release = threading.Event(), threading.Event()

        def slow_fn(eng, deadline_ms, **kw):
            started.set()
            release.wait(10.0)
            return SimpleNamespace(flow=None, latency_ms=1.0, num_flow_updates=1)

        live = SimpleNamespace(flow=None, latency_ms=1.0, num_flow_updates=1, slow_path=False)
        ctrl.maybe_mirror("pair", slow_fn, live)
        assert started.wait(10.0)
        t0 = time.monotonic()
        for _ in range(16):
            ctrl.maybe_mirror("pair", slow_fn, live)
        elapsed = time.monotonic() - t0
        snap = ctrl.snapshot()
        release.set()
        return snap["stage"], snap["mirrored"], snap["mirror_shed"], router.stats()["router"]["mirror_shed"], elapsed
    finally:
        router.close()


def test_full_mirror_queue_sheds_matches_jax():
    port, want = _mirror_shed("port"), _mirror_shed("jax")
    assert port[:4] == want[:4] == ("shadow", 1, 15, 15)
    assert port[4] < 1.0


def test_second_candidate_refused_until_the_ladder_ends():
    """While a ladder runs (and while a candidate boots) a second
    ``add_candidate`` raises ``ServeError`` with JAX's message; once it
    ended, a new one starts; ``close()`` ends a live ladder as a rollback
    with the reason ``shutdown``."""
    msgs, ctrls = [], []
    for pkg in ("port", "jax"):
        router = _stub_router(pkg, names=("r0",), **QUIET).start()
        try:
            first = router.add_candidate(rollout_config=_rollout_config(pkg))
            try:
                router.add_candidate()
            except Exception as e:  # noqa: BLE001 -- compared by message
                msgs.append((type(e).__name__, str(e)))
            router._rollout_pending = True
            try:
                router.add_candidate()
            except Exception as e:  # noqa: BLE001
                msgs.append((type(e).__name__, str(e)))
            router._rollout_pending = False
            first.shutdown()
            second = router.add_candidate(rollout_config=_rollout_config(pkg))
            assert router.rollout is second and second.stage == "shadow"
        finally:
            router.close()
        with pytest.raises(Exception) as e:
            second.wait(timeout=5.0)
        ctrls.append((type(e.value).__name__, e.value.stage, e.value.reason, first.abort_reason))
    assert msgs[:2] == msgs[2:] and "already shadow" in msgs[0][1] and "already booting" in msgs[1][1]
    assert ctrls[0] == ctrls[1] == ("RolloutAborted", "shadow", "shutdown", "shutdown")


# -- the shadow seam of the engines -----------------------------------------------


SHADOW_KEYS = ("submitted", "completed", "shed", "expired", "shadow_submitted", "shadow_completed", "shadow_shed",
               "shadow_expired")
QUOTAS = (("t1", 0.001, 2, 8),)  # tenant t1: a burst of 2, refilled effectively never


def _shadow_script(eng, rng):
    """The counters, the QoS classes' counts and the tenants' refusals
    after each step: a shadow submit, a shadow submit of an interactive
    request, five shadow submits against t1's burst of 2, then t1's two
    live submits and a third one refused, then ``submit_many`` with a live
    and a shadow item."""
    out = []

    def snap(note=None):
        st = eng.stats()
        classes = {c: {k: v for k, v in d.items() if not k.endswith("_ms")} for c, d in st["qos"]["classes"].items()}
        out.append(({k: st[k] for k in SHADOW_KEYS}, classes,
                    {t: d["quota_refused"] for t, d in st["qos"]["tenants"].items()}, note))

    def pair():
        return _image(rng), _image(rng)

    snap()
    assert eng.submit(*pair(), shadow=True).flow.shape == HW + (2,)
    snap()
    eng.submit(*pair(), priority="interactive", shadow=True)
    snap()
    for _ in range(5):
        eng.submit(*pair(), tenant="t1", shadow=True)
    snap()
    for _ in range(2):
        eng.submit(*pair(), tenant="t1")
    try:
        eng.submit(*pair(), tenant="t1")
        refused = None
    except Exception as e:  # noqa: BLE001 -- compared by class name
        refused = type(e).__name__
    snap(refused)
    a, b = pair()
    handles = eng.submit_many([dict(image1=a, image2=b), dict(image1=b, image2=a, shadow=True)])
    snap([h.wait(30.0) and h.error is None for h in handles])
    return out


@pytest.fixture(scope="module")
def jax_shadow_script(tiny):
    jm, variables, _ = tiny
    # batches of one: one program compiled (the counters do not depend on batching)
    cfg = JaxServeConfig(buckets=(BUCKET,), ladder=(3, 2, 1), max_batch=1, pool_capacity=0, queue_capacity=8,
                         default_deadline_ms=30000.0, qos_enabled=True, qos_tenant_quotas=QUOTAS)
    with JaxServeEngine(jm, variables, cfg) as eng:
        return _shadow_script(eng, np.random.default_rng(41))


@pytest.mark.parametrize("mode", [dict(pool_capacity=3), dict(pool_capacity=0)], ids=["pool", "whole-request"])
def test_shadow_seam_counters_match_jax(tiny, jax_shadow_script, mode):
    """A shadow request moves only the ``shadow_*`` twins, charges no QoS
    class and takes no tenant token (five shadow submits leave t1's burst
    of 2 whole; the third live one is refused), and ``submit_many``'s
    ``shadow`` item counts as a shadow submit: step for step the JAX
    engine's counters, in both of the port's engine modes."""
    with ServeEngine(tiny[2], _config(qos_enabled=True, qos_tenant_quotas=QUOTAS, **mode), device="cpu") as eng:
        got = _shadow_script(eng, np.random.default_rng(41))
    assert got == jax_shadow_script
    assert got[-2][3] == "QuotaExceeded" and got[-1][3] == [True, True]
    assert got[-1][0] == dict(submitted=3, completed=3, shed=0, expired=0, shadow_submitted=8, shadow_completed=8,
                              shadow_shed=0, shadow_expired=0)


def test_shadow_frames_tiles_and_slow_path(tiny):
    """The seam on the other entry points: a shadow stream frame, a shadow
    tiled request (each tile a shadow request) and a shadow slow-path
    request move only the twins. (The JAX engine counts a shadow
    slow-path request as a live completion; the port keeps it in the
    twins, as every other shadow request.)"""
    cfg = _config(unknown_shape="slow_path")
    rng = np.random.default_rng(42)
    with ServeEngine(tiny[2], cfg, device="cpu") as eng:
        stream = eng.open_stream()
        frames = [eng.submit_frame(stream.stream_id, _image(rng), shadow=True) for _ in range(2)]
        tiled = eng.submit_tiled(_image(rng, (60, 100)), _image(rng, (60, 100)), shadow=True)
        slow = eng.submit(_image(rng, (50, 70)), _image(rng, (50, 70)), shadow=True)
        st = eng.stats()
    assert frames[0].primed and frames[1].flow.shape == HW + (2,)
    assert tiled.tiled and tiled.flow.shape == (60, 100, 2) and slow.slow_path and slow.flow.shape == (50, 70, 2)
    n = 2 + tiled.tiles + 1
    assert {k: st[k] for k in SHADOW_KEYS} == dict(submitted=0, completed=0, shed=0, expired=0, shadow_submitted=n,
                                                   shadow_completed=n, shadow_shed=0, shadow_expired=0)
    assert all(d["submitted"] == 0 for d in st["qos"]["classes"].values())


# -- a real ladder over the port's engines ------------------------------------------


def _engine_fleet(tiny):
    """Two tiny engines behind a router whose monitor never beats by
    itself (the test beats it); ``built`` holds a weakref to every engine
    the factory makes."""
    cfg = _config()
    built = []

    def factory(model=tiny[2], **overrides):
        eng = ServeEngine(model, dataclasses.replace(cfg, **overrides), device="cpu")
        built.append(weakref.ref(eng))
        return eng

    router = ServeRouter.from_factory(factory, 2, RouterConfig(**QUIET))
    return router, factory, built


def test_real_ladder_promotes_and_frees_the_candidate(tiny, no_onednn):
    """Two tiny engines and an identical candidate walk shadow -> canary ->
    promoted through the router's own monitor beat: every flow served
    (incumbents and canary alike) within 1e-5 of ``RAFT.forward`` of its
    padded pair, the gate's flow gap ~0, the mirrors in the candidate's
    twin counters only, every replica rebuilt onto the candidate's hash;
    with the collector off, the candidate's engine (and the replaced
    engines) are freed once the ladder ends."""
    pm = tiny[2]
    rng = np.random.default_rng(43)
    pairs = [(_image(rng), _image(rng)) for _ in range(7)]
    router, _, built = _engine_fleet(tiny)
    gc.disable()
    try:
        with router:
            ctrl = router.add_candidate(rollout_config=port_rollout.RolloutConfig(**LADDER))
            ctrl.gate._now = lambda: 0.0
            cand = weakref.ref(ctrl.candidate.engine)
            results = [router.submit(*p) for p in pairs[:3]]
            _drain(ctrl)
            router._beat()
            assert ctrl.stage == RolloutStage.CANARY
            results += [router.submit(*p) for p in pairs[3:]]
            _drain(ctrl)
            cand_stats = {k: cand().stats()[k] for k in ("submitted", "completed", "shadow_submitted",
                                                         "shadow_completed")}
            agg_shadow = router.stats()["aggregate"]["shadow_submitted"]
            router._beat()
            snap = ctrl.wait(timeout=60.0)
            cand_hash = ctrl.candidate.variables_hash
            st = router.stats()
            alive_in = [r() is not None for r in built]
        del router, ctrl  # closed: nothing else holds the fleet
        alive = [r() is not None for r in built]
    finally:
        gc.enable()
    p1 = np.concatenate([_padded(a) for a, _ in pairs])
    p2 = np.concatenate([_padded(b) for _, b in pairs])
    with torch.inference_mode():
        want = _nhwc(pm(_nchw(p1), _nchw(p2), num_flow_updates=3, emit_all=False))
    for j, res in enumerate(results):
        np.testing.assert_allclose(res.flow, want[j, : HW[0], : HW[1]], rtol=0, atol=1e-5)
    assert [h["stage"] for h in snap["stage_history"]] == ["shadow", "canary", "promoting", "promoted"]
    assert snap["canary_routed"] == 2 and snap["mirrored"] == 5 and snap["gate"]["long"]["flow_mean_px"] < 1e-4
    assert cand_stats == dict(submitted=2, completed=2, shadow_submitted=5, shadow_completed=5) and agg_shadow == 0
    assert {rid: (s["generation"], s["variables_hash"]) for rid, s in st["replicas"].items()} == {
        "r0": (2, cand_hash), "r1": (2, cand_hash)}
    # 2 first boots, the candidate, 2 promotion rebuilds: only the rebuilds live on
    assert len(built) == 5 and cand() is None and alive_in == [False, False, False, True, True]
    assert alive == [False] * 5


@pytest.mark.parametrize("end", ["rollback", "close"])
def test_candidate_freed_after_rollback_and_close(tiny, end):
    """A candidate whose flow head's last bias is offset by 0.1 (each of 3
    updates adds it on the 1/8 grid, the upsampling scales it by 8: a
    ~3 px gap) breaches ``flow_mean`` on the monitor's beat and rolls back
    (``wait()`` raises ``RolloutAborted``, a valid postmortem bundle holds
    the ``rollout_*`` events, no replica on its hash); or ``close()`` ends
    the ladder as a ``shutdown`` rollback. Either way, with the collector
    off, the candidate's engine is freed."""
    perturbed = copy.deepcopy(tiny[2])
    with torch.no_grad():
        perturbed.update_block.flow_head.conv2.bias.add_(0.1)
    rng = np.random.default_rng(44)
    router, factory, built = _engine_fleet(tiny)
    gc.disable()
    try:
        router.start()
        try:
            ctrl = router.add_candidate(partial(factory, model=perturbed),
                                        rollout_config=port_rollout.RolloutConfig(**LADDER))
            ctrl.gate._now = lambda: 0.0
            cand = weakref.ref(ctrl.candidate.engine)
            cand_hash = ctrl.candidate.variables_hash
            results = [router.submit(_image(rng), _image(rng)) for _ in range(3)]
            _drain(ctrl)
            if end == "rollback":
                router._beat()
                with pytest.raises(RolloutAborted) as e:
                    ctrl.wait(timeout=60.0)
                bundle = [b for b in router.recorder.bundles() if b["reason"] == "rollout_rollback:flow_mean"]
                kinds = [ev["kind"] for ev in bundle[0]["events"]]
                hashes = {s["variables_hash"] for s in router.stats()["replicas"].values()}
                gap = ctrl.snapshot()["gate"]["long"]["flow_mean_px"]
        finally:
            router.close()
        if end == "close":
            with pytest.raises(RolloutAborted) as e:
                ctrl.wait(timeout=10.0)
        alive = cand() is not None
    finally:
        gc.enable()
    assert all(r.flow.shape == HW + (2,) for r in results) and not alive and len(built) == 3
    assert e.value.stage == "shadow" and e.value.reason == ("flow_mean" if end == "rollback" else "shutdown")
    if end == "rollback":
        assert 1.0 < gap < 6.0 and validate_bundle(bundle[0]) == []
        assert {"rollout_candidate", "rollout_stage", "rollout_breach", "rollout_rollback"} <= set(kinds)
        assert cand_hash not in hashes and len(hashes) == 1
