"""The port's serving observability and device-deadline watchdog against
the JAX engine's, on the CPU.

The tiny model and weights of ``tests/test_torch_serve.py`` (its ``tiny``
fixture), bucket 48x64, in both engines (the pool and
``pool_capacity=0``):

  * an unstarted engine's ``stats()`` / ``health()`` key sets, blocks
    included, against an unstarted JAX engine's on the same weights, up
    to the differences stated in ``JAX_ONLY`` / ``PORT_ONLY``;
  * the trace span names of each mode (the JAX engine's span sites), each
    span inside its trace, the trace's duration beside the result's
    latency;
  * ``trace_ctx`` joining a trace born elsewhere (``submit``, a
    ``submit_many`` item on an engine that samples nothing);
  * the recorder events and the Prometheus QoS series;
  * a host-side stall injected through ``FaultInjector.patch_engine`` at
    ``apply_timeout_s=0.3``: the stalled dispatch's requests fail with
    ``DeadlineExceeded`` before the dispatch returns, the pool resets, a
    bundle valid under JAX's ``validate_bundle`` is dumped, the
    ``watchdog_trips`` page alert fires, and the next request is served.
"""

import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

pytest.importorskip("raft_tpu")

from test_torch_serve import BUCKET, HW, _config, _image, tiny  # noqa: E402,F401

from raft_tpu.obs.recorder import validate_bundle as jax_validate_bundle  # noqa: E402
from raft_tpu.serve import ServeConfig as JaxServeConfig  # noqa: E402
from raft_tpu.serve import ServeEngine as JaxServeEngine  # noqa: E402

from raft_tpu_torch.obs import TraceContext, Tracer  # noqa: E402
from raft_tpu_torch.serve import DeadlineExceeded, Overloaded, QuotaExceeded, ServeEngine  # noqa: E402
from raft_tpu_torch.utils.faults import FaultInjector  # noqa: E402
from raft_tpu_torch.utils.logging import MetricLogger  # noqa: E402

torch.set_num_threads(2)

MODES = {"pool": dict(pool_capacity=3), "whole-request": dict(pool_capacity=0)}

# stats() keys of the JAX engine the port does not have (none since the
# rollout's shadow_* counters were ported); the port's own: the graphs'
# kernel launches
JAX_ONLY = set()
PORT_ONLY = {"launches"}
# blocks whose keys must be equal; 'boot' differs by design (the port
# captures CUDA graphs, the JAX engine loads or compiles executables)
BLOCKS = ("obs", "alerts", "ledger", "degradation", "convergence", "pool", "tiler", "qos")

SPANS = {
    "pool": ["admit", "queue_wait", "batch_form", "dispatch", "refine", "fetch"],
    "whole-request": ["admit", "queue_wait", "batch_form", "dispatch", "fetch"],
}
STREAM_SPANS = {
    "pool": (["admit", "queue_wait", "encode"], ["admit", "queue_wait", "encode", "dispatch", "refine", "fetch"]),
    "whole-request": (["admit", "queue_wait", "batch_form", "encode"],
                      ["admit", "queue_wait", "batch_form", "encode", "dispatch", "fetch"]),
}


@pytest.mark.parametrize("mode", MODES)
def test_unstarted_key_sets_equal_jax(tiny, mode):
    jm, variables, pm = tiny
    kw = dict(buckets=(BUCKET,), ladder=(3, 2, 1), max_batch=4, **MODES[mode])
    port = ServeEngine(pm, _config(**MODES[mode]), device="cpu")
    jax_eng = JaxServeEngine(jm, variables, JaxServeConfig(**kw))
    got, want = port.stats(), jax_eng.stats()
    assert set(got) == (set(want) - JAX_ONLY) | PORT_ONLY
    for block in BLOCKS:
        assert set(got[block]) == set(want[block]), block
    assert set(port.health()) == set(jax_eng.health())
    assert got["obs"] == want["obs"] == {"trace_sample_rate": 0.0, "traces_started": 0, "traces_finished": 0,
                                         "events_recorded": 0, "postmortem_dumps": 0}
    assert got["alerts"] == want["alerts"]
    assert port.alerts() == jax_eng.alerts()
    assert port.health()["watchdog_trips"] == got["watchdog_trips"] == 0


def _check_trace(rec, res, names):
    assert rec is not None and rec["ok"] and rec["trace_id"] == res.trace_id
    assert [sp["name"] for sp in rec["spans"]] == names
    for sp in rec["spans"]:
        assert -1e-6 <= sp["t0_ms"] and sp["t0_ms"] + sp["dur_ms"] <= rec["dur_ms"] + 1e-6, sp
    assert abs(rec["dur_ms"] - res.latency_ms) < 50.0  # sealed at the request's finish
    assert rec["priority"] == "standard" and rec["tenant"] == "default"


@pytest.mark.parametrize("mode", MODES)
def test_span_names_and_trace_ctx(tiny, mode):
    """Every sampled pair and stream frame carries the JAX engine's span
    chain of its mode; ``trace_ctx`` stitches the engine's record into a
    live trace; a rate-0 engine adopts a propagated id."""
    rng = np.random.default_rng(21)
    with ServeEngine(tiny[2], _config(trace_sample_rate=1.0, **MODES[mode]), device="cpu") as eng:
        with ThreadPoolExecutor(3) as ex:
            results = list(ex.map(lambda _: eng.submit(_image(rng), _image(rng)), range(3)))
        for res in results:
            _check_trace(eng.tracer.find(res.trace_id), res, SPANS[mode])
            # a traced pool request carries its residual trajectory, one
            # value an update; the whole-request engine has none
            assert (res.residuals is None) == (mode == "whole-request")
            assert mode != "pool" or len(res.residuals) == res.num_flow_updates == 3
        with eng.open_stream() as stream:
            first, second = stream.submit(_image(rng)), stream.submit(_image(rng))
        for res, names in zip((first, second), STREAM_SPANS[mode]):
            _check_trace(eng.tracer.find(res.trace_id), res, names)
        edge = Tracer(1.0, prefix="edge").start("edge")
        joined = eng.submit(_image(rng), _image(rng), trace_ctx=TraceContext(edge.trace_id, edge))
        assert joined.trace_id == edge.trace_id
        rec = edge.finish()
        assert [sp["name"] for sp in rec["spans"]] == SPANS[mode]
        assert {sp["proc"] for sp in rec["spans"]} == {"engine"}
        stats = eng.stats()
        assert stats["obs"]["traces_started"] == stats["obs"]["traces_finished"] == 6
        assert eng.recorder.events("boot")
    with ServeEngine(tiny[2], _config(**MODES[mode]), device="cpu") as eng:
        (h,) = eng.submit_many([dict(image1=_image(rng), image2=_image(rng), trace_ctx=TraceContext("edge-1"))])
        assert h.wait(30.0) and h.error is None and h.result.trace_id == "edge-1"
        assert eng.tracer.find("edge-1")["spans"][0]["name"] == "admit"
        plain = eng.submit(_image(rng), _image(rng))
        assert plain.trace_id is None and eng.tracer.started == 1


@pytest.mark.parametrize("mode", MODES)
def test_device_deadline_trip(tiny, mode, tmp_path):
    """A dispatch stalled on the host past ``apply_timeout_s``: its
    requests fail with ``DeadlineExceeded`` from the watcher thread
    before the stall ends, the trip is counted and dumped, the pool
    resets, the ``watchdog_trips`` page alert fires, and the engine
    serves the next request."""
    stage = "pool_step" if mode == "pool" else "pair"
    stall = 1.2
    inj, armed = FaultInjector(), [False]
    inj.on("infer.slow_apply",
           when=lambda i, ctx: armed[0] and ctx["stage"] == stage and not inj.fired["infer.slow_apply"], action=stall)
    cfg = _config(apply_timeout_s=0.3, alert_short_window_s=2.0, alert_long_window_s=4.0, log_every_batches=1,
                  **MODES[mode])
    rng = np.random.default_rng(22)
    with ServeEngine(tiny[2], _config(**MODES[mode]), device="cpu") as warm:
        warm.submit(_image(rng), _image(rng))  # a cold process's first dispatches outlast 0.3 s
    logger = MetricLogger(str(tmp_path))
    with ServeEngine(tiny[2], cfg, device="cpu", logger=logger) as eng, inj.patch_engine(eng):
        eng.submit(_image(rng), _image(rng))
        time.sleep(0.1)  # the alert engine observes the engine before the trip
        armed[0] = True
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded, match="device execution exceeded 0.3s"):
            eng.submit(_image(rng), _image(rng))
        assert time.monotonic() - t0 < stall - 0.2  # failed before the stalled dispatch returned
        assert inj.fired["infer.slow_apply"] == 1
        res = eng.submit(_image(rng), _image(rng))  # served behind the stall
        assert res.flow.shape == HW + (2,) and np.isfinite(res.flow).all()
        deadline = time.monotonic() + 10.0
        while not eng.alerts()["fired"] and time.monotonic() < deadline:
            eng.submit(_image(rng), _image(rng))
        stats, health = eng.stats(), eng.health()
        assert stats["watchdog_trips"] == health["watchdog_trips"] == 1
        assert [e["rule"] for e in eng.recorder.events("alert_fire")] == ["watchdog_trips"]
        reasons = [b["reason"] for b in eng.recorder.bundles()]
        assert reasons[0] == "watchdog_trip:serve/apply" and "alert:watchdog_trips" in reasons
        for b in eng.recorder.bundles():
            assert jax_validate_bundle(b) == []
        assert eng.recorder.events("watchdog_trip")[0]["section"] == "serve/apply"
        if mode == "pool":
            assert stats["pool_resets"] == 1
            assert eng.recorder.events("pool_reset")[0]["error"] == "watchdog trip"
        assert 'serve_counters{key="watchdog_trips"} 1' in eng.prometheus()
        assert eng.drain(timeout=10.0)
    logger.close()
    assert [e["kind"] for e in eng.recorder.events() if e["kind"].startswith("drain")] == [
        "drain_begin", "drain_quiesced"]
    events = [json.loads(x) for x in (tmp_path / "events.jsonl").read_text().splitlines()]
    assert [e["bundle"]["reason"] for e in events] == reasons[: len(events)] and events
    scalars = [json.loads(x) for x in (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert scalars[-1]["serve/watchdog_trips"] == 1.0 and len(scalars) >= 2


def test_qos_events_and_prometheus(tiny):
    """The recorder events at the QoS sites (``quota_breach``,
    ``qos_preempt``, ``qos_shed``) on an engine whose worker is not
    started, and the Prometheus QoS series equal to the JAX engine's."""
    jm, variables, pm = tiny
    quotas = (("acme", 0.0, 0.0, 1),)
    eng = ServeEngine(pm, _config(qos_enabled=True, queue_capacity=2, qos_tenant_quotas=quotas), device="cpu")
    eng._ready.set()  # admit without a worker: the queue fills
    rng = np.random.default_rng(23)

    def item(**kw):
        return dict(image1=_image(rng), image2=_image(rng), **kw)

    hs = eng.submit_many([item(priority="batch"), item(priority="batch", tenant="acme")])
    assert not any(h.done for h in hs)
    (q,) = eng.submit_many([item(tenant="acme")])
    assert isinstance(q.error, QuotaExceeded)
    (hi,) = eng.submit_many([item(priority="interactive")])
    assert isinstance(hs[1].error, Overloaded)  # the newest batch-class request was preempted
    (shed,) = eng.submit_many([item(priority="batch")])
    assert isinstance(shed.error, Overloaded) and not hi.done
    assert [e["kind"] for e in eng.recorder.events()] == ["quota_breach", "qos_preempt", "shed", "qos_shed"]
    pre = eng.recorder.events("qos_preempt")[0]
    assert (pre["rid"], pre["by_rid"], pre["priority"], pre["by_priority"]) == (hs[1].rid, hi.rid, "batch",
                                                                                "interactive")
    text = eng.prometheus()
    for line in text.splitlines():
        assert line.startswith("#") or len(line.split(" ")) == 2, line
    jax_eng = JaxServeEngine(jm, variables, JaxServeConfig(buckets=(BUCKET,), ladder=(3, 2, 1), max_batch=4,
                                                           pool_capacity=3, qos_enabled=True,
                                                           qos_tenant_quotas=quotas))
    qos = [ln for ln in text.splitlines() if "serve_qos" in ln]
    want = [ln for ln in jax_eng.prometheus().splitlines() if "serve_qos" in ln]
    assert [ln.rsplit(" ", 1)[0] for ln in qos] == [ln.rsplit(" ", 1)[0] for ln in want]
    assert 'serve_qos_class{class="batch",key="preempted"} 1' in qos
    assert 'serve_qos_tenant{tenant="acme",key="quota_refused"} 1' in qos
    eng.stop()
