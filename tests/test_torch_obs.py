"""The port's observability spine (``raft_tpu_torch.obs``) and
``MetricLogger.log_event`` against the JAX package's, on the CPU.

The same scripted operations go through both packages: the tracer's
sampling and its ids, ``TraceContext.absorb`` and ``dedupe_traces``, the
flight recorder's bundles (equal once the clocks and the pid are set
aside, and valid under JAX's ``validate_bundle``), the alert engine's
fire/resolve transitions under one injected clock, the registry's
Prometheus text and ``relabel_prometheus`` (byte for byte), and the
logger's events file. Everything here is pure Python: no model runs.
"""

import itertools
import json

import pytest
import torch

pytest.importorskip("raft_tpu")

from raft_tpu import obs as jobs  # noqa: E402
from raft_tpu.obs import alerts as jalerts  # noqa: E402
from raft_tpu.obs import metrics as jmetrics  # noqa: E402
from raft_tpu.obs import recorder as jrecorder  # noqa: E402
from raft_tpu.obs import trace as jtrace  # noqa: E402
from raft_tpu.utils.logging import MetricLogger as JaxMetricLogger  # noqa: E402

from raft_tpu_torch import obs as pobs  # noqa: E402
from raft_tpu_torch.obs import alerts as palerts  # noqa: E402
from raft_tpu_torch.obs import metrics as pmetrics  # noqa: E402
from raft_tpu_torch.obs import recorder as precorder  # noqa: E402
from raft_tpu_torch.obs import trace as ptrace  # noqa: E402
from raft_tpu_torch.utils.logging import MetricLogger  # noqa: E402

torch.set_num_threads(2)


def test_all_equal():
    assert set(pobs.__all__) == set(jobs.__all__)
    assert precorder.SCHEMA == jrecorder.SCHEMA


# -- tracing -----------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.02, 0.3, 0.5, 1.0])
def test_tracer_sampling_and_ids_equal(rate, monkeypatch):
    """The same start sequence samples the same requests under the same
    ids (each package's process-wide id counter restarted at 0)."""

    def drive(mod):
        monkeypatch.setattr(mod.Tracer, "_ids", itertools.count())
        tr = mod.Tracer(rate, prefix="srv")
        out = []
        for rid in range(60):
            t = tr.start("pair", rid, t_start=100.0 + rid)
            out.append(None if t is None else (t.trace_id, t.rid, t.kind))
        adopted = tr.start("stream", 99, trace_id="edge-7")
        out.append((adopted.trace_id, tr.started))
        return out

    assert drive(ptrace) == drive(jtrace)


def _spans(rec):
    return [{k: (round(v, 6) if isinstance(v, float) else v) for k, v in sp.items()} for sp in rec["spans"]]


def test_absorb_and_dedupe_equal():
    """A child record stitched into a live trace through a TraceContext
    (with a clock offset and a process lane) gives the same spans; the
    dedupe of merged streams keeps the same records in the same order."""
    child = {"trace_id": "t-1", "t_start": 50.0, "dur_ms": 9.0, "spans": [
        {"name": "admit", "t0_ms": 0.0, "dur_ms": 0.5},
        {"name": "dispatch", "t0_ms": 1.0, "dur_ms": 6.0, "iters": 12},
        {"name": "fetch", "t0_ms": 7.0, "dur_ms": 1.5, "proc": "old"},
    ]}

    def drive(mod):
        sink = []
        parent = mod.Trace("t-1", "edge", None, sink.append, t_start=40.0)
        parent.add_span("http_read", 40.0, 40.002)
        ctx = mod.TraceContext("t-1", parent)
        ctx.absorb(child, proc="engine", t_offset_s=5.0)
        ctx.absorb(None, proc="engine")
        mod.TraceContext("t-1").absorb(child, proc="lost")  # crossed a process: id only, no-op
        parent.event("retry", attempt=1)
        rec = parent.finish(ok=True, route="r0")
        return _spans(rec)[:-1], rec["ok"], rec["route"], parent.finish() is None, len(sink)

    assert drive(ptrace) == drive(jtrace)
    records = [
        {"trace_id": "a", "spans": [1]}, {"x": 1}, {"trace_id": "b", "spans": []},
        {"trace_id": "a", "spans": [1, 2, 3]}, {"trace_id": "b", "spans": [1]}, {"x": 2},
        {"trace_id": "a", "spans": [1, 2]},
    ]
    assert ptrace.dedupe_traces(records) == jtrace.dedupe_traces(records)


# -- the flight recorder ----------------------------------------------------------

_CLOCKS = ("t", "wall", "dumped_wall", "dumped_t", "pid", "wall_start", "dur_ms")


def _strip(obj):
    """A bundle with its clocks, durations and pid set aside."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in _CLOCKS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _script(rec_mod, alerts_mod, trace_mod):
    ids = trace_mod.Tracer._ids
    trace_mod.Tracer._ids = itertools.count()  # both packages' ids from 0
    try:
        return _script_body(rec_mod, alerts_mod, trace_mod)
    finally:
        trace_mod.Tracer._ids = ids


def _script_body(rec_mod, alerts_mod, trace_mod):
    rec = rec_mod.FlightRecorder(capacity=4, trace_capacity=2, proc="engine")
    tr = trace_mod.Tracer(1.0, prefix="x", on_finish=rec.add_trace)
    eng = alerts_mod.AlertEngine(
        (alerts_mod.AlertRule("trips", alerts_mod.rate("watchdog_trips"), 0.0, 1.0, 2.0, severity="page"),),
        recorder=rec, now=lambda: 0.0,
    )
    rec.alerts_provider = eng.active
    rec.record("boot", source="none", captures=0)
    rec.record("shed", rid=3, req_kind="pair", retry_after_ms=12.5, kind="ignored")
    for rid in range(3):
        t = tr.start("pair", rid, t_start=10.0)
        t.add_span("admit", 10.0, 10.001)
        t.annotate(priority="standard")
        t.finish(ok=rid != 1, error=None if rid != 1 else "Overloaded()")
    rec.record("degradation_step", frm=0, to=1, num_flow_updates=20, queue_depth=7)
    eng.observe({"watchdog_trips": 0}, t=0.0)
    eng.observe({"watchdog_trips": 1}, t=0.5)  # fires: a page alert dumps
    rec.record("pool_reset", bucket="48x64", residents=2, error="watchdog trip")
    bundle = rec.dump("watchdog_trip:serve/apply", extra={"health": {"ready": True}})
    return rec, bundle


def test_same_events_same_bundle():
    p_rec, p_bundle = _script(precorder, palerts, ptrace)
    j_rec, j_bundle = _script(jrecorder, jalerts, jtrace)
    assert _strip(p_bundle) == _strip(j_bundle)
    assert [_strip(b) for b in p_rec.bundles()] == [_strip(b) for b in j_rec.bundles()]
    assert (p_rec.events_recorded, p_rec.traces_recorded, p_rec.dumps) == (
        j_rec.events_recorded, j_rec.traces_recorded, j_rec.dumps)
    assert p_bundle["reason"] == "watchdog_trip:serve/apply" and len(p_bundle["events"]) == 4
    # the port's bundles pass the JAX validator (scripts/postmortem.py's)
    for b in p_rec.bundles():
        assert jrecorder.validate_bundle(b) == []
        assert precorder.validate_bundle(b) == []
    broken = dict(p_bundle, events=[{"kind": "x"}], schema="raft-postmortem/9")
    assert precorder.validate_bundle(broken) == jrecorder.validate_bundle(broken) != []


def test_file_and_logger_sinks(tmp_path):
    """A port bundle written by ``file_sink`` and by ``logger_sink``
    reads back valid under the JAX validator."""
    rec, _ = _script(precorder, palerts, ptrace)
    rec.add_sink(precorder.file_sink(str(tmp_path / "dumps"), keep=1))
    logger = MetricLogger(str(tmp_path / "logs"))
    rec.add_sink(precorder.logger_sink(logger))
    rec.dump("evict:r1")
    rec.dump("alert:slo_burn")
    logger.close()
    files = sorted(p.name for p in (tmp_path / "dumps").iterdir())
    assert files == ["postmortem_0001_alert-slo_burn.json"]
    assert jrecorder.validate_bundle(json.loads((tmp_path / "dumps" / files[0]).read_text())) == []
    lines = [json.loads(x) for x in (tmp_path / "logs" / "events.jsonl").read_text().splitlines()]
    assert [x["kind"] for x in lines] == ["postmortem", "postmortem"]
    assert all(jrecorder.validate_bundle(x["bundle"]) == [] for x in lines)


# -- alerts ---------------------------------------------------------------------------


def test_alert_engine_transitions_equal():
    """One rule set of every burn kind, one injected clock, one scripted
    counter sequence: the same fire/resolve transitions at the same
    observations, the same snapshots and the same recorder events."""
    seq = [
        (0.0, dict(submitted=0, expired=0, shed=0, quarantined=0, watchdog_trips=0, drift=1.0)),
        (1.0, dict(submitted=10, expired=0, shed=0, quarantined=0, watchdog_trips=0, drift=1.0)),
        (2.0, dict(submitted=20, expired=3, shed=2, quarantined=1, watchdog_trips=0, drift=1.8)),
        (3.0, dict(submitted=30, expired=6, shed=4, quarantined=1, watchdog_trips=1, drift=1.9)),
        (4.0, dict(submitted=40, expired=6, shed=4, quarantined=1, watchdog_trips=1, drift=1.2)),
        (6.0, dict(submitted=60, expired=6, shed=4, quarantined=1, watchdog_trips=1, drift=1.0)),
        (9.0, dict(submitted=90, expired=6, shed=4, quarantined=1, watchdog_trips=1, drift=1.0)),
        (12.0, dict(submitted=120, expired=6, shed=4, quarantined=1, watchdog_trips=1, drift=1.0)),
        (12.1, dict(submitted=120, expired=6, shed=4, quarantined=1, watchdog_trips=1, drift=1.0)),
    ]

    def drive(mod, rec_mod):
        clock = [0.0]
        rec = rec_mod.FlightRecorder()
        eng = mod.AlertEngine(
            (
                mod.AlertRule("slo_burn", mod.ratio_rate(("expired", "shed"), "submitted"), 0.1, 1.0, 3.0,
                              severity="page"),
                mod.AlertRule("quarantine_burn", mod.ratio_rate("quarantined", "submitted"), 0.05, 1.0, 3.0),
                mod.AlertRule("watchdog_trips", mod.rate("watchdog_trips"), 0.0, 1.0, 3.0, severity="page"),
                mod.AlertRule("drift", mod.gauge_value("drift"), 1.5, 1.0, 3.0),
            ),
            recorder=rec, now=lambda: clock[0],
        )
        seen = []
        eng.add_sink(lambda info: seen.append(info["rule"]))
        eng.add_sink(lambda info: 1 / 0)  # a broken sink is isolated
        out = []
        for t, snap in seq:
            clock[0] = t
            trans = eng.observe(snap)
            out.append([(x["event"], x["rule"], x["burn"], x["burn_long"]) for x in trans])
        eng.maybe_observe(seq[-1][1])
        reg = (pmetrics if mod is palerts else jmetrics).MetricsRegistry("serve")
        eng.register_gauges(reg)
        return (out, eng.snapshot(), [a["rule"] for a in eng.active()], seen,
                [(e["kind"], e.get("rule")) for e in rec.events()], [b["reason"] for b in rec.bundles()],
                reg.prometheus_text())

    got, want = drive(palerts, precorder), drive(jalerts, jrecorder)
    assert got == want
    assert any(t for t in got[0])  # the script fires and resolves something


def test_alert_rule_validation_equal():
    for kw in (dict(name=""), dict(short_s=5.0, long_s=1.0), dict(severity="sev1"), dict(resolve_ratio=2.0)):
        args = dict(name="r", burn=lambda p, c, d: 0.0, threshold=1.0) | kw
        with pytest.raises(ValueError) as want:
            jalerts.AlertRule(**args)
        with pytest.raises(ValueError) as got:
            palerts.AlertRule(**args)
        assert str(got.value) == str(want.value)


# -- metrics ----------------------------------------------------------------------------


def _registry_script(mod):
    reg = mod.MetricsRegistry("serve")
    c = reg.counter("requests", help="requests seen")
    c.inc()
    c.inc(4)
    g = reg.counter_group("counters", ("submitted", "completed"))
    g["submitted"] += 3
    g.inc("completed")
    g.inc("new-key", 2)
    reg.counter_group("counters", ("shed",))
    reg.gauge("queue_depth", lambda: 7, help="queued requests")
    reg.gauge("broken", lambda: 1 / 0)
    reg.gauge("level").set(2)
    h = reg.histogram("latency_ms")
    for v in (0.5, 3.0, 3.0, 80.0, 4e4):
        h.observe(v)
    d = reg.histogram("device_ms/pool_step", bounds=mod.DEVICE_TIME_BUCKETS_MS)
    d.observe(0.07)
    with pytest.raises(ValueError, match="misbucket"):
        reg.histogram("latency_ms", bounds=(1.0, 2.0))
    return reg


def test_prometheus_text_and_relabel_byte_equal(tmp_path):
    got, want = _registry_script(pmetrics), _registry_script(jmetrics)
    assert got.prometheus_text() == want.prometheus_text()
    text = got.prometheus_text()
    assert pmetrics.relabel_prometheus(text, replica="r1", zone='a"b') == jmetrics.relabel_prometheus(
        text, replica="r1", zone='a"b')
    assert pmetrics.relabel_prometheus(text) == text
    snap_p, snap_j = got.snapshot(), want.snapshot()
    assert snap_p.keys() == snap_j.keys()
    assert {k: v for k, v in snap_p.items() if k != "serve/broken"} == {
        k: v for k, v in snap_j.items() if k != "serve/broken"}
    # log_to: one numeric JSONL record (the broken probe's NaN left out)
    logs = []
    for reg, cls in ((got, MetricLogger), (want, lambda d: JaxMetricLogger(d, tensorboard=False))):
        d = tmp_path / str(len(logs))
        with cls(str(d)) as lg:
            reg.log_to(lg, 3)
        rec = json.loads((d / "scalars.jsonl").read_text())
        rec.pop("time")
        logs.append(rec)
    assert logs[0] == logs[1] and logs[0]["step"] == 3 and "serve/broken" not in logs[0]


def test_log_event_equal(tmp_path):
    """``log_event`` writes the same events file (``repr`` for leaves JSON
    cannot hold; a record after ``close()`` is a counted drop)."""

    class Leaf:
        def __repr__(self):
            return "<leaf>"

    out = []
    for i, make in enumerate((MetricLogger, lambda d: JaxMetricLogger(d, tensorboard=False))):
        d = tmp_path / str(i)
        lg = make(str(d))
        assert not (d / "events.jsonl").exists()
        lg.log_event({"kind": "postmortem", "bundle": {"a": [1, 2], "leaf": Leaf()}, "time": 5.0})
        lg.log_event({"kind": "boot"})
        lg.close()
        lg.log_event({"kind": "late"})
        lines = [json.loads(x) for x in (d / "events.jsonl").read_text().splitlines()]
        lines[1].pop("time")
        out.append((lines, lg.dropped_records, lg.closed))
    assert out[0] == out[1]
    assert out[0][0][0] == {"kind": "postmortem", "bundle": {"a": [1, 2], "leaf": "<leaf>"}, "time": 5.0}


def test_profile_toggle():
    """Off, ``annotate`` is a shared no-op; on, a ``torch.profiler``
    range that a CPU profile records by name."""
    from raft_tpu_torch.obs import profile

    assert not profile.enabled()
    assert profile.annotate("serve/pool_step") is profile.annotate("serve/iterate")
    profile.enable()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                with profile.annotate("serve/pool_step"):
                    torch.ones(2) + 1
    finally:
        profile.disable()
    assert not profile.enabled()
    names = [e.name for e in prof.events()]
    assert names.count("serve/pool_step") == 3
