"""The port's process backend of the serving fleet against the JAX package's,
on the CPU: the ``ipc`` transport, worker processes behind
``ProcessEngineClient``, and ``backend='process'`` replicas and rollout
candidates.

* **The wire, byte for byte** (no process): the JAX message set plus error
  payloads through both packages' ``encode_payload`` in both codecs (the
  same bytes; each side decodes the other's frames), ``pack_frames`` /
  ``unpack_frames``, framing over a socket pair, and the typed-error wire
  (equal dicts; each side decodes to its own class with the same
  ``retry_after_ms``).
* **``ShmRing``, ``FrameCoalescer``, ``CopyTripwire``** (no process): one
  scripted sequence of puts, gets, frees, reserves and full-ring sheds
  through both packages with ``time.monotonic`` pinned to one clock in both
  modules: the same slots, stats, hints, messages and tripwire counts; the
  coalescer's frames for a held-leader burst equal.
* **A process fleet over the tiny engine** (``tests/test_torch_serve.py``'s
  config and weights, written to a torch file the workers read): a worker
  boots behind ``ServeRouter.from_factory(..., 1, backend='process')``; a
  lone request through it is bit for bit the in-process engine's; typed
  errors and a stream cross the wire; its ``stats()`` / ``health()`` keys
  are the in-process engine's, its ``transport_stats()`` keys JAX's pinned
  schema; request slots scribbled over as soon as the worker frees them
  after admission leave the flows unchanged (and in-process, inputs
  scribbled as ``submit_many`` returns leave the pool, tiled and slow
  path flows bit for bit the plain ones); an ``Autoscaler`` scales the
  fleet up with a clone of the process backend; a SIGKILLed worker under a
  flood loses no request and is readmitted under a new PID; a live
  eviction lands the worker's own bundle in ``dump_dir``; a drain, then a
  typed refusal.
* **One scripted sequence through both packages' clients** over a
  picklable pure-Python stub engine (``tests/torch_worker_factories.py``,
  which imports no JAX at its top level, so a port worker never loads
  JAX): the same results, typed errors, stub counters, ring counts and
  drain.
* **A process candidate** on a thread fleet walks shadow -> canary ->
  promoted; its mirrors reach its worker's own live counters, never a
  ``shadow_*`` counter.

The file spawns 6 workers: 3 for the fleet (boot, scale-up, readmission),
one JAX and one port stub worker, the candidate.
"""

import dataclasses
import json
import os
import signal
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("raft_tpu")

from test_torch_serve import _config, tiny  # noqa: E402,F401
from test_torch_serve import TINY as SERVE_TINY  # noqa: E402
from test_torch_serve_rollout import LADDER, _drain  # noqa: E402
from torch_worker_factories import CONFIG, HW, TINY, StubFactory, TinyEngineFactory  # noqa: E402

from raft_tpu.serve import errors as jax_errors  # noqa: E402
from raft_tpu.serve import ipc as jax_ipc  # noqa: E402
from raft_tpu.serve import worker as jax_worker  # noqa: E402
from raft_tpu.utils import tripwire as jax_tripwire  # noqa: E402

from raft_tpu_torch.obs import validate_bundle  # noqa: E402
from raft_tpu_torch.serve import (  # noqa: E402
    AutoscaleConfig,
    Autoscaler,
    Draining,
    EngineStopped,
    InvalidInput,
    Overloaded,
    ProcessEngineClient,
    ReplicaState,
    RolloutConfig,
    RouterConfig,
    ServeConfig,
    ServeError,
    ServeRouter,
    ShapeRejected,
)
from raft_tpu_torch.serve import errors as port_errors  # noqa: E402
from raft_tpu_torch.serve import ipc as port_ipc  # noqa: E402
from raft_tpu_torch.serve import worker as port_worker  # noqa: E402
from raft_tpu_torch.utils import tripwire as port_tripwire  # noqa: E402

torch.set_num_threads(2)

PKGS = {
    "jax": SimpleNamespace(ipc=jax_ipc, errors=jax_errors, worker=jax_worker, tripwire=jax_tripwire),
    "port": SimpleNamespace(ipc=port_ipc, errors=port_errors, worker=port_worker, tripwire=port_tripwire),
}
# the tiny engine's request and response tensors are tens of KB
WORKER_OPTS = dict(ring_slots=8, slot_bytes=1 << 16)


def _image(rng, hw=HW):
    return rng.integers(0, 255, hw + (3,), dtype=np.uint8)


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def _error(e):
    """A typed error as what a caller reads of it."""
    return (type(e).__name__, str(e), getattr(e, "retry_after_ms", None), getattr(e, "retryable", None),
            getattr(e, "supported_buckets", None), getattr(e, "nearest", None))


# -- the wire, byte for byte ---------------------------------------------------


_SUBMIT = {
    "op": "submit", "id": 12345,
    "im1": {"slot": 1, "shape": [45, 60, 3], "dtype": "|u1"},
    "im2": {"slot": 2, "shape": [45, 60, 3], "dtype": "|u1"},
    "deadline_ms": 30000.0, "num_flow_updates": None,
}
_RESULT = {
    "id": 12345, "ok": True, "result": {
        "rid": 77, "bucket": [48, 64], "num_flow_updates": 2, "level": 0,
        "degraded": False, "latency_ms": 12.34, "slow_path": False,
        "retried_single": False, "primed": False, "exit_reason": "target",
        "trace_id": None, "residuals": None, "warm_started": False,
        "flow": {"slot": 3, "shape": [45, 60, 2], "dtype": "<f4"},
    },
}
# the JAX transport tests' message set (tests/test_serve_xport.py), the
# propagated-trace and QoS submit records, and error and handshake payloads
MESSAGES = {
    "submit": _SUBMIT,
    "submit_frame": {"op": "submit_frame", "id": 7, "stream_id": 4,
                     "frame": {"slot": 0, "shape": [45, 60, 3], "dtype": "|u1"},
                     "deadline_ms": None, "num_flow_updates": 2},
    "result": _RESULT,
    "result_variants": dict(_RESULT, result=dict(_RESULT["result"], trace_id="t-00ab", residuals=[0.5, 0.25],
                                                 primed=True, flow=None, exit_reason="converged")),
    "error": {"id": 9, "error": {"type": "Overloaded", "msg": "full", "retry_after_ms": 33.5}},
    "error_field": {"id": 9, "error": {"type": "ArtifactMismatch", "msg": "stale", "field": "jaxlib"}},
    "error_shape": {"id": 4, "error": {"type": "ShapeRejected", "msg": "no bucket", "supported_buckets": [[48, 64]],
                                       "nearest": [48, 64]}},
    "free_req": {"op": "free_req", "slots": [3, 1, 400000]},
    "free_resp": {"op": "free_resp", "slots": [0]},
    "batch": {"op": "batch", "msgs": [_SUBMIT, {"op": "health", "id": 1}]},
    "health": {"op": "health", "id": 0},
    "generic": {"op": "stats", "id": 2, "nested": {"x": [1, 2.5, None, True]}, "s": "uniçode", "big": 2 ** 40,
                "neg": -5},
    "submit_traced": dict(_SUBMIT, trace_id="t-0042"),
    "submit_qos": dict(_SUBMIT, priority="interactive", tenant="acme"),
    "submit_traced_qos": dict(_SUBMIT, trace_id="t-0043", priority="batch", tenant="t1"),
    "ready": {"op": "ready", "pid": 4242, "transport": "binary", "trace_propagation": True,
              "config": {"buckets": [[48, 64]], "ladder": [3, 2, 1], "warmup": False},
              "boot": {"source": "none", "boot_to_ready_ms": 0.7}},
}


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "json"])
@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_codec_bytes_match_jax(name, binary):
    """The same message gives the same bytes in both packages, and each
    package decodes the other's frame back to the message."""
    msg = MESSAGES[name]
    got, want = port_ipc.encode_payload(msg, binary=binary), jax_ipc.encode_payload(msg, binary=binary)
    assert got == want
    assert port_ipc.decode_payload(want) == msg and jax_ipc.decode_payload(got) == msg
    assert port_ipc.iter_messages(port_ipc.decode_payload(want)) == jax_ipc.iter_messages(msg)


def test_framing_crosses_packages():
    """Length-prefixed frames written by one package read by the other, both
    codecs, through ``recv_msg`` and the buffered ``FrameReader``; a
    closed peer is ``ConnectionClosed``."""
    for send, recv in ((port_ipc, jax_ipc), (jax_ipc, port_ipc)):
        a, b = socket.socketpair()
        try:
            msgs = [MESSAGES["submit"], MESSAGES["result"], MESSAGES["batch"], MESSAGES["generic"]]
            for i, m in enumerate(msgs):
                send.send_msg(a, m, binary=bool(i % 2))
            assert [recv.recv_msg(b) for _ in msgs[:2]] == msgs[:2]
            reader = recv.FrameReader(b)
            assert [reader.read_msg() for _ in msgs[2:]] == msgs[2:]
            a.close()
            with pytest.raises(recv.ConnectionClosed):
                reader.read_msg()
        finally:
            a.close()
            b.close()


FRAME_CASES = {
    "pair": ({"kind": "submit", "deadline_ms": 250.0}, [np.arange(45 * 60 * 3, dtype=np.uint8).reshape(45, 60, 3),
                                                        np.ones((45, 60, 3), np.uint8)]),
    "flow": ({}, [np.linspace(-3, 3, 45 * 60 * 2, dtype=np.float32).reshape(45, 60, 2)]),
    "strided": ({"x": [1, 2]}, [np.arange(24, dtype=np.float32).reshape(4, 6)[:, ::2]]),
    "empty": ({"none": None}, []),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_pack_frames_match_jax(case):
    """Tensor bodies: the same bytes and the same copy counts (a strided
    array is made contiguous, a counted copy), and each side unpacks the
    other's body to the same meta and arrays."""
    meta, arrays = FRAME_CASES[case]
    with port_tripwire.CopyTripwire() as ptw, jax_tripwire.CopyTripwire() as jtw:
        got, want = port_ipc.pack_frames(meta, arrays), jax_ipc.pack_frames(meta, arrays)
        (pm, pa), (jm, ja) = port_ipc.unpack_frames(want), jax_ipc.unpack_frames(got)
    assert got == want and pm == jm and ptw.snapshot() == jtw.snapshot()
    assert len(pa) == len(ja) == len(arrays)
    for p, j, a in zip(pa, ja, arrays):
        np.testing.assert_array_equal(p, a)
        np.testing.assert_array_equal(j, a)
        assert p.dtype == j.dtype == a.dtype


ERRORS = {
    "ServeError": lambda e: e.ServeError("boom"),
    "Overloaded": lambda e: e.Overloaded("full", retry_after_ms=12.5),
    "Draining": lambda e: e.Draining("draining", retry_after_ms=50.0),
    "QuotaExceeded": lambda e: e.QuotaExceeded("tenant over quota", retry_after_ms=7.25, tenant="acme"),
    "DeadlineExceeded": lambda e: e.DeadlineExceeded("late"),
    "InvalidInput": lambda e: e.InvalidInput("bad image"),
    "ShapeRejected": lambda e: e.ShapeRejected("no bucket", supported_buckets=((48, 64), (96, 128)),
                                               nearest=(48, 64)),
    "PoisonedInput": lambda e: e.PoisonedInput("nan flow"),
    "EngineStopped": lambda e: e.EngineStopped("stopped"),
    "RolloutAborted": lambda e: e.RolloutAborted("rolled back", stage="shadow", reason="flow_mean"),
    "RuntimeError": lambda e: RuntimeError("untyped fault"),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_error_wire_matches_jax(name):
    """``encode_error`` gives equal dicts for the same error in both
    packages (an error outside the documented set goes as ``ServeError``),
    and each package's ``decode_error`` of either dict gives its own
    package's class with the same message, hint and bucket fields."""
    pe, je = ERRORS[name](port_errors), ERRORS[name](jax_errors)
    got, want = port_ipc.encode_error(pe), jax_ipc.encode_error(je)
    assert got == want
    for wire in (got, want):
        p, j = port_ipc.decode_error(wire), jax_ipc.decode_error(wire)
        assert type(p) is getattr(port_errors, type(j).__name__) and type(p).__module__.startswith("raft_tpu_torch")
        assert _error(p) == _error(j)


def test_artifact_mismatch_decodes_as_serve_error():
    """The port has no warmup-artifact error: a JAX worker's
    ``ArtifactMismatch`` reaches a port client as the base ``ServeError``
    with its message."""
    wire = jax_ipc.encode_error(jax_errors.ArtifactMismatch("stale artifact", field="jaxlib"))
    got = port_ipc.decode_error(wire)
    assert type(got) is port_errors.ServeError and str(got) == "stale artifact"


def _ring_trace(pkg, monkeypatch):
    """One scripted ring sequence under a fake clock: puts, a full-ring shed,
    frees feeding the hold EWMA, a borrowed get and a copied one, a
    reserve filled in place, an oversized put, a strided put, a closed
    ring; the slots, stats, hints, messages and tripwire counts."""
    p = PKGS[pkg]
    clock = [1000.0]
    monkeypatch.setattr(p.ipc, "time", SimpleNamespace(monotonic=lambda: clock[0]))
    out = []
    rng = np.random.default_rng(3)
    ring = p.ipc.ShmRing(4096, 4)
    try:
        with p.tripwire.CopyTripwire() as tw:
            refs = []
            for i in range(4):
                clock[0] += 0.01 * (i + 1)
                refs.append(ring.put(rng.integers(0, 255, (8, 8, 3), dtype=np.uint8), timeout=0.0))
            out.append(("puts", refs, ring.occupancy(), ring.retry_after_ms()))
            try:
                ring.put(np.zeros(16, np.float32), timeout=0.0)
            except p.errors.Overloaded as e:
                out.append(("shed", _error(e)))
            for slot, dt in ((refs[1]["slot"], 0.03), (refs[3]["slot"], 0.002), (refs[0]["slot"], 0.1)):
                clock[0] += dt
                ring.free(slot)
                out.append(("free", slot, ring.stats(), ring.retry_after_ms()))
            ring.free(refs[0]["slot"])  # a second free of one slot is a no-op
            out.append(("get", ring.get(refs[2]).tolist(), ring.get(refs[2], copy=False).flags["OWNDATA"]))
            slot = ring.reserve(60, timeout=0.0)
            view = ring.slot_view(slot, 60)
            view[:] = np.arange(60, dtype=np.uint8).tobytes()
            view.release()
            ref = p.ipc.ShmRing.make_ref(slot, (15,), np.float32)
            out.append(("reserve", slot, ring.get(ref).tolist()))
            try:
                ring.put(np.zeros(5000, np.uint8), timeout=0.0)
            except p.errors.InvalidInput as e:
                out.append(("oversized", _error(e)))
            out.append(("strided", ring.put(np.arange(32, dtype=np.float32).reshape(4, 8)[:, ::2], timeout=0.0)))
            out.append(("fill", ring.put(np.ones(4, np.uint8), timeout=0.0), ring.occupancy()))
            try:
                ring.put(np.zeros(4, np.uint8), timeout=0.0)
            except p.errors.Overloaded as e:
                out.append(("shed2", _error(e)))
            out.append(("stats", ring.stats(), ring.free_count(), ring.geometry()["slots"]))
            out.append(("tripwire", tw.snapshot(), tw.bytes_copied, tw.total))
            tw.reset()
            with tw.pause():
                ring.get(refs[2])
            out.append(("paused", tw.total))
    finally:
        ring.close()
    try:
        ring.reserve(4, timeout=0.0)
    except p.errors.EngineStopped as e:
        out.append(("closed", _error(e)))
    return out


def test_shm_ring_sequence_matches_jax(monkeypatch):
    """Slot numbers, ``stats()``, ``retry_after_ms`` hints (occupancy x the
    hold EWMA under one clock), error messages and the tripwire's counts by
    site: the same in both packages."""
    got, want = _ring_trace("port", monkeypatch), _ring_trace("jax", monkeypatch)
    assert got == want
    kinds = [o[0] for o in got]
    assert kinds == ["puts", "shed", "free", "free", "free", "get", "reserve", "oversized", "strided", "fill",
                     "shed2", "stats", "tripwire", "paused", "closed"]
    assert got[1][1][0] == "Overloaded" and got[1][1][2] == 50.0  # no hold history yet: the default hint
    assert got[10][1][0] == "Overloaded" and got[10][1][2] != 50.0  # occupancy x the hold EWMA
    assert got[12][1] == {"ring_put": 6, "ring_get": 2, "pack_contig": 1} and got[13][1] == 0


def _coalescer_trace(pkg, binary, batch):
    """A lone send, a burst through ``send_many``, a held-leader burst (four
    senders append while another sender holds the write lock, then one
    leader drains them) and a mixed frame; the frames as read, the raw
    bytes, and the stats."""
    p = PKGS[pkg]
    a, b = socket.socketpair()
    try:
        co = p.ipc.FrameCoalescer(a, binary=binary, batch=batch)
        co.send(MESSAGES["health"])
        co.send_many([dict(_SUBMIT, id=i) for i in range(5)])
        if batch:
            co._wlock.acquire()  # a leader mid-write: the followers' messages wait for its drain
            threads = [threading.Thread(target=co.send, args=({"op": "health", "id": 100 + i},)) for i in range(4)]
            for t in threads:
                t.start()
                t.join()  # appended, and returned at once
            co._wlock.release()
        co.send_many([{"op": "free_resp", "slots": [3]}, MESSAGES["submit_frame"]])
        sent = co.stats()
        a.shutdown(socket.SHUT_WR)
        raw = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                break
            raw += chunk
        frames, off = [], 0
        while off < len(raw):
            (n,) = p.ipc._LEN.unpack(raw[off:off + 4])
            frames.append(p.ipc.iter_messages(p.ipc.decode_payload(raw[off + 4:off + 4 + n])))
            off += 4 + n
        return sent, raw, frames
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("binary,batch", [(True, True), (False, True), (False, False)],
                         ids=["binary", "json-batched", "legacy"])
def test_coalescer_frames_match_jax(binary, batch):
    """The coalescer writes the same frames in both packages: a lone message
    unwrapped, a burst in one frame, a held leader's followers in the next
    frame written, with the next sender's messages (it drains everything
    pending), one frame a message on the legacy wire."""
    got, want = _coalescer_trace("port", binary, batch), _coalescer_trace("jax", binary, batch)
    assert got == want
    sent, _, frames = got
    if batch:
        assert [len(f) for f in frames] == [1, 5, 6] and sent["frames_sent"] == 3 and sent["max_batch"] == 6
    else:
        assert [len(f) for f in frames] == [1] * 8 and sent["batched_msgs"] == 0


def test_config_and_result_wire_match_jax():
    """A config survives its handshake form (tuples restored; the port
    re-tuples the QoS quotas too, so the parent's config equals the
    worker's), and a result through the response ring comes back equal in
    both packages."""
    from raft_tpu.serve import ServeConfig as JaxServeConfig
    from raft_tpu.serve.engine import ServeResult as JaxServeResult

    from raft_tpu_torch.serve import ServeResult

    kw = dict(CONFIG, qos_enabled=True, qos_tenant_quotas=(("acme", 20.0, 4.0, 0),), batch_ladder=(1, 2, 4))
    pcfg, jcfg = ServeConfig(**kw), JaxServeConfig(**kw)
    wire = json.loads(json.dumps(dataclasses.asdict(pcfg)))
    assert port_worker.config_from_wire(wire) == pcfg
    jwire = json.loads(json.dumps(dataclasses.asdict(jcfg)))
    assert {k: v for k, v in wire.items() if k in jwire} == {k: v for k, v in jwire.items() if k in wire}
    outs = []
    for pkg, cls in (("port", ServeResult), ("jax", JaxServeResult)):
        p = PKGS[pkg]
        res = cls(flow=np.full((45, 60, 2), 0.25, np.float32), rid=7, bucket=(48, 64), num_flow_updates=3, level=1,
                  degraded=True, latency_ms=3.5, exit_reason="converged", trace_id="t-1", residuals=(0.5, 0.25),
                  warm_started=True)
        ring = p.ipc.ShmRing(1 << 16, 2)
        try:
            d = p.worker.serve_result_to_wire(res, ring, trace_rec={"trace_id": "t-1", "spans": []})
            back = p.worker._serve_result_from_wire(d, ring.get(d["flow"]))
        finally:
            ring.close()
        outs.append((d, dataclasses.asdict(back)))
    (pd, pback), (jd, jback) = outs
    assert pd == jd and pback.keys() == jback.keys()
    np.testing.assert_array_equal(pback.pop("flow"), jback.pop("flow"))
    assert pback == jback


# -- a process fleet over the tiny engine ----------------------------------------


def test_worker_factories_match_the_serving_tests_and_load_no_jax():
    """The factories' tiny model and config are ``tests/test_torch_serve.py``'s,
    and their module (what a port worker unpickles) imports no JAX."""
    import subprocess
    import sys

    assert TINY == SERVE_TINY
    assert _config() == ServeConfig(**CONFIG)
    code = ("import sys; sys.path.insert(0, 'tests'); import torch_worker_factories; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'raft_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.dirname(__file__)),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


@pytest.fixture(scope="module")
def fleet(tiny, tmp_path_factory):
    """A router over one process replica of the tiny engine (the weights of
    ``tests/test_torch_serve.py``'s ``tiny``, written to a torch file) at a
    50 ms heartbeat, its worker dumps in a directory of their own, and the
    in-process engine from the same factory (the reference)."""
    root = tmp_path_factory.mktemp("fleet")
    path = str(root / "tiny.pt")
    torch.save(tiny[2].state_dict(), path)
    factory = TinyEngineFactory(path)
    dump_dir = str(root / "dumps")
    router = ServeRouter.from_factory(
        factory, 1, RouterConfig(heartbeat_interval_s=0.05, heartbeat_timeout_s=5.0, cooldown_s=0.3),
        backend="process", worker_options=dict(WORKER_OPTS, dump_dir=dump_dir),
    ).start()
    ref = factory().start()
    try:
        yield SimpleNamespace(router=router, ref=ref, dump_dir=dump_dir, factory=factory)
    finally:
        router.close()
        ref.stop()


def _client(fleet, rid="r0"):
    return fleet.router._by_id[rid].engine


def _fleet_of_two(fleet):
    """The fleet's replicas ``r0`` and ``r1``, both healthy. In the file's
    order the autoscaler test has made ``r1``; a test run on its own adds it
    here (one more worker)."""
    router = fleet.router
    if "r1" not in router._by_id:
        router.add_replica(reason="test: a fleet of two")
    reps = [router._by_id[r] for r in ("r0", "r1")]
    assert all(r.state == ReplicaState.HEALTHY and r.engine.is_alive() for r in reps), [
        (r.replica_id, r.state) for r in reps]
    return reps


def test_worker_boot_handshake(fleet):
    """One worker process: a live PID not ours, the binary wire with trace
    and QoS fields, the clock offset estimated at the handshake, the worker
    engine's config equal to the in-process one's, its boot block, and the
    replica snapshot."""
    c = _client(fleet)
    assert isinstance(c, ProcessEngineClient) and c.pid != os.getpid()
    os.kill(c.pid, 0)
    ts = c.transport_stats()
    assert (ts["transport"], ts["trace_propagation"], ts["qos_propagation"]) == ("binary", True, True)
    assert ts["clock_rtt_ms"] is not None and ts["sender"]["frames_sent"] >= 3  # the clock's round trips
    assert c.config == fleet.ref.config
    assert set(c.boot) == set(fleet.ref.stats()["boot"])
    snap = fleet.router.stats()["replicas"]["r0"]
    assert snap["backend"] == "process" and snap["pid"] == c.pid and snap["state"] == "healthy"


def test_lone_request_bitwise_vs_in_process(fleet):
    """A lone request through the worker is bit for bit the in-process
    engine's (same weights, config and CPU threads), through the client
    and through the router."""
    rng = np.random.default_rng(11)
    c = _client(fleet)
    for i in range(3):
        im1, im2 = _image(rng), _image(rng)
        got = (c if i < 2 else fleet.router).submit(im1, im2)
        want = fleet.ref.submit(im1, im2)
        assert got.flow.dtype == want.flow.dtype and np.array_equal(got.flow, want.flow)
        assert (got.bucket, got.num_flow_updates, got.exit_reason) == (want.bucket, want.num_flow_updates,
                                                                       want.exit_reason)


def test_typed_errors_cross_the_wire(fleet):
    """The worker engine's typed errors reach the caller as the in-process
    engine raises them: class, message and fields."""
    rng = np.random.default_rng(12)
    c = _client(fleet)
    nan = np.full(HW + (3,), np.nan, np.float32)
    cases = [
        (lambda e: e.submit(nan, _image(rng)), InvalidInput),
        (lambda e: e.submit(_image(rng, (100, 120)), _image(rng, (100, 120))), ShapeRejected),
        (lambda e: e.submit(_image(rng), _image(rng), num_flow_updates=99), InvalidInput),
        (lambda e: e.submit(_image(rng), _image(rng, (44, 60))), InvalidInput),
    ]
    for call, cls in cases:
        with pytest.raises(cls) as got:
            call(c)
        with pytest.raises(cls) as want:
            call(fleet.ref)
        assert _error(got.value) == _error(want.value)


def test_stream_through_the_worker(fleet):
    """A stream crosses the wire: the first frame primes, the rest are bit
    for bit the in-process engine's stream flows."""
    rng = np.random.default_rng(13)
    frames = [_image(rng) for _ in range(3)]
    outs = []
    for eng in (_client(fleet), fleet.ref):
        with eng.open_stream() as st:
            outs.append([st.submit(f) for f in frames])
    got, want = outs
    assert got[0].primed and got[0].flow is None and want[0].primed
    for g, w in zip(got[1:], want[1:]):
        assert not g.primed and np.array_equal(g.flow, w.flow)


def test_stats_and_health_keys_equal_the_in_process_engine(fleet):
    """The worker's ``stats()`` is the in-process engine's key tree plus one
    parent-side ``transport`` block; ``health()`` has the same keys;
    ``alerts()`` and ``prometheus()`` come across."""
    c = _client(fleet)
    st, ref = c.stats(), fleet.ref.stats()
    transport = st.pop("transport")
    assert _keys(st) == _keys(ref) and set(transport) >= {"transport", "rings"}
    assert set(c.health()) == set(fleet.ref.health())
    assert set(c.alerts()) == set(fleet.ref.alerts())
    assert 'serve_counters{key="completed"}' in c.prometheus()


def test_transport_stats_keys_match_jax_schema(fleet):
    """``transport_stats()`` has JAX's pinned key set (and span set); with
    ``include_worker`` the worker's own side comes along."""
    from test_observability import PROCESS_TRANSPORT_KEYS, PROCESS_TRANSPORT_SPAN_KEYS

    ts = _client(fleet).transport_stats(include_worker=True)
    worker = ts.pop("worker")
    assert frozenset(ts) == PROCESS_TRANSPORT_KEYS and frozenset(ts["spans"]) == PROCESS_TRANSPORT_SPAN_KEYS
    assert ts["transport"] == "binary" and set(worker) == {"copies", "rings", "sender", "responder_batches",
                                                          "responder_acks"}


def test_submit_by_reference_matches_submit(fleet):
    """The zero-copy seams: a pair written into reserved request slots and
    submitted by reference gives the plain ``submit``'s flow bit for bit,
    with no copy into the ring; with ``lease_flow`` the flow is a view of
    the worker's response slot, held until ``release()`` (twice is once);
    an abandoned reservation goes back. Every slot of both rings ends
    free."""
    c = _client(fleet)
    rng = np.random.default_rng(18)
    im1, im2 = _image(rng), _image(rng)
    want = c.submit(im1, im2)

    def refs():
        out = []
        for im in (im1, im2):
            slot, view = c.reserve_request_slot(im.nbytes)
            view[:] = im.tobytes()
            view.release()
            out.append(port_ipc.ShmRing.make_ref(slot, im.shape, im.dtype))
        return out

    def rings():
        ts = c.transport_stats(include_worker=True)
        return ts["rings"]["req"], ts["worker"]["rings"]["resp"]

    assert c.transport_zero_copy
    req0, resp0 = rings()
    got = c.submit_refs(*refs())
    leased, release = c.submit_refs(*refs(), lease_flow=True)
    assert np.array_equal(got.flow, want.flow) and np.array_equal(leased.flow, want.flow)
    assert got.flow.flags["OWNDATA"] and not leased.flow.flags["OWNDATA"]
    assert rings()[1]["free"] == resp0["free"] - 1  # the leased slot is held
    flow = leased.flow.copy()
    del leased
    release()
    release()
    c.release_request_slot(c.reserve_request_slot(16)[0])
    t0 = time.monotonic()
    while True:
        req, resp = rings()
        if req["free"] == req["slots"] and resp["free"] == resp["slots"]:
            break
        assert time.monotonic() - t0 < 10.0, (req, resp)
        time.sleep(0.01)
    assert np.array_equal(flow, want.flow)
    assert (req["puts"] - req0["puts"], req["copies_in"] - req0["copies_in"]) == (5, 0)
    assert (resp["puts"] - resp0["puts"], resp["copies_in"] - resp0["copies_in"]) == (2, 2)


def test_refused_items_release_their_ring_views(fleet):
    """A pair the engine refuses at admission (a non-finite image, mismatched
    shapes, a draining engine) keeps no borrowed ring view alive once the
    burst is admitted, so the ring's mapping closes: with the collector off,
    ``SharedMemory.close()`` raises ``BufferError`` while any view lives.
    The accepted pair's flow is the plain ``submit``'s."""
    import gc

    rng = np.random.default_rng(17)
    ring = port_ipc.ShmRing(1 << 16, 8)
    sent, done = [], []

    def burst(eng, pairs):
        msgs = [{"op": "submit", "id": i, "im1": ring.put(a), "im2": ring.put(b)} for i, (a, b) in enumerate(pairs)]
        slots = port_worker._submit_borrowed(
            eng, ring, msgs, lambda mid, req, include_trace=False: done.append(
                (mid, type(req.error).__name__ if req.error is not None else req.result.flow)), sent.append)
        assert sorted(slots) == sorted(s for m in msgs for s in (m["im1"]["slot"], m["im2"]["slot"]))
        for s in slots:
            ring.free(s)

    ok = (_image(rng), _image(rng))
    gc.disable()
    try:
        with fleet.factory().start() as eng:
            want = eng.submit(*ok)
            burst(eng, [ok, (np.full(HW + (3,), np.nan, np.float32), _image(rng)), (_image(rng), _image(rng, (44, 60)))])
            t0 = time.monotonic()
            while len(done) < 3:
                assert time.monotonic() - t0 < 30.0, done
                time.sleep(0.01)
            assert eng.drain(timeout=10.0)
            burst(eng, [ok])
        ring._shm.close()
    finally:
        gc.enable()
        ring.close()
    assert not sent
    assert sorted(d for d in done if isinstance(d[1], str)) == [(0, "Draining"), (1, "InvalidInput"),
                                                               (2, "InvalidInput")]
    assert np.array_equal([d for d in done if not isinstance(d[1], str)][0][1], want.flow)


def test_borrowed_slots_overwritten_after_admission(fleet):
    """The worker borrows request tensors as ring views and frees the slots
    as soon as admission returns. Every freed slot is scribbled over before
    the ring may reuse it: the flows stay the in-process engine's (within
    the batching bound of ``tests/test_torch_serve_router.py``). Four
    pairs go at once, so a flush of freed slots arrives while requests are
    still in the engine (checked: some scribble landed before any result)."""
    c = _client(fleet)
    ring = c._req_ring
    free = ring.free
    done = [0]
    early = []

    def scribble(slot):
        ring.slot_view(slot, ring.slot_bytes)[:] = b"\xa5" * ring.slot_bytes
        early.append(done[0])
        free(slot)

    rng = np.random.default_rng(14)
    for attempt in range(3):
        pairs = [(_image(rng), _image(rng)) for _ in range(4)]
        want = [fleet.ref.submit(*p) for p in pairs]
        got = [None] * 4
        early.clear()
        done[0] = 0
        gate = threading.Barrier(4)

        def one(i):
            gate.wait()
            got[i] = c.submit(*pairs[i])
            done[0] += 1

        ring.free = scribble
        try:
            threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        finally:
            del ring.free
        for g, w in zip(got, want):
            # four at once share pool ticks, the references ran alone: the
            # router tests' batching bound (a scribbled input moves pixels)
            np.testing.assert_allclose(g.flow, w.flow, rtol=0, atol=1e-5)
        if early and min(early) == 0:
            break
    assert early and min(early) == 0, "no freed slot was scribbled over while its requests were in the engine"


ADMISSION_CASES = {"pool": ("reject", HW), "tiled": ("tiled", (60, 100)), "slow_path": ("slow_path", (50, 70))}


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_owns_its_inputs(fleet, case):
    """What the worker relies on when it frees borrowed request slots as
    ``submit_many`` returns: the engine never reads its inputs after that,
    on the pool path (queued, served later), the tiled path and the slow
    path (served inline). The images live in one buffer, as in a ring slot,
    scribbled over the moment ``submit_many`` returns: the flows are the
    plain ``submit``'s of the same images, bit for bit."""
    unknown_shape, hw = ADMISSION_CASES[case]
    rng = np.random.default_rng(16)
    im1, im2 = _image(rng, hw), _image(rng, hw)
    buf = bytearray(im1.tobytes() + im2.tobytes())
    n = im1.size
    v1 = np.frombuffer(buf, np.uint8, n).reshape(im1.shape)
    v2 = np.frombuffer(buf, np.uint8, n, offset=n).reshape(im2.shape)
    with fleet.factory(unknown_shape=unknown_shape).start() as eng:
        want = eng.submit(im1, im2)
        handle = eng.submit_many([{"image1": v1, "image2": v2}])[0]
        buf[:] = b"\x5a" * len(buf)
        assert handle.wait(60) and handle.error is None
        got = handle.result
    assert got.flow.shape == hw + (2,) and np.array_equal(got.flow, want.flow)
    assert got.slow_path == (case == "slow_path") and got.tiled == (case == "tiled")


def test_autoscaler_scale_up_clones_the_process_backend(fleet):
    """An ``Autoscaler`` below its floor adds a replica cloned from the
    first: the process backend and its worker options, a second worker with
    a PID of its own."""
    router = fleet.router
    assert len(router.replicas) == 1, "the scale-up starts from the fleet's first replica alone"
    scaler = Autoscaler(router, AutoscaleConfig(min_replicas=2, max_replicas=2, eval_interval_s=0.05,
                                                cooldown_s=0.0))
    t0 = time.monotonic()
    while not (len(router.replicas) == 2 and all(r.state == ReplicaState.HEALTHY for r in router.replicas)):
        assert time.monotonic() - t0 < 60.0, "the scale-up did not happen"
        time.sleep(0.05)
    r0, r1 = router.replicas
    assert r1.backend == "process" and r1.worker_options == r0.worker_options
    assert isinstance(r1.engine, ProcessEngineClient) and r1.engine.pid not in (r0.engine.pid, None)
    os.kill(r1.engine.pid, 0)
    assert [a["action"] for a in scaler.snapshot()["actions"]] == ["up"]


def test_sigkill_under_flood_loses_nothing_and_readmits(fleet):
    """Two process replicas under a flood of 4 clients; one worker is
    SIGKILLed while it holds work: its requests re-route (none lost), the
    dead PID is evicted, and the factory readmits a new PID that serves."""
    router = fleet.router
    victim, _ = _fleet_of_two(fleet)
    pid0 = victim.engine.pid
    lost, results = [], []
    stop = threading.Event()

    def client(i):
        r = np.random.default_rng(100 + i)
        while not stop.is_set():
            try:
                results.append(router.submit(_image(r), _image(r), deadline_ms=60000.0))
            except Overloaded as e:
                stop.wait(min(e.retry_after_ms, 100.0) / 1e3)
            except ServeError as e:
                lost.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    try:
        t0 = time.monotonic()
        while victim.inflight < 1 and time.monotonic() - t0 < 10.0:
            time.sleep(0.002)
        os.kill(pid0, signal.SIGKILL)
        while router.stats()["router"]["readmissions"] < 1:
            assert time.monotonic() - t0 < 90.0, "the killed replica was not readmitted"
            time.sleep(0.05)
        time.sleep(0.3)  # the healed fleet serves
    finally:
        stop.set()
        for t in threads:
            t.join(60.0)
    st = router.stats()
    assert not lost, lost[:5]
    assert results and all(np.isfinite(r.flow).all() for r in results)
    assert st["router"]["evictions"] >= 1 and st["router"]["readmissions"] >= 1
    assert victim.generation >= 2 and victim.engine.pid not in (pid0, None)
    os.kill(victim.engine.pid, 0)
    with pytest.raises(ProcessLookupError):
        os.kill(pid0, 0)
    assert victim.state == ReplicaState.HEALTHY
    assert np.isfinite(victim.engine.submit(_image(np.random.default_rng(1)),
                                            _image(np.random.default_rng(2))).flow).all()
    assert {k for k in st["engines"]["r0"]} == set(fleet.ref.stats()) | {"transport"}


def test_live_eviction_dumps_the_workers_bundle(fleet):
    """Evicting a live process replica pulls the worker's own flight-recorder
    bundle into ``dump_dir`` before the worker stops: a valid bundle from
    the worker's PID naming the eviction; the worker exits."""
    router = fleet.router
    _, live = _fleet_of_two(fleet)
    pid = live.engine.pid
    router._evict(live, "test: operator eviction")
    live.cooldown_until = time.monotonic() + 3600.0  # no readmission: this test spawns no worker
    bundles = sorted(f for f in os.listdir(fleet.dump_dir) if f.startswith("postmortem_") and f.endswith(".json"))
    assert bundles, "the worker's postmortem must land in dump_dir"
    with open(os.path.join(fleet.dump_dir, bundles[-1])) as f:
        bundle = json.load(f)
    assert validate_bundle(bundle) == [] and "evict:r1" in bundle["reason"] and bundle["pid"] == pid
    t0 = time.monotonic()
    while True:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        assert time.monotonic() - t0 < 30.0, "the evicted worker did not exit"
        time.sleep(0.05)


def test_drain_then_typed_refusal(fleet):
    """A drain crosses the wire: quiesced, ``health()`` reads draining at
    once (the TTL cache is dropped), and the next submit is refused with
    ``Draining`` carrying the engine's hint, as the in-process engine
    refuses it."""
    c = _client(fleet)
    rng = np.random.default_rng(15)
    assert c.drain(timeout=10.0) is True and c.health()["draining"] is True
    assert fleet.ref.drain(timeout=10.0) is True
    with pytest.raises(Draining) as got:
        c.submit(_image(rng), _image(rng))
    with pytest.raises(Draining) as want:
        fleet.ref.submit(_image(rng), _image(rng))
    assert _error(got.value) == _error(want.value) and got.value.retryable


def test_stopped_client_raises_engine_stopped(fleet):
    """After the router closes, no worker of the fleet is left and a call on
    a stopped client raises ``EngineStopped``."""
    pids = [r.engine.pid for r in fleet.router.replicas if r.engine is not None]
    c = _client(fleet)
    fleet.router.close()
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    with pytest.raises(EngineStopped):
        c.health()


# -- one scripted sequence through both packages' clients ------------------------


def _stub_sequence(client_cls, pkg):
    """Pairs whose labels script the stub's outcomes, a burst from 4 threads
    (sorted by label), a stream, introspection, a drain; every outcome."""
    client = client_cls(StubFactory(pkg), ring_slots=16, slot_bytes=1 << 12).start()
    try:
        def pair(label):
            im = np.full((4, 6, 3), label, np.uint8)
            try:
                r = client.submit(im, im)
            except Exception as e:  # noqa: BLE001 -- the outcome is the error
                return ("error",) + _error(e)
            d = dataclasses.asdict(r)
            flow = d.pop("flow")
            return ("ok", d, None if flow is None else flow.tolist())

        out = [pair(label) for label in (1, 3, 5, 7, 9, 11, 13, 2)]
        burst = [None] * 4
        ts = [threading.Thread(target=lambda i=i: burst.__setitem__(i, pair(20 + i))) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        out.append(("burst", sorted(b[2][0][0][0] for b in burst), sorted(b[1]["rid"] for b in burst)))
        st = client.open_stream()
        frames = [st.submit(np.full((4, 6, 3), 30 + i, np.uint8)) for i in range(3)]
        st.close()
        out.append(("stream", [(f.primed, None if f.flow is None else float(f.flow[0, 0, 0])) for f in frames]))
        stats = client.stats()
        transport = stats.pop("transport")
        # the counts that do not move with the burst's framing (free slots,
        # waits and the high-water mark follow when frees piggyback)
        rings = {k: {f: r[f] for f in ("slots", "slot_bytes", "puts", "copies_in", "copies_out")}
                 for k, r in transport["rings"].items()}
        out.append(("stats", stats, rings, sorted(transport)))
        out.append(("health", client.health(), client.alerts(), client.prometheus()))
        out.append(("drain", client.drain(timeout=5.0), client.health()["draining"], pair(1)))
        out.append(("events", [e["kind"] for e in client.recorder.events()], client.tracer.snapshot()))
        return out, client.pid
    finally:
        if pkg == "jax":
            # the JAX client joins its worker before it hangs up, while the
            # worker blocks on the socket: its close() can wait out 10 s
            # (ROADMAP R6). Hang up first, as the port's close() does
            client._sock.shutdown(socket.SHUT_RDWR)
        client.close()


def test_stub_sequence_matches_jax_client():
    """One JAX worker and one port worker over the same stub script: the
    same results (flows, rids, every field), typed errors (class, message,
    hint, buckets), burst, stream, stub counters, ring counts, health,
    drain and recorder events; both workers gone after ``close()``."""
    got, gpid = _stub_sequence(ProcessEngineClient, "port")
    want, wpid = _stub_sequence(jax_worker.ProcessEngineClient, "jax")
    assert got == want
    for pid in (gpid, wpid):
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    kinds = [o[0] if o[0] != "error" else o[1] for o in got[:8]]
    assert kinds == ["ok", "Overloaded", "PoisonedInput", "InvalidInput", "DeadlineExceeded", "ServeError",
                     "ShapeRejected", "ok"]
    assert got[1][3] == 30.0 and got[6][5] == ((48, 64),)
    assert got[-2][0] == "drain" and got[-2][1:3] == (True, True) and got[-2][3][1] == "Draining"


# -- a process candidate ---------------------------------------------------------


def test_process_candidate_promoted_without_shadow_counters():
    """A thread fleet of two stub replicas and a process candidate: shadow ->
    canary -> promoting -> promoted, nothing lost. The candidate's mirrors
    carry no ``shadow`` key: they land in its worker's live counters (every
    mirror and canary request counted there, no ``shadow_*``), never in the
    fleet's ``shadow_*`` counters; promotion rebuilds the replicas on the
    candidate's factory, and the candidate's worker is gone after."""
    router = ServeRouter.from_factory(StubFactory("port", "r"), 2, RouterConfig(heartbeat_interval_s=60.0)).start()
    try:
        ctrl = router.add_candidate(StubFactory("port", "cand"), backend="process",
                                    worker_options=dict(ring_slots=4, slot_bytes=1 << 12),
                                    rollout_config=RolloutConfig(**LADDER))
        cand = ctrl.candidate.engine
        assert isinstance(cand, ProcessEngineClient) and not ctrl._shadow_kw
        pid = cand.pid
        outs = []
        for label in (1, 2, 4, 6):
            outs.append(router.submit(np.full((4, 6, 3), label, np.uint8), np.zeros((4, 6, 3), np.uint8)))
        _drain(ctrl)
        ctrl.maybe_observe()
        assert ctrl.stage == "canary"
        for label in (8, 10, 12, 14):
            outs.append(router.submit(np.full((4, 6, 3), label, np.uint8), np.zeros((4, 6, 3), np.uint8)))
        _drain(ctrl)
        cst = cand.stats()
        fleet = router.stats()
        ctrl.maybe_observe()
        snap = ctrl.wait(timeout=30.0)
    finally:
        router.close()
    assert all(np.isfinite(o.flow).all() for o in outs)
    assert snap["stage"] == "promoted" and [h["stage"] for h in snap["stage_history"]] == [
        "shadow", "canary", "promoting", "promoted"]
    mirrored, canary = fleet["router"]["mirrored"], fleet["router"]["canary_routed"]
    assert mirrored == 6 and canary == 2  # a canary-routed request is not mirrored
    assert cst["submitted"] == cst["completed"] == mirrored + canary and cst["shadow_submitted"] == 0
    assert all(v == 0 for e in fleet["engines"].values() for k, v in e.items() if k.startswith("shadow"))
    assert {s["variables_hash"] for s in router.stats()["replicas"].values()} == {"stub-cand"}
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
