"""Process-per-replica serving: one ServeEngine per worker process.

The port's copy of the process backend of the JAX package's
``raft_tpu/serve/worker.py`` (the TCP remote arm is ROADMAP queue 1 item
4b-ii). Thread replicas share one interpreter, one GIL and, on the card,
one CUDA context: a crashed or wedged engine takes the process with it.
This module crosses the process boundary: a :class:`ProcessEngineClient`
in the router's process speaks the exact
:class:`~raft_tpu_torch.serve.ServeEngine` surface (``submit`` /
``submit_frame`` / ``open_stream`` / ``close_stream`` / ``health`` /
``stats`` / ``alerts`` / ``prometheus`` / ``drain`` / ``close``), while
the engine itself (model, weights, captured CUDA graphs, worker thread,
slot pool) lives in a child **worker process** with its own interpreter,
its own GIL and its own CUDA context.

Mechanics:

* **spawn, never fork**: a forked child cannot use CUDA (the parent's
  context does not survive a fork); ``multiprocessing.get_context
  ("spawn")`` gives each worker a fresh interpreter that imports torch
  itself. The engine factory is pickled into the child and called there,
  so each worker pays its own ``import torch``, CUDA context, cuDNN
  timing and graph captures at every boot and respawn (a CUDA graph holds
  its process's pointers: nothing is shared between workers). Card
  memory is per process: the parent's ``torch.cuda.memory_reserved()``
  cannot see a worker's.
* **control channel**: a Unix-domain socket carries length-prefixed
  control messages (:mod:`raft_tpu_torch.serve.ipc`), multiplexed by id,
  so any number of router dispatch threads share one connection. Both
  sides speak the compact struct-packed binary codec and **coalesce
  RPCs** (the client drains every pending submit into one multi-submit
  frame per socket write, the worker feeds that burst to the engine queue
  under ONE lock acquisition,
  :meth:`~raft_tpu_torch.serve.ServeEngine.submit_many`, and acks
  completions in batched frames). A submit carries its trace id and its
  QoS class and tenant when the caller gives them.
  Typed serving errors round-trip by name with their payload
  (``Overloaded``/``Draining`` keep ``retry_after_ms``), so the router's
  shed/migrate/re-route classification is backend-blind.
* **shared-memory tensor transport**: frame tensors cross through
  :class:`~raft_tpu_torch.serve.ipc.ShmRing` slot pools (one per
  direction), referenced from the control messages by ``{slot, shape,
  dtype}``; the sockets never carry pixels. A full ring sheds with the
  retryable ``Overloaded`` carrying an occupancy x EWMA-hold
  ``retry_after_ms`` hint: flow control, not failure. Size the rings
  (``ring_slots`` x ``slot_bytes``, one ring per direction) to
  ``/dev/shm``: the segment is created sparse, and a write past a small
  ``/dev/shm`` kills the worker with SIGBUS. The worker borrows request
  tensors as zero-copy ring views just long
  enough for admission to normalize them into the engine's own arrays
  (then frees the slots in one batched message), and the parent exposes
  :meth:`ProcessEngineClient.submit_refs` /
  :meth:`ProcessEngineClient.reserve_request_slot` so a caller can fill
  ring slots in place. Every copy the transport does pay is counted
  (:meth:`ProcessEngineClient.transport_stats`) and span-timed (pack /
  ring_wait / rpc / unpack ride the tracer when sampling is on).
* **death is a first-class outcome**: the reader thread turns a broken
  control channel (SIGKILL, OOM-kill, a crashed runtime) into
  ``EngineStopped`` for every pending and future call, which is exactly
  the signal the router's dispatch-fault path evicts on immediately;
  respawn goes through the same factory rebuild as any readmission, with
  a brand-new PID, rings and socket. A worker exits when its socket
  closes, so no worker outlives its parent.
* **postmortems cross the boundary**: pass ``dump_dir`` and the worker
  wires a :func:`~raft_tpu_torch.obs.recorder.file_sink` into its
  engine's flight recorder, so watchdog/alert auto-dumps land in the
  *parent's* dump directory; :meth:`ProcessEngineClient.dump_postmortem`
  pulls a bundle on demand (the router calls it best-effort on eviction).

The engine factory must be **picklable** (a module-level function or
class instance, not a closure): spawn re-imports its defining module in
the child and calls it there, so that module must do no work at import.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import socket
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from raft_tpu_torch.obs.trace import TraceContext
from raft_tpu_torch.serve import ipc
from raft_tpu_torch.serve.config import ServeConfig
from raft_tpu_torch.serve.errors import EngineStopped, Overloaded, ServeError

__all__ = [
    "ProcessEngineClient",
    "config_from_wire",
    "serve_result_to_wire",
]

# RPC grace on top of the request's own deadline: the engine enforces
# deadlines itself; the client timeout is only the wedged-worker backstop
# (and surfaces as a replica fault, never as the caller's deadline).
_RPC_GRACE_S = 15.0
# how long a worker may take from spawn to ready (imports, CUDA context,
# cuDNN timing, graph captures); a dead child fails at once regardless
_BOOT_TIMEOUT_S = 300.0
# the worker's RPC pool: stream frames, drains and shutdowns ride it
_RPC_WORKERS = 16
# how long a health() answer serves the router's dispatch scoring before
# the next probe crosses the wire
_HEALTH_TTL_S = 0.02


def config_from_wire(d: Dict[str, Any]) -> ServeConfig:
    """Rebuild the worker engine's ServeConfig from its JSON form (the
    handshake payload): tuple-typed fields come back from JSON as lists
    and are re-tupled so the parent-side config is a real, validated
    :class:`~raft_tpu_torch.serve.ServeConfig` — not a lookalike namespace."""
    kw = dict(d)
    kw["buckets"] = tuple(tuple(b) for b in kw.get("buckets", ()))
    for f in ("ladder", "batch_ladder"):
        if kw.get(f) is not None:
            kw[f] = tuple(kw[f])
    # the JAX client leaves the quotas as lists; re-tupled, the parent's
    # config equals the worker's
    kw["qos_tenant_quotas"] = tuple(tuple(q) for q in kw.get("qos_tenant_quotas", ()))
    return ServeConfig(**kw)


def _result_fields(res) -> Dict[str, Any]:
    """The tensor-free half of a ServeResult as a control-message dict —
    the shm-ring wire form (:func:`serve_result_to_wire`) adds the flow's
    ring reference. ``tiled``/``tiles`` do not cross the wire (the JAX
    wire's key set)."""
    return {
        "rid": res.rid,
        "bucket": list(res.bucket),
        "num_flow_updates": res.num_flow_updates,
        "level": res.level,
        "degraded": res.degraded,
        "latency_ms": res.latency_ms,
        "slow_path": res.slow_path,
        "retried_single": res.retried_single,
        "primed": res.primed,
        "exit_reason": res.exit_reason,
        "trace_id": res.trace_id,
        "residuals": (
            None if res.residuals is None else [float(x) for x in res.residuals]
        ),
        "warm_started": res.warm_started,
        "flow": None,
    }


def serve_result_to_wire(
    res, resp_ring: ipc.ShmRing, *, timeout: float = 5.0,
    trace_rec: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """A ServeResult as a control-message dict, flow via the shm ring.

    ``trace_rec`` piggybacks the worker's sealed trace record
    on the reply — only for requests that arrived with a propagated
    ``trace_id``, so the hot-path result shape (and its struct-packed
    wire fast path) is untouched for everything else.
    """
    d = _result_fields(res)
    if trace_rec is not None:
        d["trace"] = trace_rec
    if res.flow is not None:
        # the response ring tolerates a slow parent for a few seconds
        # before shedding (the parent frees a slot per response it reads)
        d["flow"] = resp_ring.put(
            np.asarray(res.flow, np.float32), timeout=timeout
        )
    return d


def _serve_result_from_wire(d: Dict[str, Any], flow):
    from raft_tpu_torch.serve.engine import ServeResult

    return ServeResult(
        flow=flow,
        rid=int(d["rid"]),
        bucket=tuple(d["bucket"]),
        num_flow_updates=int(d["num_flow_updates"]),
        level=int(d["level"]),
        degraded=bool(d["degraded"]),
        latency_ms=float(d["latency_ms"]),
        slow_path=bool(d["slow_path"]),
        retried_single=bool(d["retried_single"]),
        primed=bool(d["primed"]),
        exit_reason=str(d["exit_reason"]),
        trace_id=d.get("trace_id"),
        residuals=(
            None if d.get("residuals") is None
            else tuple(d["residuals"])
        ),
        warm_started=bool(d.get("warm_started", False)),
    )


# ---------------------------------------------------------------------------
# Worker process (child side)
# ---------------------------------------------------------------------------


def _drop_frames(err: Optional[BaseException]) -> None:
    """Cut the tracebacks of ``err`` and of the errors it chains. An item
    that ``submit_many`` refuses finishes with its error, whose traceback
    holds the engine's admission frames, and those frames hold the item's
    borrowed ring views in a reference cycle (the frame's handle list
    holds the error): while it stands, the ring's mapping cannot close."""
    todo = [err]
    while todo:
        e = todo.pop()
        if e is not None and e.__traceback__ is not None:
            e.__traceback__ = None
            todo += [e.__cause__, e.__context__]


def _submit_borrowed(
    engine, req_ring: ipc.ShmRing, msgs: List[Dict[str, Any]],
    complete: Callable[..., None], send: Callable[[Dict[str, Any]], None],
) -> List[int]:
    """Admit one received frame's pairwise submits straight from the
    request ring, and return their slots, which may be freed at once.

    Each pair is borrowed as zero-copy ring views and the burst feeds the
    engine queue under ONE lock acquisition (``engine.submit_many``):
    admission normalizes into the engine's own buffers, so no view is
    read after ``submit_many`` returns, and none outlives it (the refused
    items' tracebacks are cut). Completions go to ``complete(mid, req,
    include_trace=...)`` through done-callbacks: no parked thread per
    request.
    """
    items, free_slots = [], []
    for m in msgs:
        mid = m.get("id", -1)
        try:
            im1 = req_ring.get(m["im1"], copy=False)
            im2 = req_ring.get(m["im2"], copy=False)
        except BaseException as e:
            send({"id": mid, "error": ipc.encode_error(e)})
            continue
        free_slots += [int(m["im1"]["slot"]), int(m["im2"]["slot"])]
        traced = m.get("trace_id") is not None
        items.append({
            "image1": im1, "image2": im2,
            "deadline_ms": m.get("deadline_ms"),
            "num_flow_updates": m.get("num_flow_updates"),
            "priority": m.get("priority"),
            "tenant": m.get("tenant"),
            "trace_ctx": _msg_ctx(m),
            "on_done": (
                lambda req, _mid=mid, _tr=traced:
                complete(_mid, req, include_trace=_tr)
            ),
        })
    if items:
        try:
            handles = engine.submit_many(items)
        except BaseException as e:  # belt and braces: never silent
            for m in msgs:
                send({"id": m.get("id", -1), "error": ipc.encode_error(e)})
        else:
            for h in handles:
                _drop_frames(h.error)
    return free_slots


def _msg_ctx(msg: Dict[str, Any]) -> Optional[TraceContext]:
    """The propagated trace context of one submit message (None when the
    caller traced nothing)."""
    tid = msg.get("trace_id")
    return None if tid is None else TraceContext(tid)


class _Responder:
    """The worker's completion coalescer:
    engine done-callbacks post ``(mid, req)`` here from whatever thread
    finished the request; one responder thread drains everything pending
    per wakeup, encodes the results (response tensors into the shm
    ring), and acks the whole burst through the coalescing sender — one
    batched wakeup frame for the parent instead of one write per
    completion. The (possibly blocking) response-ring ``put`` runs HERE,
    never on the engine's batch thread.
    """

    def __init__(
        self,
        sender: ipc.FrameCoalescer,
        resp_ring: ipc.ShmRing,
        *,
        free_flush: int = 8,
    ):
        self._sender = sender
        self._resp_ring = resp_ring
        self._done: List = []
        self._frees: List[int] = []
        self._free_flush = max(1, int(free_flush))
        self._cond = threading.Condition()
        self._stop = False
        self.batches = 0
        self.acks = 0
        self._thread = threading.Thread(
            target=self._run, name="raft-worker-responder", daemon=True
        )
        self._thread.start()

    @staticmethod
    def _trace_rec(req, include_trace: bool):
        """The request's sealed trace record, iff the submit carried a
        propagated trace_id (sealed before done-callbacks fire, so this
        is a plain attribute read on the completion path)."""
        if not include_trace or req.trace is None:
            return None
        return req.trace.record

    def complete(self, mid: int, req, *, include_trace: bool = False) -> None:
        with self._cond:
            self._done.append((mid, req, include_trace))
            self._cond.notify()

    def complete_inline(
        self, mid: int, req, *, include_trace: bool = False
    ) -> None:
        """Encode + ack on the COMPLETING thread — one fewer wakeup on
        the hot path (on one core, thread handoffs are the expensive
        part of the tax). The response-ring put runs with timeout=0:
        when the parent is behind and the ring is full, the completion
        falls back to :meth:`complete`, whose responder thread owns the
        blocking wait — the engine's thread never stalls on a slow
        parent. Pending request-slot frees ride the same frame."""
        if req.error is not None:
            reply = {"id": mid, "error": ipc.encode_error(req.error)}
        else:
            try:
                reply = {
                    "id": mid, "ok": True,
                    "result": serve_result_to_wire(
                        req.result, self._resp_ring, timeout=0.0,
                        trace_rec=self._trace_rec(req, include_trace),
                    ),
                }
            except Overloaded:
                # backpressure: the slow path
                self.complete(mid, req, include_trace=include_trace)
                return
            except BaseException as e:
                reply = {"id": mid, "error": ipc.encode_error(e)}
        with self._cond:
            frees, self._frees = self._frees, []
        msgs: List[Dict[str, Any]] = []
        if frees:
            msgs.append({"op": "free_req", "slots": frees})
        msgs.append(reply)
        try:
            self._sender.send_many(msgs)
        except Exception:
            pass  # a vanished parent is handled by the recv loop
        self.acks += 1

    def add_frees(self, slots: List[int]) -> None:
        """Queue request-ring slots to free — piggybacked onto the next
        reply frame instead of costing their own write + parent wakeup.
        Past ``free_flush`` pending, flush immediately: deferral must
        never starve the parent's allocator under a deep queue."""
        flush = None
        with self._cond:
            self._frees.extend(slots)
            if len(self._frees) >= self._free_flush:
                flush, self._frees = self._frees, []
        if flush is not None:
            try:
                self._sender.send({"op": "free_req", "slots": flush})
            except Exception:
                pass

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._done and not self._stop:
                    self._cond.wait()
                if self._stop and not self._done:
                    return
                batch, self._done = self._done, []
                frees, self._frees = self._frees, []
            replies = []
            if frees:
                replies.append({"op": "free_req", "slots": frees})
            for mid, req, include_trace in batch:
                if req.error is not None:
                    replies.append(
                        {"id": mid, "error": ipc.encode_error(req.error)}
                    )
                else:
                    try:
                        replies.append({
                            "id": mid, "ok": True,
                            "result": serve_result_to_wire(
                                req.result, self._resp_ring,
                                trace_rec=self._trace_rec(
                                    req, include_trace
                                ),
                            ),
                        })
                    except BaseException as e:
                        # a full response ring sheds THIS reply typed and
                        # retryable; the parent re-routes or backs off
                        replies.append(
                            {"id": mid, "error": ipc.encode_error(e)}
                        )
            try:
                self._sender.send_many(replies)
            except Exception:
                pass  # a vanished parent is handled by the recv loop
            self.batches += 1
            self.acks += len(replies)


def _worker_main(spec: Dict[str, Any]) -> None:
    """Child entry point: build + boot the engine, then serve the
    control protocol until the parent hangs up.

    Runs under ``spawn`` in a fresh interpreter; connects *before*
    booting so the parent can distinguish "alive and compiling" from
    "died at import". The parent closing the socket (or dying — the
    socket dies with it) is the worker's shutdown signal, so an orphaned
    worker always exits rather than squatting on a device.
    """
    from concurrent.futures import ThreadPoolExecutor

    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(spec["socket_path"])
    sender = ipc.FrameCoalescer(sock, binary=True, batch=True)

    def send(msg: Dict[str, Any]) -> None:
        try:
            sender.send(msg)
        except Exception:
            pass  # a vanished parent is handled by the recv loop

    engine = None
    try:
        engine = spec["factory"](**(spec.get("overrides") or {}))
        if spec.get("dump_dir"):
            # worker flight-recorder bundles (watchdog trips, page
            # alerts, on-demand eviction dumps) land in the PARENT's
            # dump directory — the postmortem trail survives the worker
            from raft_tpu_torch.obs import file_sink

            engine.recorder.add_sink(file_sink(spec["dump_dir"]))
        engine.start()
    except BaseException as e:  # the parent needs the reason, then die
        send({"op": "ready", "error": repr(e)})
        sock.close()
        os._exit(1)

    req_ring = ipc.ShmRing.attach(**spec["req_ring"])
    resp_ring = ipc.ShmRing.attach(**spec["resp_ring"])
    responder = _Responder(
        sender, resp_ring,
        free_flush=max(4, int(spec["req_ring"]["slots"]) // 4),
    )
    send({
        "op": "ready",
        "pid": os.getpid(),
        "config": dataclasses.asdict(engine.config),
        "boot": engine.stats()["boot"],
    })

    stopping = threading.Event()
    pool = ThreadPoolExecutor(
        max_workers=_RPC_WORKERS, thread_name_prefix="raft-worker-rpc",
    )

    def reply(mid: int, fn: Callable[[], Dict[str, Any]]) -> None:
        try:
            send({"id": mid, "ok": True, "result": fn()})
        except BaseException as e:
            send({"id": mid, "error": ipc.encode_error(e)})

    def _traced_wire(res, msg) -> Dict[str, Any]:
        """Result to wire; a propagated request's sealed trace record
        rides the reply (looked up by the id the edge chose)."""
        rec = None
        if msg.get("trace_id") is not None and res.trace_id is not None:
            rec = engine.tracer.find(res.trace_id)
        return serve_result_to_wire(res, resp_ring, trace_rec=rec)

    def h_submit_frame(msg):
        # stream frames keep per-stream ordering state in the engine and
        # ride the pool one at a time: copied out, the slot freed at once
        frame = req_ring.get(msg["frame"])
        send({"op": "free_req", "slots": [msg["frame"]["slot"]]})
        res = engine.submit_frame(
            int(msg["stream_id"]), frame,
            deadline_ms=msg.get("deadline_ms"),
            num_flow_updates=msg.get("num_flow_updates"),
            trace_ctx=_msg_ctx(msg),
            priority=msg.get("priority"),
            tenant=msg.get("tenant"),
        )
        return _traced_wire(res, msg)

    def h_submits(msgs: List[Dict[str, Any]]) -> None:
        """One received frame's submit burst: the pairs through
        :func:`_submit_borrowed`, whose freed slots ride the next reply
        frame (or a bulk flush) instead of buying their own write and
        parent wakeup; the stream frames through the pool."""
        free_slots = _submit_borrowed(
            engine, req_ring, [m for m in msgs if m["op"] == "submit"],
            responder.complete_inline, send,
        )
        if free_slots:
            responder.add_frees(free_slots)
        for m in msgs:
            if m["op"] == "submit_frame":
                pool.submit(
                    reply, m.get("id", -1), lambda _m=m: h_submit_frame(_m)
                )

    def h_shutdown(msg):
        engine.close(
            graceful=bool(msg.get("graceful", False)),
            timeout=msg.get("timeout", 30.0),
        )
        stopping.set()
        return {"stopped": True}

    handlers: Dict[str, Callable[[Dict[str, Any]], Dict[str, Any]]] = {
        "open_stream": lambda m: {
            "stream_id": engine.open_stream().stream_id
        },
        "close_stream": lambda m: (
            engine.close_stream(int(m["stream_id"])) or {}
        ),
        "drain": lambda m: {
            "quiesced": engine.drain(timeout=m.get("timeout", 30.0))
        },
        "shutdown": h_shutdown,
        "health": lambda m: engine.health(),
        # clock-offset estimation: the parent reads this
        # worker's monotonic clock, brackets it with its own, and takes
        # the RPC round-trip midpoint — the offset that aligns stitched
        # cross-process span timestamps (error bound: +-rtt/2)
        "clock": lambda m: {"t": time.monotonic()},
        "stats": lambda m: engine.stats(),
        "alerts": lambda m: engine.alerts(),
        "prometheus": lambda m: {"text": engine.prometheus()},
        "transport": lambda m: {
            "copies": ipc.copies_snapshot(),
            "rings": {"req": req_ring.stats(), "resp": resp_ring.stats()},
            "sender": sender.stats(),
            "responder_batches": responder.batches,
            "responder_acks": responder.acks,
        },
        "events": lambda m: {
            "events": engine.recorder.events(m.get("kind"))[
                -int(m.get("n", 64)):
            ]
        },
        "traces": lambda m: {"traces": engine.tracer.snapshot()},
        "trace_find": lambda m: {
            "trace": engine.tracer.find(m["trace_id"])
        },
        "dump": lambda m: {
            "reason": engine.recorder.dump(
                m.get("reason", "parent-request")
            )["reason"]
        },
    }
    # blocking ops ride the RPC pool so a slow drain never starves a
    # health probe; introspection runs inline on the recv loop
    _POOLED = {"drain", "shutdown"}

    reader = ipc.FrameReader(sock)  # buffered: ~1 syscall per burst
    try:
        while not stopping.is_set():
            try:
                frame = reader.read_msg()
            except ipc.ConnectionClosed:
                break  # parent hung up (or died): shut down with it
            msgs = ipc.iter_messages(frame)
            submits = []
            for msg in msgs:
                op = msg.get("op")
                if op == "free_resp":
                    for s in msg["slots"]:
                        resp_ring.free(int(s))
                    continue
                if op in ("submit", "submit_frame"):
                    submits.append(msg)
                    continue
                fn = handlers.get(op)
                mid = msg.get("id", -1)
                if fn is None:
                    send({"id": mid, "error": ipc.encode_error(
                        ServeError(f"unknown worker op {op!r}")
                    )})
                elif op in _POOLED:
                    pool.submit(reply, mid, lambda m=msg, f=fn: f(m))
                else:
                    reply(mid, lambda m=msg, f=fn: f(m))
            if submits:
                if engine.config.unknown_shape == "reject":
                    # admission + enqueue only — nothing here can block
                    # on the model, so the burst is handled inline with
                    # zero pool handoff (the hot-path default); the
                    # 'slow_path' and 'tiled' arms both run model work
                    # on the submitting thread, so they take the pool
                    h_submits(submits)
                else:
                    # a slow_path config may compile/execute inline in
                    # submit_many; keep that off the recv loop
                    pool.submit(h_submits, submits)
    finally:
        stopping.set()
        responder.stop()
        try:
            engine.close(graceful=False)
        except Exception:
            pass
        pool.shutdown(wait=False)
        try:
            sock.close()
        except Exception:
            pass
        req_ring.close()
        resp_ring.close()


# ---------------------------------------------------------------------------
# Parent side
# ---------------------------------------------------------------------------


class _RemoteTracer:
    """Read-only view of the worker engine's tracer (postmortem path:
    never raises — a dead worker simply contributes no traces)."""

    def __init__(self, client: "ProcessEngineClient"):
        self._client = client

    def snapshot(self):
        # the worker engine's request traces, plus this client's local
        # 'transport'-kind traces (pack/ring_wait/rpc spans) —
        # one stream, so phase breakdowns and postmortems see both.
        # Deduplicated by trace_id: under propagation a sampled request
        # exists both as the worker's record and as a stitched
        # parent-side record under the SAME id — returning both would
        # double-count its phases in a phase breakdown. The richer
        # record (more spans) wins.
        from raft_tpu_torch.obs.trace import dedupe_traces

        tx = getattr(self._client, "_txtracer", None)
        local = tx.snapshot() if tx is not None else []
        try:
            worker = self._client._call("traces", timeout=10.0)["traces"]
        except Exception:
            worker = []
        return dedupe_traces(worker + local)

    def find(self, trace_id: str):
        try:
            return self._client._call(
                "trace_find", {"trace_id": trace_id}, timeout=10.0
            )["trace"]
        except Exception:
            return None


class _RemoteRecorder:
    """Read-only view of the worker engine's flight-recorder ring."""

    def __init__(self, client: "ProcessEngineClient"):
        self._client = client

    def events(self, kind: Optional[str] = None, n: int = 64):
        try:
            return self._client._call(
                "events", {"kind": kind, "n": n}, timeout=10.0
            )["events"]
        except Exception:
            return []


class ProcessEngineClient:
    """The parent-side half of one worker process, shaped like an engine.

    Drop-in for the surface :class:`~raft_tpu_torch.serve.replica.Replica`
    and :class:`~raft_tpu_torch.serve.router.ServeRouter` drive, so the router's
    dispatch/eviction/drain machinery is backend-blind. Lifecycle
    mirrors the engine: construct (cheap), :meth:`start` (spawn + boot +
    handshake), serve, :meth:`drain` / :meth:`close`. After the worker
    dies — for any reason — every call raises ``EngineStopped``; the
    recovery path is a rebuild through the replica factory, exactly like
    a wedged thread engine.
    """

    def __init__(
        self,
        factory: Callable[..., Any],
        overrides: Optional[Dict[str, Any]] = None,
        *,
        ring_slots: int = 32,
        slot_bytes: int = 16 * 1024 * 1024,
        dump_dir: Optional[str] = None,
    ):
        self._factory = factory
        self._overrides = dict(overrides or {})
        self._ring_slots = int(ring_slots)
        self._slot_bytes = int(slot_bytes)
        self._dump_dir = dump_dir
        # worker monotonic clock minus ours, estimated from the clock
        # RPC round-trip midpoint post-handshake (re-estimated on every
        # start(), i.e. on reconnect); 0 until estimated. The stitcher
        # uses it to align absorbed worker spans; rtt/2 bounds its error.
        self.clock_offset_s = 0.0
        self.clock_rtt_s: Optional[float] = None
        self.config: Optional[ServeConfig] = None
        self.boot: Dict[str, Any] = {}
        self.pid: Optional[int] = None
        self.tracer = _RemoteTracer(self)
        self.recorder = _RemoteRecorder(self)
        self._proc = None
        self._sock: Optional[socket.socket] = None
        self._sender: Optional[ipc.FrameCoalescer] = None
        self._tmpdir: Optional[str] = None
        self._req_ring: Optional[ipc.ShmRing] = None
        self._resp_ring: Optional[ipc.ShmRing] = None
        self._pending: Dict[int, Dict[str, Any]] = {}
        self._plock = threading.Lock()
        self._ids = itertools.count()
        self._reader: Optional[threading.Thread] = None
        self._started = False
        self._dead = False
        self._dead_reason = "worker not started"
        self._health_cache: Optional[Dict[str, Any]] = None
        self._health_t = 0.0
        self.health_cache_hits = 0
        self.health_cache_misses = 0
        # transport spans (pack / ring_wait / rpc / unpack): bounded
        # per-span sample rings feeding transport_stats() quantiles
        self._span_ms: Dict[str, Any] = {
            name: collections.deque(maxlen=512)
            for name in ("pack", "ring_wait", "rpc", "unpack")
        }
        self._txtracer = None  # obs tracer, built once sampling is known
        self.msgs_received = 0
        self.frames_received = 0
        self.bytes_received = 0
        # response-ring frees piggyback on the next outgoing call frame
        # instead of buying their own socket write;
        # past the flush threshold they go out on their own anyway so
        # deferral never starves the worker's response allocator
        self._resp_frees: List[int] = []
        self._resp_free_lock = threading.Lock()
        self._resp_free_flush = max(4, self._ring_slots // 4)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ProcessEngineClient":
        """Spawn the worker, wait for its engine to boot, handshake."""
        if self._started and not self._dead:
            return self
        if self._dead and self._proc is not None:
            raise EngineStopped(
                f"worker died ({self._dead_reason}); build a new one"
            )
        import multiprocessing as mp

        self._tmpdir = tempfile.mkdtemp(prefix="raft-worker-")
        path = os.path.join(self._tmpdir, "ctl.sock")
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        listener.bind(path)
        listener.listen(1)
        listener.settimeout(30.0)
        self._req_ring = ipc.ShmRing(self._slot_bytes, self._ring_slots)
        self._resp_ring = ipc.ShmRing(self._slot_bytes, self._ring_slots)
        spec = {
            "socket_path": path,
            "factory": self._factory,
            "overrides": self._overrides,
            "req_ring": self._req_ring.geometry(),
            "resp_ring": self._resp_ring.geometry(),
            "dump_dir": self._dump_dir,
        }
        ctx = mp.get_context("spawn")  # a forked child cannot use CUDA
        try:
            self._proc = ctx.Process(
                target=_worker_main, args=(spec,), daemon=True
            )
            self._proc.start()
        except Exception as e:
            listener.close()
            self._teardown_transport()
            raise ServeError(
                f"failed to spawn worker process (the engine factory must "
                f"be picklable — a module-level function or class "
                f"instance, not a closure): {e!r}"
            ) from e
        try:
            conn, _ = listener.accept()
        except socket.timeout:
            self._kill_process()
            self._teardown_transport()
            raise ServeError(
                "worker process never connected (died at import?)"
            )
        finally:
            listener.close()
        self._sock = conn
        try:
            ready = self._wait_ready(conn)
        except Exception:
            self._kill_process()
            self._teardown_transport()
            raise
        if "error" in ready:
            self._kill_process()
            self._teardown_transport()
            raise ServeError(f"worker engine boot failed: {ready['error']}")
        self.pid = int(ready["pid"])
        self._sender = ipc.FrameCoalescer(conn, binary=True, batch=True)
        self.config = config_from_wire(ready["config"])
        self.boot = dict(ready["boot"])
        # transport traces ride the same sampling dial as the engine's
        # own request traces; rate 0 = off, zero overhead
        from raft_tpu_torch.obs import Tracer

        self._txtracer = Tracer(
            self.config.trace_sample_rate, prefix="x", capacity=128
        )
        self._dead = False
        self._started = True
        self._reader = threading.Thread(
            target=self._read_loop, name="raft-worker-client-reader",
            daemon=True,
        )
        self._reader.start()
        self._estimate_clock_offset()
        return self

    def _estimate_clock_offset(self) -> None:
        """Cross-process monotonic-clock alignment: read the
        worker's clock, bracket it with ours, take the round-trip
        midpoint. Best of 3 round trips (tightest rtt = tightest error
        bound)."""
        best_rtt = None
        for _ in range(3):
            t0 = time.monotonic()
            tw = float(self._call("clock", timeout=5.0)["t"])
            t1 = time.monotonic()
            rtt = t1 - t0
            if best_rtt is None or rtt < best_rtt:
                best_rtt = rtt
                self.clock_offset_s = tw - (t0 + t1) / 2.0
        self.clock_rtt_s = best_rtt

    def _wait_ready(self, conn: socket.socket) -> Dict[str, Any]:
        """Poll for the ready message while watching the process: a boot
        can legitimately take minutes (compile fallback), but a dead
        child must fail fast, not eat the whole boot timeout."""
        deadline = time.monotonic() + _BOOT_TIMEOUT_S
        conn.settimeout(1.0)
        try:
            while True:
                try:
                    msg = ipc.recv_msg(conn)
                except socket.timeout:
                    if not self._proc.is_alive():
                        raise ServeError(
                            f"worker process exited during boot (code "
                            f"{self._proc.exitcode})"
                        )
                    if time.monotonic() > deadline:
                        self._kill_process()
                        raise ServeError(
                            f"worker boot exceeded {_BOOT_TIMEOUT_S}s"
                        )
                    continue
                except ipc.ConnectionClosed:
                    raise ServeError(
                        f"worker closed the channel during boot (code "
                        f"{self._proc.exitcode})"
                    )
                if msg.get("op") == "ready":
                    return msg
        finally:
            conn.settimeout(None)

    def is_alive(self) -> bool:
        return (
            self._proc is not None
            and self._proc.is_alive()
            and not self._dead
        )

    def drain(self, *, timeout: Optional[float] = 30.0) -> bool:
        res = self._call(
            "drain", {"timeout": timeout},
            timeout=(timeout or 30.0) + _RPC_GRACE_S,
        )
        # read-your-writes: the next health() must see draining=True,
        # not a pre-drain TTL-cached snapshot
        self._health_cache = None
        return bool(res["quiesced"])

    def stop(self) -> None:
        self.close(graceful=False)

    def close(
        self, graceful: bool = False, *, timeout: Optional[float] = 30.0
    ) -> None:
        """Shut the worker down (gracefully drains in the child when
        asked), then make sure the PID is really gone and the transport
        is reclaimed. Safe on an already-dead worker."""
        if self._started and not self._dead:
            try:
                self._call(
                    "shutdown", {"graceful": graceful, "timeout": timeout},
                    timeout=(timeout or 30.0) + _RPC_GRACE_S,
                )
            except Exception:
                pass  # a worker too broken to ack still gets killed below
        self._mark_dead("worker stopped")
        if self._sock is not None:
            # the hang-up is the worker's exit signal: its receive loop
            # blocks on this socket, so the join below waits for the worker
            # only after the worker has seen the end of the channel (the
            # JAX client joins first, and over a real engine waits out the
            # 10 s)
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._proc is not None:
            self._proc.join(timeout=10.0)
            self._kill_process()
        if self._sock is not None:
            try:
                self._sock.close()
            except Exception:
                pass
            self._sock = None
        self._teardown_transport()

    def _kill_process(self) -> None:
        proc = self._proc
        if proc is None or not proc.is_alive():
            return
        proc.terminate()
        proc.join(timeout=5.0)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=5.0)

    def _teardown_transport(self) -> None:
        for ring in (self._req_ring, self._resp_ring):
            if ring is not None:
                ring.close()
        self._req_ring = self._resp_ring = None
        if self._tmpdir:
            try:
                sockpath = os.path.join(self._tmpdir, "ctl.sock")
                if os.path.exists(sockpath):
                    os.remove(sockpath)
                os.rmdir(self._tmpdir)
            except OSError:
                pass
            self._tmpdir = None

    def __enter__(self) -> "ProcessEngineClient":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- RPC plumbing ------------------------------------------------------

    def _mark_dead(self, reason: str) -> None:
        if self._dead:
            return
        self._dead = True
        self._dead_reason = reason
        self._health_cache = None
        with self._plock:
            pending = list(self._pending.values())
            self._pending.clear()
        for slot in pending:
            slot["error"] = {"type": "EngineStopped", "msg": reason}
            slot["ev"].set()

    def _read_loop(self) -> None:
        """Demultiplex worker responses to their waiting callers; copy
        response tensors out of the shm ring and recycle the slots (one
        batched free message per received frame — the read-side mirror
        of the send coalescer). A broken channel — the worker died —
        fails everything pending with ``EngineStopped`` (the router's
        immediate-eviction signal)."""
        reader = ipc.FrameReader(self._sock)
        try:
            while True:
                frame = reader.read_msg()
                self.frames_received = reader.frames
                self.bytes_received = reader.bytes
                free_slots: List[int] = []
                msgs = ipc.iter_messages(frame)
                self.msgs_received += len(msgs)
                for msg in msgs:
                    if msg.get("op") == "free_req":
                        if self._req_ring is not None:
                            for s in msg["slots"]:
                                self._req_ring.free(int(s))
                        continue
                    with self._plock:
                        slot = self._pending.pop(msg.get("id"), None)
                    if slot is None:
                        continue
                    if "error" in msg:
                        slot["error"] = msg["error"]
                    else:
                        result = msg.get("result") or {}
                        ref = result.get("flow")
                        if isinstance(ref, dict) and not slot.get("lease"):
                            t0 = time.monotonic()
                            result = dict(result)
                            result["flow"] = self._resp_ring.get(ref)
                            slot["unpack_s"] = time.monotonic() - t0
                            free_slots.append(int(ref["slot"]))
                        slot["result"] = result
                    slot["ev"].set()
                if free_slots:
                    self._queue_resp_frees(free_slots)
        except Exception:
            self._mark_dead("worker control channel lost")

    def _queue_resp_frees(self, slots: List[int]) -> None:
        """Defer response-slot frees onto the next outgoing call frame;
        flush standalone once enough accumulate."""
        flush = None
        with self._resp_free_lock:
            self._resp_frees.extend(slots)
            if len(self._resp_frees) >= self._resp_free_flush:
                flush, self._resp_frees = self._resp_frees, []
        if flush is not None:
            try:
                self._sender.send({"op": "free_resp", "slots": flush})
            except Exception:
                pass

    def _take_resp_frees(self) -> List[Dict[str, Any]]:
        with self._resp_free_lock:
            if not self._resp_frees:
                return []
            frees, self._resp_frees = self._resp_frees, []
        return [{"op": "free_resp", "slots": frees}]

    def _free_resp_slot(self, slot: int) -> None:
        """Return a leased response slot to the worker (best-effort: a
        dead worker's ring died with it)."""
        try:
            self._queue_resp_frees([int(slot)])
        except Exception:
            pass

    def _call(
        self,
        op: str,
        payload: Optional[Dict[str, Any]] = None,
        *,
        timeout: float = 30.0,
        lease_flow: bool = False,
    ) -> Dict[str, Any]:
        """One multiplexed RPC. ``lease_flow`` leaves a tensor-carrying
        result's ``flow`` as the raw shm ref instead of copying it out —
        the caller maps the view and frees the slot itself (the front
        door's write-from-the-ring-view path)."""
        if not self._started:
            raise EngineStopped("worker is not running (call start())")
        if self._dead:
            raise EngineStopped(self._dead_reason)
        mid = next(self._ids)
        slot: Dict[str, Any] = {"ev": threading.Event()}
        if lease_flow:
            slot["lease"] = True
        with self._plock:
            self._pending[mid] = slot
        msg = dict(payload or {}, id=mid, op=op)
        try:
            # pending response-slot frees ride this same frame for free
            self._sender.send_many(self._take_resp_frees() + [msg])
        except Exception as e:
            with self._plock:
                self._pending.pop(mid, None)
            self._mark_dead(f"worker send failed: {e!r}")
            raise EngineStopped(self._dead_reason) from e
        if not slot["ev"].wait(timeout):
            with self._plock:
                self._pending.pop(mid, None)
            # NOT the caller's deadline (the engine raises that itself,
            # typed, over the wire): a silent worker is a replica fault
            # the router should re-route around and eventually evict
            raise ServeError(
                f"worker rpc {op!r} timed out after {timeout:.0f}s "
                f"(wedged worker?)"
            )
        if "error" in slot:
            raise ipc.decode_error(slot["error"])
        if "unpack_s" in slot:
            self._span_ms["unpack"].append(slot["unpack_s"] * 1e3)
        return slot["result"]

    # -- the engine surface ------------------------------------------------

    def _effective_deadline(self, deadline_ms: Optional[float]) -> float:
        return (
            deadline_ms
            if deadline_ms is not None
            else self.config.default_deadline_ms
        )

    def _record_spans(
        self, t0: float, t1: float, t2: float, spans: Dict[str, float],
        *, kind: str, ok: bool,
        trace_ctx: Optional[TraceContext] = None,
    ) -> None:
        """One request's transport spans into the sample rings and —
        when sampling is on — the local tracer, whose 'transport'-kind
        traces join :meth:`tracer.snapshot` next to the worker's own
        request traces (one phase-breakdown surface).

        A propagated request (``trace_ctx`` carrying the live edge
        trace) stitches its transport spans straight into the
        edge trace instead — under its ONE trace_id, so the request is
        never double-counted across the local and edge rings."""
        ring_wait_s = spans.get("ring_wait_s", 0.0)
        pack_s = max(0.0, (t1 - t0) - ring_wait_s)
        self._span_ms["pack"].append(pack_s * 1e3)
        self._span_ms["ring_wait"].append(ring_wait_s * 1e3)
        self._span_ms["rpc"].append((t2 - t1) * 1e3)
        if trace_ctx is not None and trace_ctx.trace is not None:
            tr = trace_ctx.trace
            tr.add_span("pack", t0, t0 + pack_s, proc="transport")
            if ring_wait_s:
                tr.add_span("ring_wait", t0 + pack_s, t1, proc="transport")
            tr.add_span("rpc", t1, t2, proc="transport")
            return
        tracer = self._txtracer
        if tracer is None:
            return
        tr = tracer.start(kind, t_start=t0)
        if tr is None:
            return
        tr.add_span("pack", t0, t0 + pack_s)
        if ring_wait_s:
            tr.add_span("ring_wait", t0 + pack_s, t1)
        tr.add_span("rpc", t1, t2)
        tr.finish(ok=ok)

    @staticmethod
    def _wire_fields(
        msg: Dict[str, Any], trace_ctx: Optional[TraceContext],
        priority: Optional[str], tenant: Optional[str],
    ) -> Dict[str, Any]:
        """A submit message with the caller's trace id, QoS class and
        tenant, each only when given."""
        if trace_ctx is not None:
            msg["trace_id"] = trace_ctx.trace_id
        if priority is not None:
            msg["priority"] = priority
        if tenant is not None:
            msg["tenant"] = tenant
        return msg

    def _absorb_worker_trace(
        self, res: Dict[str, Any], trace_ctx: Optional[TraceContext]
    ) -> None:
        """Stitch the reply-piggybacked worker trace record into the
        edge trace, clock-aligned, under a worker-<pid> lane."""
        if trace_ctx is None:
            return
        rec = res.get("trace")
        if rec:
            trace_ctx.absorb(
                rec, proc=f"worker-{self.pid}",
                t_offset_s=self.clock_offset_s,
            )

    def submit(
        self,
        image1,
        image2,
        *,
        deadline_ms: Optional[float] = None,
        num_flow_updates: Optional[int] = None,
        trace_ctx: Optional[TraceContext] = None,
        priority: Optional[str] = None,
        tenant: Optional[str] = None,
    ):
        if self._dead:
            raise EngineStopped(self._dead_reason)
        eff = self._effective_deadline(deadline_ms)
        spans: Dict[str, float] = {}
        t0 = time.monotonic()
        r1 = self._req_ring.put(np.asarray(image1), spans=spans)
        try:
            r2 = self._req_ring.put(np.asarray(image2), spans=spans)
        except BaseException:
            self._req_ring.free(r1["slot"])
            raise
        t1 = time.monotonic()
        msg = {
            "im1": r1,
            "im2": r2,
            "deadline_ms": deadline_ms,
            "num_flow_updates": num_flow_updates,
        }
        self._wire_fields(msg, trace_ctx, priority, tenant)
        try:
            res = self._call(
                "submit", msg, timeout=eff / 1e3 + _RPC_GRACE_S,
            )
        except BaseException:
            self._record_spans(
                t0, t1, time.monotonic(), spans, kind="transport",
                ok=False, trace_ctx=trace_ctx,
            )
            raise
        self._record_spans(
            t0, t1, time.monotonic(), spans, kind="transport", ok=True,
            trace_ctx=trace_ctx,
        )
        self._absorb_worker_trace(res, trace_ctx)
        return _serve_result_from_wire(res, res.get("flow"))

    # -- zero-copy seams (a caller fills ring slots in place) --------------

    @property
    def transport_zero_copy(self) -> bool:
        """Whether callers may reserve request slots and submit by ref
        (the front door checks this before choosing its read path)."""
        return self._started and not self._dead

    def reserve_request_slot(self, nbytes: int) -> Tuple[int, memoryview]:
        """Claim one request-ring slot and hand back its writable view;
        the caller fills it (``recv_into``) and submits the ref with
        :meth:`submit_refs` — no intermediate bytes object ever exists.
        Sheds typed/retryable exactly like :meth:`ShmRing.put`."""
        if self._dead:
            raise EngineStopped(self._dead_reason)
        slot = self._req_ring.reserve(int(nbytes))
        return slot, self._req_ring.slot_view(slot, int(nbytes))

    def release_request_slot(self, slot: int) -> None:
        """Abandon a reserved slot (error paths only — a submitted ref
        is freed by the worker)."""
        if self._req_ring is not None:
            self._req_ring.free(int(slot))

    def submit_refs(
        self,
        ref1: Dict[str, Any],
        ref2: Dict[str, Any],
        *,
        deadline_ms: Optional[float] = None,
        num_flow_updates: Optional[int] = None,
        lease_flow: bool = False,
        trace_ctx: Optional[TraceContext] = None,
        priority: Optional[str] = None,
        tenant: Optional[str] = None,
    ):
        """Submit a pair whose tensors are ALREADY in the request ring
        (reserved + filled by the caller). With ``lease_flow`` the
        result's ``flow`` is a zero-copy view into the response ring and
        a ``release()`` callable is returned alongside — call it after
        the bytes leave (the front door writes the HTTP response from
        the ring view, then releases)."""
        if self._dead:
            raise EngineStopped(self._dead_reason)
        eff = self._effective_deadline(deadline_ms)
        t1 = time.monotonic()
        msg = {
            "im1": ref1,
            "im2": ref2,
            "deadline_ms": deadline_ms,
            "num_flow_updates": num_flow_updates,
        }
        self._wire_fields(msg, trace_ctx, priority, tenant)
        try:
            res = self._call(
                "submit", msg,
                timeout=eff / 1e3 + _RPC_GRACE_S,
                lease_flow=lease_flow,
            )
        except BaseException:
            self._record_spans(
                t1, t1, time.monotonic(), {}, kind="transport", ok=False,
                trace_ctx=trace_ctx,
            )
            raise
        self._record_spans(
            t1, t1, time.monotonic(), {}, kind="transport", ok=True,
            trace_ctx=trace_ctx,
        )
        self._absorb_worker_trace(res, trace_ctx)
        if not lease_flow:
            return _serve_result_from_wire(res, res.get("flow"))
        return self._leased_result(res)

    def _leased_result(self, res: Dict[str, Any]):
        """(result, release) for a lease_flow call: flow stays a view
        into the response ring until release() sends the slot home."""
        ref = res.get("flow")
        if not isinstance(ref, dict):
            return _serve_result_from_wire(res, None), (lambda: None)
        view = self._resp_ring.get(ref, copy=False)
        released = []

        def release():
            if not released:
                released.append(True)
                self._free_resp_slot(ref["slot"])

        return _serve_result_from_wire(res, view), release

    def open_stream(self):
        from raft_tpu_torch.serve.engine import StreamSession

        res = self._call("open_stream", timeout=10.0)
        return StreamSession(self, int(res["stream_id"]))

    def submit_frame(
        self,
        stream_id: int,
        frame,
        *,
        deadline_ms: Optional[float] = None,
        num_flow_updates: Optional[int] = None,
        trace_ctx: Optional[TraceContext] = None,
        priority: Optional[str] = None,
        tenant: Optional[str] = None,
    ):
        if self._dead:
            raise EngineStopped(self._dead_reason)
        eff = self._effective_deadline(deadline_ms)
        spans: Dict[str, float] = {}
        t0 = time.monotonic()
        ref = self._req_ring.put(np.asarray(frame), spans=spans)
        t1 = time.monotonic()
        msg = {
            "stream_id": int(stream_id),
            "frame": ref,
            "deadline_ms": deadline_ms,
            "num_flow_updates": num_flow_updates,
        }
        self._wire_fields(msg, trace_ctx, priority, tenant)
        try:
            res = self._call(
                "submit_frame", msg, timeout=eff / 1e3 + _RPC_GRACE_S,
            )
        except BaseException:
            self._record_spans(
                t0, t1, time.monotonic(), spans, kind="transport",
                ok=False, trace_ctx=trace_ctx,
            )
            raise
        self._record_spans(
            t0, t1, time.monotonic(), spans, kind="transport", ok=True,
            trace_ctx=trace_ctx,
        )
        self._absorb_worker_trace(res, trace_ctx)
        return _serve_result_from_wire(res, res.get("flow"))

    def close_stream(self, stream_id: int) -> None:
        self._call("close_stream", {"stream_id": int(stream_id)}, timeout=10.0)

    def health(self) -> dict:
        """The worker engine's own health dict, briefly cached
        (``_HEALTH_TTL_S``): the router's monitor
        maintains its score vector from this, and one RPC per probe
        would put the control channel on the hot path. Cache hits and
        misses are counted through the transport stats block."""
        now = time.monotonic()
        cached = self._health_cache
        if cached is not None and now - self._health_t < _HEALTH_TTL_S:
            self.health_cache_hits += 1
            return cached
        self.health_cache_misses += 1
        h = self._call("health", timeout=10.0)
        self._health_cache, self._health_t = h, time.monotonic()
        return h

    def transport_stats(self, *, include_worker: bool = False) -> dict:
        """The client-side transport ledger: the codec, coalescer
        write stats, receive counts, ring stats (copies, occupancy, hold
        EWMA), health-cache hits/misses, and pack/ring_wait/rpc/unpack
        span quantiles. ``include_worker`` additionally RPCs the worker
        for its own side (best-effort; ``None`` when it cannot answer).
        """
        def q(name):
            xs = list(self._span_ms[name])
            if not xs:
                return {"n": 0, "p50_ms": None, "p99_ms": None}
            return {
                "n": len(xs),
                "p50_ms": round(float(np.percentile(xs, 50)), 4),
                "p99_ms": round(float(np.percentile(xs, 99)), 4),
            }

        out: Dict[str, Any] = {
            # the wire every port worker speaks (the key set is the JAX
            # client's, whose wire is negotiated)
            "transport": "binary",
            "trace_propagation": True,
            "qos_propagation": True,
            # the handshake-estimated cross-process monotonic offset with
            # its rtt (the stitching error bound is rtt/2)
            "clock_offset_ms": self.clock_offset_s * 1e3,
            "clock_rtt_ms": (
                None if self.clock_rtt_s is None else self.clock_rtt_s * 1e3
            ),
            "health_ttl_s": _HEALTH_TTL_S,
            "health_cache_hits": self.health_cache_hits,
            "health_cache_misses": self.health_cache_misses,
            "sender": self._sender.stats() if self._sender else {},
            "msgs_received": self.msgs_received,
            "frames_received": self.frames_received,
            "bytes_received": self.bytes_received,
            "rings": {
                "req": self._req_ring.stats() if self._req_ring else {},
                "resp": self._resp_ring.stats() if self._resp_ring else {},
            },
            "spans": {n: q(n) for n in self._span_ms},
        }
        if include_worker:
            try:
                out["worker"] = self._call("transport", timeout=10.0)
            except Exception:
                out["worker"] = None
        return out

    def stats(self) -> dict:
        """The worker engine's stats tree — byte-identical key set to a
        thread engine's — plus one parent-side ``transport`` block (the
        transport ledger; tooling that wants the pure engine schema pops
        it, and the schema pins cover both)."""
        stats = self._call("stats", timeout=30.0)
        stats["transport"] = self.transport_stats()
        return stats

    def alerts(self) -> dict:
        return self._call("alerts", timeout=10.0)

    def prometheus(self) -> str:
        return self._call("prometheus", timeout=10.0)["text"]

    def dump_postmortem(self, reason: str) -> bool:
        """Ask the worker to dump its flight recorder through its sinks
        (with ``dump_dir`` set, that lands a bundle file in the parent's
        dump directory). Best-effort: False when the worker is gone."""
        try:
            self._call("dump", {"reason": reason}, timeout=5.0)
            return True
        except Exception:
            return False
