"""Cross-process serving transport: framing, shared-memory tensor rings,
and typed errors that survive the wire.

The process-per-replica fleet needs three things a thread
fleet gets for free, and this module is all three — stdlib only, no
msgpack, no grpc:

* **Control framing** — every message on the worker control socket (and
  every HTTP request/response body on the front door) is length-prefixed:
  a 4-byte big-endian length followed by a payload that is either UTF-8
  JSON or the compact struct-packed **binary codec**
  (:func:`encode_payload` / :func:`decode_payload`). The receiver
  auto-detects per frame (a binary payload opens with a magic byte no
  JSON document can start with), so JSON stays a live, negotiated
  fallback: an old peer that never learned the binary codec keeps
  working, frame for frame. Hot-path control messages (submit, result,
  slot frees) are dominated by interned keys and fixed-width ints under
  the binary codec instead of quoted, comma-joined text.
* **RPC coalescing** (:class:`FrameCoalescer`) — concurrent senders'
  messages are drained into ONE multi-message frame per socket write
  (``{"op": "batch", "msgs": [...]}``), mirroring the engine's own
  micro-batching at the transport layer: a burst of submits costs one
  syscall, and the worker acks a burst of completions in one batched
  wakeup frame.
* **Shared-memory tensor rings** (:class:`ShmRing`) — frame tensors move
  between parent and worker through ``multiprocessing.shared_memory``
  slot pools: the sender copies the array into a free fixed-size slot
  (or, zero-copy, ``recv_into``\\ s socket bytes straight into a
  :meth:`ShmRing.reserve`-d slot view) and ships a tiny ``{slot, shape,
  dtype}`` reference in the control message; the receiver maps the slot
  as a NumPy view (a copy by default, a borrowed view on the paths that
  can free deterministically). Slots are allocated by the ring's *owner*
  side only (a free list needs one authority); the reader returns slots
  with an explicit free message, so out-of-order completions (the normal
  case under load) never fragment anything. A full ring is **flow
  control**, not an error: ``put`` raises the typed, retryable
  :class:`~raft_tpu_torch.serve.Overloaded` carrying a ``retry_after_ms`` hint
  computed from live ring occupancy x the EWMA slot-hold time, and an
  array larger than a slot is refused with the terminal
  :class:`~raft_tpu_torch.serve.InvalidInput` (resubmitting it would fail the
  same way).
* **Typed errors on the wire** (:func:`encode_error` /
  :func:`decode_error`) — the serving contract's whole error vocabulary
  round-trips: a worker's ``Overloaded``/``Draining`` arrives in the
  parent as the same class carrying the same ``retry_after_ms``, so the
  router's shed/migrate/re-route classification works identically for
  thread and process replicas, and HTTP callers get the same taxonomy as
  JSON bodies.

Every buffer copy this module performs on the transport path is counted
(:data:`copy_counts`, per-ring ``copies_in``/``copies_out``), so
"zero-copy" is asserted by tests (copies/request), not claimed — the
:class:`~raft_tpu_torch.utils.tripwire.CopyTripwire` hooks these counters.
"""

from __future__ import annotations

import collections
import json
import numbers
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from raft_tpu_torch.serve import errors as _errors

__all__ = [
    "send_msg",
    "recv_msg",
    "recv_exact",
    "FrameReader",
    "encode_payload",
    "decode_payload",
    "iter_messages",
    "FrameCoalescer",
    "pack_frames",
    "unpack_frames",
    "frames_sections",
    "encode_error",
    "decode_error",
    "ShmRing",
    "ConnectionClosed",
    "parse_endpoint",
    "listen_tcp",
    "dial_tcp",
    "add_copy_listener",
    "remove_copy_listener",
    "copies_snapshot",
]

# Control messages are small (tensor payloads go through shm); a frame
# this large is a protocol bug, not a big request.
MAX_MSG_BYTES = 64 * 1024 * 1024
_LEN = struct.Struct(">I")
_TLEN = struct.Struct(">Q")


# -- transport-copy accounting ----------------------------------------------

# Process-global counters of every buffer copy the transport performs,
# by site. A benchmark diffs these around a run (copies/request); the
# CopyTripwire registers a listener to scope assertions to a region.
copy_counts: collections.Counter = collections.Counter()
_copy_listeners: List[Callable[[str, int], None]] = []


def _note_copy(site: str, nbytes: int = 0) -> None:
    copy_counts[site] += 1
    for fn in list(_copy_listeners):
        try:
            fn(site, nbytes)
        except Exception:
            pass


def add_copy_listener(fn: Callable[[str, int], None]) -> None:
    _copy_listeners.append(fn)


def remove_copy_listener(fn: Callable[[str, int], None]) -> None:
    try:
        _copy_listeners.remove(fn)
    except ValueError:
        pass


def copies_snapshot() -> Dict[str, int]:
    return {k: int(v) for k, v in copy_counts.items()}


class ConnectionClosed(ConnectionError):
    """The peer closed the control channel (worker death, parent exit)."""


# -- TCP endpoints ---------------------------------------------------------

# The framing layer above is socket-agnostic; these three helpers are the
# entire TCP-specific surface. Endpoints are "host:port" strings so they
# survive JSON config, CLI flags, and postmortem bundles unchanged.


def parse_endpoint(endpoint: str) -> Tuple[str, int]:
    """Split a ``host:port`` endpoint string; raises ValueError if malformed."""
    host, sep, port = endpoint.rpartition(":")
    if not sep or not host:
        raise ValueError(f"endpoint must be 'host:port', got {endpoint!r}")
    return host, int(port)


def listen_tcp(host: str = "127.0.0.1", port: int = 0) -> Tuple[socket.socket, str]:
    """Bind a TCP listener; returns (listener, "host:port" with the real port).

    port=0 asks the kernel for an ephemeral port — the returned endpoint is
    what a remote worker reports back to its launcher.
    """
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen(8)
    bound_host, bound_port = listener.getsockname()[:2]
    return listener, f"{bound_host}:{bound_port}"


def dial_tcp(endpoint: str, timeout: float = 5.0) -> socket.socket:
    """Connect to a ``host:port`` endpoint; TCP_NODELAY set (control frames
    are small and latency-sensitive). The returned socket is blocking with
    no timeout — per-RPC deadlines live above the framing layer."""
    host, port = parse_endpoint(endpoint)
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)
    return sock


# -- binary control codec --------------------------------------------------

# Payloads opening with this byte are binary; JSON documents start with
# '{' (0x7B) or whitespace, never 0xB1, so the receiver distinguishes the
# two codecs per frame — the negotiation-free half of the JSON fallback.
_BIN_MAGIC = 0xB1
_BIN_VERSION = 1

# Interned control-plane strings: the keys and op names the hot path
# repeats on every message. One byte on the wire instead of a quoted
# string. APPEND-ONLY — codes are wire format; reordering is a protocol
# break the version byte exists to catch.
_INTERN: Tuple[str, ...] = (
    "op", "id", "ok", "result", "error", "msgs", "batch",
    "submit", "submit_frame", "free_req", "free_resp", "slot", "slots",
    "shape", "dtype", "im1", "im2", "frame", "stream_id", "deadline_ms",
    "num_flow_updates", "rid", "bucket", "level", "degraded",
    "latency_ms", "slow_path", "retried_single", "primed", "exit_reason",
    "trace_id", "residuals", "warm_started", "flow", "type", "msg",
    "retry_after_ms", "field", "target", "deadline", "converged",
    # trace propagation (appended: codes are wire format):
    # the piggybacked worker trace record and its span keys
    "trace", "spans", "name", "t0_ms", "dur_ms", "kind", "t_start",
    "wall_start", "proc",
)
_INTERN_CODE: Dict[str, int] = {s: i for i, s in enumerate(_INTERN)}

_B_U8 = struct.Struct(">B")
_B_I64 = struct.Struct(">q")
_B_F64 = struct.Struct(">d")


def _pack_value(parts: List[bytes], obj: Any) -> None:
    # bool before Integral: True is an int
    if obj is None:
        parts.append(b"N")
    elif obj is True:
        parts.append(b"T")
    elif obj is False:
        parts.append(b"F")
    elif isinstance(obj, str):
        code = _INTERN_CODE.get(obj)
        if code is not None:
            parts.append(b"k" + _B_U8.pack(code))
        else:
            b = obj.encode()
            parts.append(b"s" + _LEN.pack(len(b)) + b)
    elif isinstance(obj, bool):  # numpy bool_
        parts.append(b"T" if obj else b"F")
    elif isinstance(obj, numbers.Integral):
        v = int(obj)
        if 0 <= v <= 255:
            parts.append(b"u" + _B_U8.pack(v))
        else:
            parts.append(b"i" + _B_I64.pack(v))
    elif isinstance(obj, numbers.Real):
        parts.append(b"d" + _B_F64.pack(float(obj)))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        parts.append(b"b" + _LEN.pack(len(b)) + b)
    elif isinstance(obj, (list, tuple)):
        parts.append(b"l" + _LEN.pack(len(obj)))
        for item in obj:
            _pack_value(parts, item)
    elif isinstance(obj, dict):
        parts.append(b"m" + _LEN.pack(len(obj)))
        for k, v in obj.items():
            _pack_value(parts, k if isinstance(k, str) else str(k))
            _pack_value(parts, v)
    else:
        # mirror the JSON path's default=repr: never refuse to encode
        _pack_value(parts, repr(obj))


def _unpack_value(buf: memoryview, off: int) -> Tuple[Any, int]:
    tag = buf[off:off + 1].tobytes()
    off += 1
    if tag == b"N":
        return None, off
    if tag == b"T":
        return True, off
    if tag == b"F":
        return False, off
    if tag == b"u":
        return buf[off], off + 1
    if tag == b"i":
        return _B_I64.unpack_from(buf, off)[0], off + 8
    if tag == b"d":
        return _B_F64.unpack_from(buf, off)[0], off + 8
    if tag == b"k":
        code = buf[off]
        if code >= len(_INTERN):
            raise ValueError(f"unknown interned string code {code}")
        return _INTERN[code], off + 1
    if tag == b"s":
        (n,) = _LEN.unpack_from(buf, off)
        off += 4
        return bytes(buf[off:off + n]).decode(), off + n
    if tag == b"b":
        (n,) = _LEN.unpack_from(buf, off)
        off += 4
        return bytes(buf[off:off + n]), off + n
    if tag == b"l":
        (n,) = _LEN.unpack_from(buf, off)
        off += 4
        out: List[Any] = []
        for _ in range(n):
            v, off = _unpack_value(buf, off)
            out.append(v)
        return out, off
    if tag == b"m":
        (n,) = _LEN.unpack_from(buf, off)
        off += 4
        d: Dict[str, Any] = {}
        for _ in range(n):
            k, off = _unpack_value(buf, off)
            v, off = _unpack_value(buf, off)
            d[k] = v
        return d, off
    raise ValueError(f"bad binary control tag {tag!r} at offset {off - 1}")


# -- struct-packed fast paths for the hot records ---------------------------
#
# The generic tagged packer above is schema-free but pays a Python-level
# call per value — slower than C json on a result dict. The messages the
# hot path actually repeats (submit, result, error reply, slot frees,
# and the batch container) have FIXED shapes, so they get dedicated
# fixed-layout struct records: one struct.pack per message instead of
# one Python call per field. Record tags live above 0x80 (the generic
# tags are ASCII), and anything that doesn't match a record's exact
# shape silently falls back to the generic packer — correctness never
# depends on the fast path.

_R_SUBMIT = 0x81
# submit carrying a propagated trace_id: the fixed submit layout plus
# one length-prefixed string. Only ever sent to a peer that echoed
# trace_propagation in the ready handshake — a peer without trace
# propagation never sees the tag, exactly like the binary-codec
# negotiation.
_R_SUBMIT_T = 0x82
_R_RESULT = 0x83
_R_ERROR = 0x84
_R_FREE_REQ = 0x85
_R_FREE_RESP = 0x86
# submit carrying QoS identity: the fixed submit layout plus
# two length-prefixed strings (priority, tenant) — after the trace
# string on the _TQ variant. Negotiated exactly like trace_propagation:
# only sent to a peer that echoed qos_propagation in the ready
# handshake, so a peer without QoS propagation never sees these tags.
_R_SUBMIT_Q = 0x87
_R_SUBMIT_TQ = 0x88
_R_BATCH = 0x8F

# dtypes a tensor ref realistically carries; 0xFF = inline string escape
_DTYPES = ("|u1", "<f4", "<f2", "<f8", "<i4", "<i8", "|b1", "<u2", "<i2")
_DTYPE_CODE = {s: i for i, s in enumerate(_DTYPES)}

# submit fixed part: id q, deadline d (nan=None), iters h (-1=None),
# kind B (0=pair, 1=stream), stream id q (-1 when pair)
_S_SUBMIT = struct.Struct(">BqdhBq")
# result fixed part: id q, rid q, bucket HH, iters h, level h, flags B,
# latency d, exit reason B
_S_RESULT = struct.Struct(">BqqHHhhBdB")
_EXIT_REASONS = ("target", "deadline", "converged")
_EXIT_CODE = {s: i for i, s in enumerate(_EXIT_REASONS)}

_SUBMIT_PAIR_KEYS = frozenset(
    ("op", "id", "im1", "im2", "deadline_ms", "num_flow_updates",
     "trace_id", "priority", "tenant")
)
_SUBMIT_FRAME_KEYS = frozenset(
    ("op", "id", "frame", "stream_id", "deadline_ms", "num_flow_updates",
     "trace_id", "priority", "tenant")
)
_RESULT_KEYS = frozenset((
    "rid", "bucket", "num_flow_updates", "level", "degraded",
    "latency_ms", "slow_path", "retried_single", "primed", "exit_reason",
    "trace_id", "residuals", "warm_started", "flow",
))
_ERROR_KEYS = frozenset(("type", "msg", "retry_after_ms", "field"))

_NAN = float("nan")


def _pack_str(parts: List[bytes], s: str) -> None:
    b = s.encode()
    parts.append(_LEN.pack(len(b)))
    parts.append(b)


def _unpack_str(buf: memoryview, off: int) -> Tuple[str, int]:
    (n,) = _LEN.unpack_from(buf, off)
    off += 4
    return bytes(buf[off:off + n]).decode(), off + n


def _pack_ref(parts: List[bytes], ref: Dict[str, Any]) -> bool:
    shape = ref["shape"]
    dt = _DTYPE_CODE.get(ref["dtype"], 0xFF)
    parts.append(struct.pack(
        ">IBB", ref["slot"], dt, len(shape),
    ))
    if dt == 0xFF:
        _pack_str(parts, ref["dtype"])
    parts.append(struct.pack(f">{len(shape)}I", *shape))
    return True


def _unpack_ref(buf: memoryview, off: int) -> Tuple[Dict[str, Any], int]:
    slot, dt, nd = struct.unpack_from(">IBB", buf, off)
    off += 6
    if dt == 0xFF:
        dtype, off = _unpack_str(buf, off)
    else:
        dtype = _DTYPES[dt]
    shape = list(struct.unpack_from(f">{nd}I", buf, off))
    off += 4 * nd
    return {"slot": slot, "shape": shape, "dtype": dtype}, off


def _submit_tag(tid: Optional[str], qos: bool) -> int:
    """The submit record tag for a (trace?, qos?) combination."""
    if tid is None:
        return _R_SUBMIT_Q if qos else _R_SUBMIT
    return _R_SUBMIT_TQ if qos else _R_SUBMIT_T


def _try_pack_record(parts: List[bytes], msg: Dict[str, Any]) -> bool:
    """Append ``msg`` as a fixed-layout record; False = not a hot shape
    (the caller falls back to the generic packer). Builds into a local
    list so a mid-record failure never pollutes the output."""
    rp: List[bytes] = []
    try:
        op = msg.get("op")
        if op == "submit" and frozenset(msg) <= _SUBMIT_PAIR_KEYS:
            dl = msg.get("deadline_ms")
            it = msg.get("num_flow_updates")
            tid = msg.get("trace_id")
            qos = "priority" in msg or "tenant" in msg
            rp.append(_S_SUBMIT.pack(
                _submit_tag(tid, qos),
                msg.get("id", -1),
                _NAN if dl is None else float(dl),
                -1 if it is None else int(it), 0, -1,
            ))
            if tid is not None:
                _pack_str(rp, tid)
            if qos:
                _pack_str(rp, msg.get("priority") or "")
                _pack_str(rp, msg.get("tenant") or "")
            _pack_ref(rp, msg["im1"])
            _pack_ref(rp, msg["im2"])
        elif op == "submit_frame" and frozenset(msg) <= _SUBMIT_FRAME_KEYS:
            dl = msg.get("deadline_ms")
            it = msg.get("num_flow_updates")
            tid = msg.get("trace_id")
            qos = "priority" in msg or "tenant" in msg
            rp.append(_S_SUBMIT.pack(
                _submit_tag(tid, qos),
                msg.get("id", -1),
                _NAN if dl is None else float(dl),
                -1 if it is None else int(it), 1, int(msg["stream_id"]),
            ))
            if tid is not None:
                _pack_str(rp, tid)
            if qos:
                _pack_str(rp, msg.get("priority") or "")
                _pack_str(rp, msg.get("tenant") or "")
            _pack_ref(rp, msg["frame"])
        elif (
            op is None and msg.get("ok") is True
            and "result" in msg and len(msg) == 3
        ):
            res = msg["result"]
            if (
                not isinstance(res, dict)
                or frozenset(res) != _RESULT_KEYS
            ):
                return False
            reason = _EXIT_CODE.get(res["exit_reason"])
            if reason is None:
                return False
            flow, trace, resid = (
                res["flow"], res["trace_id"], res["residuals"],
            )
            if flow is not None and not isinstance(flow, dict):
                return False
            flags = (
                (1 if res["degraded"] else 0)
                | (2 if res["slow_path"] else 0)
                | (4 if res["retried_single"] else 0)
                | (8 if res["primed"] else 0)
                | (16 if res["warm_started"] else 0)
                | (32 if flow is not None else 0)
                | (64 if trace is not None else 0)
                | (128 if resid is not None else 0)
            )
            rp.append(_S_RESULT.pack(
                _R_RESULT, msg.get("id", -1), res["rid"],
                res["bucket"][0], res["bucket"][1],
                res["num_flow_updates"], res["level"], flags,
                res["latency_ms"], reason,
            ))
            if trace is not None:
                _pack_str(rp, trace)
            if resid is not None:
                rp.append(struct.pack(
                    f">H{len(resid)}d", len(resid), *resid
                ))
            if flow is not None:
                _pack_ref(rp, flow)
        elif op is None and "error" in msg and len(msg) == 2:
            err = msg["error"]
            if (
                not isinstance(err, dict)
                or not frozenset(err) <= _ERROR_KEYS
            ):
                return False
            retry = err.get("retry_after_ms")
            rp.append(struct.pack(
                ">Bqd", _R_ERROR, msg.get("id", -1),
                _NAN if retry is None else float(retry),
            ))
            _pack_str(rp, err.get("type", "ServeError"))
            _pack_str(rp, err.get("msg", ""))
            _pack_str(rp, err.get("field", ""))
        elif (
            op in ("free_req", "free_resp")
            and "slots" in msg and len(msg) == 2
        ):
            slots = msg["slots"]
            rp.append(struct.pack(
                f">BH{len(slots)}I",
                _R_FREE_REQ if op == "free_req" else _R_FREE_RESP,
                len(slots), *slots,
            ))
        else:
            return False
    except (KeyError, TypeError, ValueError, struct.error):
        return False
    parts.extend(rp)
    return True


def _unpack_record(buf: memoryview, off: int) -> Tuple[Dict[str, Any], int]:
    tag = buf[off]
    if tag in (_R_SUBMIT, _R_SUBMIT_T, _R_SUBMIT_Q, _R_SUBMIT_TQ):
        _, mid, dl, it, kind, sid = _S_SUBMIT.unpack_from(buf, off)
        off += _S_SUBMIT.size
        msg: Dict[str, Any] = {
            "id": mid,
            "deadline_ms": None if dl != dl else dl,
            "num_flow_updates": None if it < 0 else it,
        }
        if tag in (_R_SUBMIT_T, _R_SUBMIT_TQ):
            msg["trace_id"], off = _unpack_str(buf, off)
        if tag in (_R_SUBMIT_Q, _R_SUBMIT_TQ):
            pr, off = _unpack_str(buf, off)
            ten, off = _unpack_str(buf, off)
            if pr:
                msg["priority"] = pr
            if ten:
                msg["tenant"] = ten
        if kind == 0:
            msg["op"] = "submit"
            msg["im1"], off = _unpack_ref(buf, off)
            msg["im2"], off = _unpack_ref(buf, off)
        else:
            msg["op"] = "submit_frame"
            msg["stream_id"] = sid
            msg["frame"], off = _unpack_ref(buf, off)
        return msg, off
    if tag == _R_RESULT:
        (_, mid, rid, b0, b1, iters, level, flags, latency,
         reason) = _S_RESULT.unpack_from(buf, off)
        off += _S_RESULT.size
        res: Dict[str, Any] = {
            "rid": rid, "bucket": [b0, b1], "num_flow_updates": iters,
            "level": level, "degraded": bool(flags & 1),
            "latency_ms": latency, "slow_path": bool(flags & 2),
            "retried_single": bool(flags & 4), "primed": bool(flags & 8),
            "warm_started": bool(flags & 16),
            "exit_reason": _EXIT_REASONS[reason],
            "trace_id": None, "residuals": None, "flow": None,
        }
        if flags & 64:
            res["trace_id"], off = _unpack_str(buf, off)
        if flags & 128:
            (n,) = struct.unpack_from(">H", buf, off)
            off += 2
            res["residuals"] = list(
                struct.unpack_from(f">{n}d", buf, off)
            )
            off += 8 * n
        if flags & 32:
            res["flow"], off = _unpack_ref(buf, off)
        return {"id": mid, "ok": True, "result": res}, off
    if tag == _R_ERROR:
        _, mid, retry = struct.unpack_from(">Bqd", buf, off)
        off += 17
        etype, off = _unpack_str(buf, off)
        emsg, off = _unpack_str(buf, off)
        field, off = _unpack_str(buf, off)
        err: Dict[str, Any] = {"type": etype, "msg": emsg}
        if retry == retry:
            err["retry_after_ms"] = retry
        if field:
            err["field"] = field
        return {"id": mid, "error": err}, off
    if tag in (_R_FREE_REQ, _R_FREE_RESP):
        (n,) = struct.unpack_from(">H", buf, off + 1)
        slots = list(struct.unpack_from(f">{n}I", buf, off + 3))
        return {
            "op": "free_req" if tag == _R_FREE_REQ else "free_resp",
            "slots": slots,
        }, off + 3 + 4 * n
    if tag == _R_BATCH:
        (n,) = struct.unpack_from(">H", buf, off + 1)
        off += 3
        msgs = []
        for _ in range(n):
            m, off = _unpack_payload_value(buf, off)
            msgs.append(m)
        return {"op": "batch", "msgs": msgs}, off
    raise ValueError(f"bad binary record tag 0x{tag:02x}")


def _pack_payload_value(parts: List[bytes], msg: Any) -> None:
    """One control message: record fast path, generic tags otherwise."""
    if isinstance(msg, dict):
        if msg.get("op") == "batch" and len(msg) == 2:
            msgs = msg.get("msgs") or []
            try:
                parts.append(struct.pack(">BH", _R_BATCH, len(msgs)))
            except struct.error:
                _pack_value(parts, msg)
                return
            for m in msgs:
                _pack_payload_value(parts, m)
            return
        if _try_pack_record(parts, msg):
            return
    _pack_value(parts, msg)


def _unpack_payload_value(buf: memoryview, off: int) -> Tuple[Any, int]:
    if buf[off] >= 0x80:
        return _unpack_record(buf, off)
    return _unpack_value(buf, off)


def encode_payload(obj: Dict[str, Any], *, binary: bool = False) -> bytes:
    """One control message as frame payload bytes (header included for
    the binary codec; bare UTF-8 JSON otherwise)."""
    if not binary:
        return json.dumps(obj, separators=(",", ":"), default=repr).encode()
    parts: List[bytes] = [bytes((_BIN_MAGIC, _BIN_VERSION))]
    _pack_payload_value(parts, obj)
    return b"".join(parts)


def decode_payload(data) -> Dict[str, Any]:
    """Inverse of :func:`encode_payload`; auto-detects the codec per
    payload, which is what makes JSON a zero-negotiation fallback."""
    if len(data) >= 2 and data[0] == _BIN_MAGIC:
        if data[1] != _BIN_VERSION:
            raise ValueError(
                f"binary control payload version {data[1]} "
                f"(this side speaks {_BIN_VERSION})"
            )
        obj, _ = _unpack_payload_value(memoryview(data), 2)
        return obj
    return json.loads(bytes(data).decode())


def iter_messages(frame: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Flatten a received frame into its control messages: a ``batch``
    frame carries many (recursively — coalescers may nest one level),
    anything else is itself."""
    if frame.get("op") != "batch":
        return [frame]
    out: List[Dict[str, Any]] = []
    for m in frame.get("msgs") or ():
        if isinstance(m, dict) and m.get("op") == "batch":
            out.extend(iter_messages(m))
        else:
            out.append(m)
    return out


# -- length-prefixed framing ------------------------------------------------


def send_msg(
    sock: socket.socket, obj: Dict[str, Any], *, binary: bool = False
) -> None:
    """One framed control message: 4-byte BE length + payload (JSON by
    default, the binary codec with ``binary=True``).

    The caller serializes concurrent senders (one write lock per
    connection — or a :class:`FrameCoalescer`); ``sendall`` keeps the
    frame atomic on the stream.
    """
    data = encode_payload(obj, binary=binary)
    if len(data) > MAX_MSG_BYTES:
        raise ValueError(f"message of {len(data)} bytes exceeds frame limit")
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise :class:`ConnectionClosed`."""
    chunks = []
    while n > 0:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionClosed("peer closed the control channel")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket) -> Dict[str, Any]:
    """Receive one framed control message, either codec (blocking)."""
    (n,) = _LEN.unpack(recv_exact(sock, _LEN.size))
    if n > MAX_MSG_BYTES:
        raise ConnectionClosed(f"oversized frame announced ({n} bytes)")
    return decode_payload(recv_exact(sock, n))


class FrameReader:
    """Buffered steady-state frame reader: one kernel ``recv`` refills a
    user-space buffer that typically yields several frames (the
    coalesced wire arrives in bursts), instead of the two syscalls per
    frame :func:`recv_msg` pays (length, then payload). Use only on a
    blocking socket with no timeout — a mid-frame timeout would lose the
    partial read (handshakes keep :func:`recv_msg`)."""

    def __init__(self, sock: socket.socket):
        self._f = sock.makefile("rb", buffering=1 << 16)
        self.frames = 0
        self.bytes = 0

    def read_msg(self) -> Dict[str, Any]:
        head = self._f.read(_LEN.size)
        if len(head) < _LEN.size:
            raise ConnectionClosed("peer closed the control channel")
        (n,) = _LEN.unpack(head)
        if n > MAX_MSG_BYTES:
            raise ConnectionClosed(f"oversized frame announced ({n} bytes)")
        data = self._f.read(n)
        if len(data) < n:
            raise ConnectionClosed("peer closed the control channel")
        self.frames += 1
        self.bytes += _LEN.size + n
        return decode_payload(data)

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass


class FrameCoalescer:
    """Batches concurrent control messages into one frame per write.

    Senders append to a pending list; whichever sender wins the write
    lock becomes the *leader* and drains **everything** pending into one
    ``batch`` frame per socket write, so a burst of concurrent submits
    (or a worker's burst of completions via :meth:`send_many`) costs one
    syscall instead of one each. Followers return immediately — their
    message is on the leader's frame. The post-release re-check closes
    the classic combining-lock window (a message appended after the
    leader's last drain but before its release is never stranded).

    ``batch=False`` degrades to one locked write per message — the
    legacy one-JSON-frame-per-message wire behavior, kept for
    ``transport='legacy'`` and old peers.

    A failed write poisons the coalescer: the leader that hit it raises,
    every later send raises ``ConnectionClosed``, and messages a failed
    leader frame may have eaten surface through the reader's EOF path
    (the channel is dead anyway — that is the existing death contract).
    """

    def __init__(
        self, sock: socket.socket, *, binary: bool = False, batch: bool = True
    ):
        self._sock = sock
        self.binary = bool(binary)
        self.batch = bool(batch)
        self._pending: List[Dict[str, Any]] = []
        self._plock = threading.Lock()
        self._wlock = threading.Lock()
        self._broken: Optional[BaseException] = None
        self.msgs_sent = 0
        self.frames_sent = 0
        self.bytes_sent = 0
        self.max_batch = 0

    def send(self, msg: Dict[str, Any]) -> None:
        self.send_many((msg,))

    def send_many(self, msgs) -> None:
        """Enqueue ``msgs`` (they ride one frame together when possible)
        and drain as leader unless another sender already is."""
        msgs = list(msgs)
        if not msgs:
            return
        if not self.batch:
            with self._wlock:
                for m in msgs:
                    self._write([m])
            return
        with self._plock:
            self._pending.extend(msgs)
        while True:
            if not self._wlock.acquire(blocking=False):
                return  # the current leader's drain loop picks them up
            try:
                while True:
                    with self._plock:
                        batch, self._pending = self._pending, []
                    if not batch:
                        break
                    self._write(batch)
            finally:
                self._wlock.release()
            with self._plock:
                if not self._pending:
                    return

    def _write(self, batch: List[Dict[str, Any]]) -> None:
        # only ever called under _wlock, so the stats are consistent
        if self._broken is not None:
            raise ConnectionClosed(
                f"control channel poisoned by earlier write failure: "
                f"{self._broken!r}"
            )
        frame = (
            batch[0] if len(batch) == 1
            else {"op": "batch", "msgs": batch}
        )
        data = encode_payload(frame, binary=self.binary)
        if len(data) > MAX_MSG_BYTES:
            raise ValueError(
                f"frame of {len(data)} bytes exceeds the frame limit"
            )
        try:
            self._sock.sendall(_LEN.pack(len(data)) + data)
        except BaseException as e:
            self._broken = e
            raise
        self.msgs_sent += len(batch)
        self.frames_sent += 1
        self.bytes_sent += _LEN.size + len(data)
        self.max_batch = max(self.max_batch, len(batch))

    @property
    def batched_msgs(self) -> int:
        """Messages that rode a shared frame (syscalls saved)."""
        return self.msgs_sent - self.frames_sent

    def stats(self) -> Dict[str, Any]:
        return {
            "binary": self.binary,
            "batch": self.batch,
            "msgs_sent": self.msgs_sent,
            "frames_sent": self.frames_sent,
            "bytes_sent": self.bytes_sent,
            "batched_msgs": self.batched_msgs,
            "max_batch": self.max_batch,
        }


# -- tensor-carrying bodies (the HTTP front door's request/response form) ---


def frames_sections(meta: Dict[str, Any], arrays: List[np.ndarray]) -> list:
    """A tensor body as a list of ``write()``-able sections — the raw
    tensor views are handed out as memoryviews, NOT joined into one
    bytes object, so a streaming writer (the HTTP front door's response
    path) moves them straight from their backing buffer (a shm-ring
    slot, say) to the socket with zero intermediate copies.
    """
    views: List[np.ndarray] = []
    for a in arrays:
        a = np.asarray(a)
        if not a.flags["C_CONTIGUOUS"]:
            a = np.ascontiguousarray(a)
            _note_copy("pack_contig", a.nbytes)
        views.append(a)
    meta = dict(
        meta,
        tensors=[
            {"shape": list(a.shape), "dtype": a.dtype.str} for a in views
        ],
    )
    mb = json.dumps(meta, separators=(",", ":"), default=repr).encode()
    sections: list = [_LEN.pack(len(mb)) + mb]
    for a in views:
        sections.append(_TLEN.pack(a.nbytes))
        if a.nbytes:
            sections.append(a.reshape(-1).view(np.uint8).data)
    return sections


def sections_length(sections: list) -> int:
    """Total byte length of a :func:`frames_sections` body (the HTTP
    ``Content-Length``)."""
    return sum(
        s.nbytes if isinstance(s, memoryview) else len(s) for s in sections
    )


def pack_frames(meta: Dict[str, Any], arrays: List[np.ndarray]) -> bytes:
    """Meta JSON + raw tensor sections, each length-prefixed.

    Layout: ``[4B meta len][meta json][8B nbytes][tensor bytes]...`` with
    the tensors' shapes/dtypes described in ``meta["tensors"]`` — the
    same no-serializer discipline as the shm rings, for the one boundary
    (HTTP) where bytes must actually cross a stream. Materializes one
    contiguous body (a counted copy per tensor); streaming writers use
    :func:`frames_sections` instead and pay none.
    """
    sections = frames_sections(meta, arrays)
    for a in arrays:
        _note_copy("pack_copy", np.asarray(a).nbytes)
    return b"".join(bytes(s) if isinstance(s, memoryview) else s
                    for s in sections)


def unpack_frames(
    data, *, copy: bool = True
) -> Tuple[Dict[str, Any], List[np.ndarray]]:
    """Inverse of :func:`pack_frames` (validates section lengths).

    ``copy=False`` returns the tensors as zero-copy views into ``data``
    (which must then outlive them — the front door keeps the request
    buffer alive for exactly the handler's scope).
    """
    data = memoryview(data) if not isinstance(data, memoryview) else data
    if len(data) < _LEN.size:
        raise ValueError("truncated tensor body (no meta length)")
    (mn,) = _LEN.unpack(data[: _LEN.size])
    off = _LEN.size
    if off + mn > len(data):
        raise ValueError("truncated tensor body (meta section)")
    meta = json.loads(bytes(data[off:off + mn]).decode())
    off += mn
    arrays: List[np.ndarray] = []
    for spec in meta.get("tensors", []):
        if off + _TLEN.size > len(data):
            raise ValueError("truncated tensor body (tensor length)")
        (tn,) = _TLEN.unpack(data[off:off + _TLEN.size])
        off += _TLEN.size
        if off + tn > len(data):
            raise ValueError("truncated tensor body (tensor bytes)")
        arr = np.frombuffer(
            data, dtype=np.dtype(spec["dtype"]), count=tn
            // np.dtype(spec["dtype"]).itemsize, offset=off,
        ).reshape(spec["shape"])
        if copy:
            arr = arr.copy()
            _note_copy("unpack_copy", arr.nbytes)
        arrays.append(arr)
        off += tn
    return meta, arrays


# -- typed errors over the wire ---------------------------------------------

# The classes a worker (or the HTTP front door) may hand back by name.
# Everything the serving API documents — and nothing else: an unknown
# type decodes as the base ServeError rather than eval'ing anything.
_ERROR_TYPES = {
    cls.__name__: cls
    for cls in (
        _errors.ServeError,
        _errors.Overloaded,
        _errors.Draining,
        _errors.QuotaExceeded,
        _errors.DeadlineExceeded,
        _errors.InvalidInput,
        _errors.ShapeRejected,
        _errors.PoisonedInput,
        _errors.EngineStopped,
    )
}


def encode_error(exc: BaseException) -> Dict[str, Any]:
    """A typed serving error as a wire dict (class name + payload)."""
    d: Dict[str, Any] = {
        "type": type(exc).__name__
        if type(exc).__name__ in _ERROR_TYPES
        else "ServeError",
        "msg": str(exc),
    }
    retry = getattr(exc, "retry_after_ms", None)
    if retry is not None:
        d["retry_after_ms"] = float(retry)
    field = getattr(exc, "field", None)
    if field:
        d["field"] = str(field)
    # ShapeRejected serviceability hints: the bucket set and
    # nearest-bucket resize hint ride the wire so clients can act
    buckets = getattr(exc, "supported_buckets", None)
    if buckets:
        d["supported_buckets"] = [list(b) for b in buckets]
    nearest = getattr(exc, "nearest", None)
    if nearest is not None:
        d["nearest"] = list(nearest)
    return d


def decode_error(d: Dict[str, Any]) -> _errors.ServeError:
    """Reconstruct the typed error on the receiving side.

    ``Overloaded``/``Draining`` keep their ``retry_after_ms`` hint and
    ``ShapeRejected`` its bucket hints — the attributes the router's
    classification and the operator tooling actually read. The port has
    no warmup-artifact error: a peer's ``ArtifactMismatch`` decodes as
    the base ``ServeError``.
    """
    cls = _ERROR_TYPES.get(d.get("type", ""), _errors.ServeError)
    msg = str(d.get("msg", "remote serving error"))
    if issubclass(cls, _errors.Overloaded):
        return cls(msg, retry_after_ms=float(d.get("retry_after_ms", 50.0)))
    if cls is _errors.ShapeRejected:
        nearest = d.get("nearest")
        return cls(
            msg,
            supported_buckets=tuple(
                tuple(b) for b in d.get("supported_buckets", ())
            ),
            nearest=None if nearest is None else tuple(nearest),
        )
    return cls(msg)


# -- shared-memory tensor ring ----------------------------------------------


class ShmRing:
    """A fixed-slot tensor pool in one ``SharedMemory`` segment.

    ``slots`` slots of ``slot_bytes`` each. The **owner** side (the one
    that constructed with ``create=True``) holds the free list and is the
    only side that calls :meth:`put` / :meth:`free`; the attached side
    only maps slots (:meth:`get`) and tells the owner when it is done
    (a ``free`` control message the owner turns into :meth:`free`).
    Slot sizing is capacity planning, not correctness: a full ring sheds
    with the retryable ``Overloaded`` and the segment is only *touched*
    where tensors are actually written (tmpfs pages lazily), so generous
    slots cost address space, not RAM.
    """

    def __init__(
        self,
        slot_bytes: int,
        slots: int,
        *,
        name: Optional[str] = None,
        create: bool = True,
    ):
        from multiprocessing import shared_memory

        if slot_bytes < 1 or slots < 1:
            raise ValueError(
                f"slot_bytes and slots must be >= 1, got "
                f"{slot_bytes} / {slots}"
            )
        self.slot_bytes = int(slot_bytes)
        self.slots = int(slots)
        self._owner = bool(create)
        if create:
            self._shm = shared_memory.SharedMemory(
                create=True, size=self.slot_bytes * self.slots
            )
        else:
            # The attach side must NOT let the resource tracker claim the
            # segment: on 3.10 an attached SharedMemory registers as if
            # owned, and since the tracker's cache is a set, the double
            # registration (creator + attacher) makes teardown unbalanced
            # — the second unregister raises in the tracker. Ownership
            # (registration and unlink) stays with the creating side.
            from multiprocessing import resource_tracker

            orig_register = resource_tracker.register
            resource_tracker.register = lambda *a, **k: None
            try:
                self._shm = shared_memory.SharedMemory(name=name)
            finally:
                resource_tracker.register = orig_register
        self.name = self._shm.name
        self._free: List[int] = list(range(self.slots))
        self._cond = threading.Condition()
        self._closed = False
        # reuse accounting: `puts - high_water` slots were recycled — the
        # ring-reuse pin the ipc tests assert on
        self.puts = 0
        self.high_water = 0
        # flow-control telemetry: per-slot hold times feed an
        # EWMA so a full ring's Overloaded carries a retry_after_ms hint
        # computed from live occupancy x how long slots actually live,
        # instead of a hardcoded constant
        self._put_t: Dict[int, float] = {}
        self._hold_ewma_s = 0.0
        self._hold_samples = 0
        self.waits = 0            # puts that had to wait for a free slot
        self.wait_s_total = 0.0
        # transport-copy accounting: the bench's copies/request numerator
        self.copies_in = 0
        self.copies_out = 0

    @classmethod
    def attach(cls, name: str, slot_bytes: int, slots: int) -> "ShmRing":
        return cls(slot_bytes, slots, name=name, create=False)

    def geometry(self) -> Dict[str, Any]:
        """What the peer needs to attach (rides the worker spec)."""
        return {
            "name": self.name,
            "slot_bytes": self.slot_bytes,
            "slots": self.slots,
        }

    def free_count(self) -> int:
        with self._cond:
            return len(self._free)

    def occupancy(self) -> float:
        """Fraction of slots currently in flight."""
        with self._cond:
            return (self.slots - len(self._free)) / self.slots

    def retry_after_ms(self) -> float:
        """The live backoff hint: occupancy x EWMA slot-hold time — how
        long, given how slots have actually been living, a resubmitter
        should expect to wait for one to free."""
        with self._cond:
            return self._retry_hint_ms_locked()

    def _retry_hint_ms_locked(self) -> float:
        ewma_ms = (
            self._hold_ewma_s * 1e3 if self._hold_samples else 50.0
        )
        occ = (self.slots - len(self._free)) / self.slots
        return max(1.0, occ * ewma_ms)

    def reserve(
        self, nbytes: int, *, timeout: float = 0.25, spans=None
    ) -> int:
        """Claim a free slot for ``nbytes`` WITHOUT copying anything into
        it — the zero-copy seam: the caller fills :meth:`slot_view` (e.g.
        ``recv_into`` straight off a socket) and builds the wire ref with
        :meth:`make_ref`. Flow control and refusal semantics are exactly
        :meth:`put`'s. ``spans``, when a dict, accumulates the slot-wait
        time under ``"ring_wait_s"`` (the transport span)."""
        if nbytes > self.slot_bytes:
            raise _errors.InvalidInput(
                f"tensor of {nbytes} bytes exceeds the shm ring slot "
                f"size ({self.slot_bytes}); resize the input or configure "
                f"larger worker ring slots"
            )
        with self._cond:
            if not self._free and timeout > 0:
                t0 = time.monotonic()
                self._cond.wait_for(
                    lambda: bool(self._free) or self._closed, timeout
                )
                waited = time.monotonic() - t0
                self.waits += 1
                self.wait_s_total += waited
                if spans is not None:
                    spans["ring_wait_s"] = (
                        spans.get("ring_wait_s", 0.0) + waited
                    )
            if self._closed:
                raise _errors.EngineStopped("shm ring is closed")
            if not self._free:
                hint = self._retry_hint_ms_locked()
                raise _errors.Overloaded(
                    f"shm ring full ({self.slots} slots in flight); the "
                    f"peer is not draining responses fast enough — retry "
                    f"in ~{hint:.0f}ms",
                    retry_after_ms=hint,
                )
            slot = self._free.pop()
            self.puts += 1
            self.high_water = max(
                self.high_water, self.slots - len(self._free)
            )
            self._put_t[slot] = time.monotonic()
        return slot

    def slot_view(self, slot: int, nbytes: int) -> memoryview:
        """A writable view over one reserved slot's first ``nbytes``."""
        off = int(slot) * self.slot_bytes
        return memoryview(self._shm.buf)[off:off + int(nbytes)]

    @staticmethod
    def make_ref(slot: int, shape, dtype) -> Dict[str, Any]:
        return {
            "slot": int(slot),
            "shape": [int(s) for s in shape],
            "dtype": np.dtype(dtype).str,
        }

    def put(
        self, arr: np.ndarray, *, timeout: float = 0.25, spans=None
    ) -> Dict[str, Any]:
        """Copy ``arr`` into a free slot; return its wire reference.

        Raises the terminal ``InvalidInput`` when the array cannot fit a
        slot (no amount of retrying shrinks it) and the retryable
        ``Overloaded`` — with the occupancy x EWMA-hold ``retry_after_ms``
        hint — when no slot frees within ``timeout`` (the reader is
        behind: back off and resubmit).
        """
        src = np.asarray(arr)
        if not src.flags["C_CONTIGUOUS"]:
            src = np.ascontiguousarray(src)
            _note_copy("pack_contig", src.nbytes)
        slot = self.reserve(src.nbytes, timeout=timeout, spans=spans)
        view = np.frombuffer(
            self._shm.buf, np.uint8, count=src.nbytes,
            offset=slot * self.slot_bytes,
        )
        view[:] = src.reshape(-1).view(np.uint8)
        self.copies_in += 1
        _note_copy("ring_put", src.nbytes)
        return self.make_ref(slot, src.shape, src.dtype)

    def get(self, ref: Dict[str, Any], *, copy: bool = True) -> np.ndarray:
        """Map a wire reference back to an array (a copy by default —
        the slot is recycled the moment the free message lands; a
        ``copy=False`` borrow is only safe while the borrower controls
        when the free message goes out)."""
        dtype = np.dtype(ref["dtype"])
        shape = tuple(int(s) for s in ref["shape"])
        count = int(np.prod(shape)) if shape else 1
        if count * dtype.itemsize > self.slot_bytes:
            raise _errors.InvalidInput(
                f"shm reference {shape}/{dtype} exceeds the slot size"
            )
        arr = np.frombuffer(
            self._shm.buf, dtype, count=count,
            offset=int(ref["slot"]) * self.slot_bytes,
        ).reshape(shape)
        if copy:
            arr = arr.copy()
            self.copies_out += 1
            _note_copy("ring_get", arr.nbytes)
        return arr

    def free(self, slot: int) -> None:
        """Return a slot to the pool (owner side; idempotence guarded).
        Feeds the slot-hold EWMA behind the retry_after_ms hint."""
        with self._cond:
            if 0 <= slot < self.slots and slot not in self._free:
                t0 = self._put_t.pop(slot, None)
                if t0 is not None:
                    hold = time.monotonic() - t0
                    if self._hold_samples:
                        self._hold_ewma_s += 0.2 * (hold - self._hold_ewma_s)
                    else:
                        self._hold_ewma_s = hold
                    self._hold_samples += 1
                self._free.append(slot)
                self._cond.notify_all()

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "slots": self.slots,
                "slot_bytes": self.slot_bytes,
                "free": len(self._free),
                "puts": self.puts,
                "high_water": self.high_water,
                "hold_ewma_ms": self._hold_ewma_s * 1e3,
                "waits": self.waits,
                "wait_s_total": self.wait_s_total,
                "copies_in": self.copies_in,
                "copies_out": self.copies_out,
            }

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        try:
            self._shm.close()
        except Exception:
            pass
        if self._owner:
            try:
                self._shm.unlink()
            except Exception:
                pass
