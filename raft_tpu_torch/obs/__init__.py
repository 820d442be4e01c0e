"""raft_tpu_torch.obs — the observability spine (the port's copy of the JAX
package's ``raft_tpu/obs``, with the same ``__all__``).

  * **Request tracing** (:mod:`raft_tpu_torch.obs.trace`) — low-overhead
    monotonic-clock spans per sampled request (admit, queue_wait,
    dispatch, fetch, pool refine, trainer window phases), carried as a
    ``trace_id`` on :class:`~raft_tpu_torch.serve.ServeResult` and
    sampled via ``ServeConfig.trace_sample_rate``; a
    :class:`TraceContext` joins a request to a trace born elsewhere.
  * **Unified metrics** (:mod:`raft_tpu_torch.obs.metrics`) — typed
    counters / gauges / fixed-bucket histograms; one snapshot feeding the
    ``stats()`` dicts, Prometheus text exposition, and the JSONL
    ``MetricLogger``.
  * **Flight recorder** (:mod:`raft_tpu_torch.obs.recorder`) — a bounded
    ring of structured fault-ladder events plus the last-N completed
    traces, dumped as a postmortem bundle when a ``Watchdog`` trips,
    ``DivergenceError`` raises, or a page-severity alert fires (the JAX
    package's ``scripts/postmortem.py`` reads the bundle).
  * **Device-time ledger** (:mod:`raft_tpu_torch.obs.ledger`) —
    counter-sampled timed dispatches per program family, between CUDA
    events.
  * **Burn-rate alerting** (:mod:`raft_tpu_torch.obs.alerts`) —
    multi-window burn-rate rules over registry snapshots; fire/resolve
    are flight-recorder events and page-severity rules auto-dump a
    postmortem.

:mod:`raft_tpu_torch.obs.profile` additionally toggles
``torch.profiler.record_function`` ranges around the dispatches.
"""

from raft_tpu_torch.obs import profile
from raft_tpu_torch.obs.alerts import (
    AlertEngine,
    AlertRule,
    gauge_value,
    rate,
    ratio_rate,
)
from raft_tpu_torch.obs.ledger import DeviceTimeLedger
from raft_tpu_torch.obs.metrics import (
    DEVICE_TIME_BUCKETS_MS,
    LATENCY_BUCKETS_MS,
    RESIDUAL_BUCKETS,
    Counter,
    CounterGroup,
    Gauge,
    Histogram,
    MetricsRegistry,
    relabel_prometheus,
)
from raft_tpu_torch.obs.recorder import (
    SCHEMA,
    FlightRecorder,
    file_sink,
    logger_sink,
    validate_bundle,
)
from raft_tpu_torch.obs.trace import Trace, TraceContext, Tracer, dedupe_traces

__all__ = [
    "Trace",
    "TraceContext",
    "Tracer",
    "dedupe_traces",
    "relabel_prometheus",
    "Counter",
    "CounterGroup",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "LATENCY_BUCKETS_MS",
    "DEVICE_TIME_BUCKETS_MS",
    "RESIDUAL_BUCKETS",
    "DeviceTimeLedger",
    "AlertEngine",
    "AlertRule",
    "rate",
    "ratio_rate",
    "gauge_value",
    "FlightRecorder",
    "SCHEMA",
    "file_sink",
    "logger_sink",
    "validate_bundle",
    "profile",
]
