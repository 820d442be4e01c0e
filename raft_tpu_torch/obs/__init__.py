"""Observability for the serving engine: the metrics registry and the
device-time ledger (the JAX package's ``raft_tpu/obs``, in part; traces,
the flight recorder and alerts wait for the observability slice)."""

from raft_tpu_torch.obs.ledger import DeviceTimeLedger
from raft_tpu_torch.obs.metrics import (
    DEVICE_TIME_BUCKETS_MS,
    LATENCY_BUCKETS_MS,
    RESIDUAL_BUCKETS,
    Histogram,
    MetricsRegistry,
)

__all__ = [
    "DEVICE_TIME_BUCKETS_MS",
    "DeviceTimeLedger",
    "Histogram",
    "LATENCY_BUCKETS_MS",
    "MetricsRegistry",
    "RESIDUAL_BUCKETS",
]
