"""Serving: the precision presets (``ServeConfig.preset``) and the serving
engine, ``ServeEngine`` (the iteration pool, or the whole-request engine at
``pool_capacity=0``, with streams, tiling and QoS), with its typed errors.

    from raft_tpu_torch.serve import ServeConfig, ServeEngine
    cfg = ServeConfig(buckets=((440, 1024),), warmup=True)
    with ServeEngine(raft_for_serving(ServeConfig.preset("quality")), cfg) as engine:
        result = engine.submit(image1, image2)   # ServeResult, (H, W, 2) flow
        with engine.open_stream() as stream:     # encode-once video stream
            results = [stream.submit(frame) for frame in frames]

    # 'edge' (int8 pyramid) is served by the whole-request engine
    cfg = ServeConfig.preset("edge", pool_capacity=0, buckets=((440, 1024),), warmup=True)

    # any frame shape through the captured set, as blended bucket tiles;
    # tenant quotas, class preemption and class-aware brownout
    cfg = ServeConfig(buckets=((440, 1024),), unknown_shape="tiled", qos_enabled=True,
                      qos_tenant_quotas=(("acme", 20.0, 4.0, 0),), warmup=True)
    with ServeEngine(raft_for_serving(ServeConfig.preset("quality")), cfg) as engine:
        # a 375x1242 KITTI pair: two 440x1024 tiles, blended
        result = engine.submit(kitti1, kitti2, priority="interactive", tenant="acme")

Importing the package builds no kernel and needs no card; the engine runs
on the card unless ``device='cpu'`` is passed.
"""

from raft_tpu_torch.serve.config import PRESETS, ServeConfig
from raft_tpu_torch.serve.engine import ServeEngine, ServeResult, StreamSession
from raft_tpu_torch.serve.errors import (
    DeadlineExceeded,
    Draining,
    EngineStopped,
    InvalidInput,
    Overloaded,
    PoisonedInput,
    QuotaExceeded,
    ServeError,
    ShapeRejected,
)
from raft_tpu_torch.serve.qos import PRIORITIES, QosPolicy, brownout_level, effective_rank
from raft_tpu_torch.serve.tiler import TilePlan, TilePlanner, blend_tiles, nearest_bucket

__all__ = [
    "PRESETS",
    "PRIORITIES",
    "QosPolicy",
    "TilePlan",
    "TilePlanner",
    "blend_tiles",
    "brownout_level",
    "effective_rank",
    "nearest_bucket",
    "DeadlineExceeded",
    "Draining",
    "EngineStopped",
    "InvalidInput",
    "Overloaded",
    "PoisonedInput",
    "QuotaExceeded",
    "ServeConfig",
    "ServeEngine",
    "ServeError",
    "ServeResult",
    "ShapeRejected",
    "StreamSession",
]
