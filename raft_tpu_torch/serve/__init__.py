"""Serving: the precision presets (``ServeConfig.preset``) and the serving
engine, ``ServeEngine`` (the iteration pool, or the whole-request engine at
``pool_capacity=0``, with streams), with its typed errors.

    from raft_tpu_torch.serve import ServeConfig, ServeEngine
    cfg = ServeConfig(buckets=((440, 1024),), warmup=True)
    with ServeEngine(raft_for_serving(ServeConfig.preset("quality")), cfg) as engine:
        result = engine.submit(image1, image2)   # ServeResult, (H, W, 2) flow
        with engine.open_stream() as stream:     # encode-once video stream
            results = [stream.submit(frame) for frame in frames]

    # 'edge' (int8 pyramid) is served by the whole-request engine
    cfg = ServeConfig.preset("edge", pool_capacity=0, buckets=((440, 1024),), warmup=True)

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

__all__ = [
    "PRESETS",
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
