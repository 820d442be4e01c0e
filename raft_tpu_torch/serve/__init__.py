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

    # N replicas behind one router, each a fresh engine from the factory
    # on every (re)boot; on one card they share the device
    def factory(**overrides):
        return ServeEngine(model, dataclasses.replace(cfg, **overrides))
    with ServeRouter.from_factory(factory, 2, RouterConfig(cooldown_s=1.0)) as router:
        Autoscaler(router, AutoscaleConfig(min_replicas=1, max_replicas=2))
        result = router.submit(image1, image2)
        router.restart_replica("r1")          # draining restart, nothing dropped

        # a guarded rollout: mirror, canary, then promote or roll back
        ctrl = router.add_candidate(new_factory, rollout_config=RolloutConfig(min_samples=16))
        ctrl.wait(timeout=600.0)               # RolloutAborted on rollback

    # each replica's engine in a worker process of its own (its own
    # interpreter and CUDA context): the factory must be picklable (a
    # module-level class or function; spawn re-imports its module), and
    # the shared-memory rings are sized to /dev/shm
    router = ServeRouter.from_factory(
        EngineFactory(checkpoint_path), 2, backend="process",
        worker_options=dict(ring_slots=8, slot_bytes=4 << 20, dump_dir="dumps"))

Importing the package builds no kernel and needs no card; the engine runs
on the card unless ``device='cpu'`` is passed. Not ported yet: replicas
behind TCP (``backend='remote'``, ``add_remote_replica``, ROADMAP queue 1
item 4b-ii) raise ``NotImplementedError``.
"""

from raft_tpu_torch.serve import ipc
from raft_tpu_torch.serve.autoscale import AutoscaleConfig, Autoscaler
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
    RolloutAborted,
    ServeError,
    ShapeRejected,
)
from raft_tpu_torch.serve.replica import Replica, ReplicaState
from raft_tpu_torch.serve.rollout import RolloutConfig, RolloutController, RolloutStage
from raft_tpu_torch.serve.router import ConsistentHashRing, RouterConfig, RouterStream, ServeRouter
from raft_tpu_torch.serve.qos import PRIORITIES, QosPolicy, brownout_level, effective_rank
from raft_tpu_torch.serve.tiler import TilePlan, TilePlanner, blend_tiles, nearest_bucket
from raft_tpu_torch.serve.worker import ProcessEngineClient, config_from_wire, serve_result_to_wire

__all__ = [
    "AutoscaleConfig",
    "Autoscaler",
    "ConsistentHashRing",
    "ProcessEngineClient",
    "Replica",
    "ReplicaState",
    "RolloutAborted",
    "RolloutConfig",
    "RolloutController",
    "RolloutStage",
    "RouterConfig",
    "RouterStream",
    "ServeRouter",
    "PRESETS",
    "PRIORITIES",
    "QosPolicy",
    "TilePlan",
    "TilePlanner",
    "blend_tiles",
    "config_from_wire",
    "ipc",
    "serve_result_to_wire",
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
