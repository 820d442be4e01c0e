"""The port's whole-request serving engine (``pool_capacity=0``) and
``submit_many`` against the JAX package's, on the CPU.

The tiny model and weights of ``tests/test_torch_serve.py`` (its ``tiny``
fixture), bucket 48x64. The engine's pairwise program at one padded batch
against the JAX engine's (``model.apply(emit_all=False)``) on the same
numpy inputs, at fp32 and at ``edge`` (int8 levels, the JAX kernel in
interpret mode); the closed program set against the JAX enumeration; then
the engine's behaviour as the JAX suite defines it (``tests/test_serve.py``:
batch ladder, pipelined dispatch, deadlines and quarantine through the
pipeline) and ``submit_many``'s per-item isolation. Faults come in through
the engine's seams: ``_run_batch`` (a stalled or failing dispatch) and
``_request_flow`` (one request's flow made non-finite).

Tolerances: fp32 flow against JAX 1e-3 px (``tests/test_torch_serve.py``'s
engine-vs-JAX bound: fp32 convs in two libraries over the updates; 8.9e-5
measured); at ``edge`` the flow to 2e-2 px (1.2e-2 measured): a
correlation value within fp32 rounding of a half-step lands on the other
int8 level in the two packages, moving its taps by one quantum (a level's
scale / 127), and the recurrence carries it.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import pytest
import torch

pytest.importorskip("raft_tpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_serve import BUCKET, HW, TINY, _image, _padded, no_onednn, tiny  # noqa: E402,F401

from raft_tpu.kernels.lookup_xtap import FusedLookupCorrBlock as JaxFusedBlock  # noqa: E402
from raft_tpu.models import RAFT_SMALL as JAX_RAFT_SMALL  # noqa: E402
from raft_tpu.models import build_raft as jax_build_raft  # noqa: E402
from raft_tpu.serve import ServeConfig as JaxServeConfig  # noqa: E402
from raft_tpu.serve import ServeEngine as JaxServeEngine  # noqa: E402
from raft_tpu.serve import aot as jax_aot  # noqa: E402

import raft_tpu_torch as rt  # noqa: E402
from raft_tpu_torch.checkpoint import state_dict_from_flax  # noqa: E402
from raft_tpu_torch.models.corr import QuantizedPyramid  # noqa: E402
from raft_tpu_torch.serve import (  # noqa: E402
    DeadlineExceeded,
    Draining,
    PoisonedInput,
    ServeConfig,
    ServeEngine,
    ServeError,
)
from raft_tpu_torch.serve import aot  # noqa: E402
from raft_tpu_torch.serve.engine import _StagingPool  # noqa: E402

torch.set_num_threads(2)

ITERS = 2


def _config(**kw):
    base = dict(
        buckets=(BUCKET,), ladder=(2, 1), max_batch=2, pool_capacity=0, queue_capacity=8, max_wait_ms=4.0,
        default_deadline_ms=30000.0, cooldown_batches=1, recover_after=1, high_watermark=0.5, low_watermark=0.25,
    )
    base.update(kw)
    return ServeConfig(**base)


@pytest.fixture(scope="module")
def engine(tiny):
    with ServeEngine(tiny[2], _config(), device="cpu") as eng:
        yield eng


def _poison(engine, rid_of):
    """Make the flow of the request ``rid_of()`` names non-finite at the
    engine's per-request output seam, in the batch and in its retry."""

    def request_flow(req, flow):
        if req.rid == rid_of():
            flow = np.full_like(flow, np.nan)
        return flow

    engine._request_flow = request_flow


def _slow_dispatch(engine, seconds, which=lambda i: True):
    """Stall the dispatches ``which(i)`` names by ``seconds``."""
    orig, calls = engine._run_batch, [0]

    def run(p1, p2, iters):
        i, calls[0] = calls[0], calls[0] + 1
        if which(i):
            time.sleep(seconds)
        return orig(p1, p2, iters)

    engine._run_batch = run


# -- the programs against JAX -----------------------------------------------------------


def _edge_models(tiny):
    jm = jax_build_raft(
        JAX_RAFT_SMALL.replace(**TINY), corr_block=JaxFusedBlock(num_levels=2, radius=3, dtype=jnp.int8, interpret=True)
    )
    pm = rt.build_raft(rt.RAFT_SMALL.replace(corr_radius=3, corr_impl="fused", corr_dtype="int8", **TINY), device="cpu")
    pm.load_state_dict(state_dict_from_flax(tiny[1]), strict=True)
    return jm, pm


@pytest.mark.parametrize("precision", ["fp32", "edge"])
def test_run_batch_matches_jax_pairwise(tiny, no_onednn, precision):
    """The engine's pairwise program at batch 2 (two requests' padded
    pairs, as staged) against the JAX engine's on the same inputs; at
    'edge' the int8 scale is one a level over the whole batch, so each
    row's flow depends on its neighbour: a batch-1 reference is not it."""
    jm, variables, pm = tiny
    if precision == "edge":
        jm, pm = _edge_models(tiny)
    rng = np.random.default_rng(20)
    p1 = np.concatenate([_padded(_image(rng)) for _ in range(2)])
    p2 = np.concatenate([_padded(_image(rng)) for _ in range(2)])
    apply = jax.jit(partial(jm.apply, train=False, emit_all=False, num_flow_updates=ITERS))
    want = np.asarray(apply(variables, p1, p2))
    eng = ServeEngine(pm, _config(), device="cpu")
    with torch.inference_mode():
        got = eng._run_batch(p1, p2, ITERS).permute(0, 2, 3, 1).numpy()
        alone = np.concatenate([eng._run_batch(p1[i:i + 1], p2[i:i + 1], ITERS).permute(0, 2, 3, 1).numpy()
                                for i in range(2)])
    tol = 1e-3 if precision == "fp32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if precision == "edge":
        assert isinstance(eng._batch_progs.model.corr_block.build_pyramid(
            torch.zeros(1, 24, 6, 8), torch.zeros(1, 24, 6, 8)), QuantizedPyramid)
        # the batch-wide scale: the row without the batch's largest
        # correlation is quantized more coarsely in the batch than alone
        assert np.abs(alone - got).max() > 0
    else:
        np.testing.assert_allclose(alone, got, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pool_capacity", [0, 2], ids=["whole_request", "pool"])
def test_program_specs_equal_jax(tiny, pool_capacity):
    """The closed program set, streams on, as the JAX enumeration keys it;
    in the pool the port's insert and gather are eager index copies, not
    programs, and are the only JAX keys it lacks."""
    jm, variables, pm = tiny
    kw = dict(buckets=(BUCKET,), ladder=(2, 1), max_batch=4, pool_capacity=pool_capacity,
              stream_cache_size=2)
    want = {s.key for s in jax_aot.program_specs(JaxServeEngine(jm, variables, JaxServeConfig(**kw)))}
    got = [s.key for s in aot.program_specs(ServeEngine(pm, ServeConfig(**kw), device="cpu"))]
    assert len(got) == len(set(got))
    assert set(got) == {k for k in want if k[0] not in ("pool_insert", "pool_gather")}
    assert {k[0] for k in want} - {k[0] for k in got} == ({"pool_insert", "pool_gather"} if pool_capacity else set())
    families = {k[0] for k in got}
    assert families == ({"pairwise", "encode", "iterate"} if pool_capacity == 0 else
                        {"pool_step", "pool_begin_pair", "pool_final", "encode", "pool_begin_features"})


# -- the engine's behaviour -----------------------------------------------------------------


def test_staging_pool_rotates_and_zeroes():
    pool = _StagingPool(slots=3, pin=False)
    rng = np.random.default_rng(21)
    rows = [rng.random((1, 4, 4, 3)).astype(np.float32) for _ in range(3)]
    shape = (4, 4, 4, 3)
    a = pool.fill("k", shape, rows, rung=4)
    assert tuple(a.shape) == shape
    for j, row in enumerate(rows):
        np.testing.assert_array_equal(a[j].numpy(), row[0])
    np.testing.assert_array_equal(a[3].numpy(), 0.0)
    b = pool.fill("k", shape, rows[:1], rung=2)
    c = pool.fill("k", shape, rows[:2], rung=2)
    assert len({a.data_ptr(), b.data_ptr(), c.data_ptr()}) == 3
    np.testing.assert_array_equal(a[1].numpy(), rows[1][0])  # not clobbered by the next fills
    d = pool.fill("k", shape, rows[:1], rung=4)  # a's buffer again: pad rows re-zeroed
    assert d.data_ptr() == a.data_ptr()
    np.testing.assert_array_equal(d[1:].numpy(), 0.0)
    pool.mark()
    assert tuple(pool.fill("k", (2, 2, 2, 3), [rows[0][:, :2, :2]], rung=2).shape) == (2, 2, 2, 3)


def test_serves_at_rungs_and_accounts_padding(tiny, no_onednn):
    """A lone request pays rung 1; three concurrent ones co-batch at rung
    4 (ladder 1, 2, 4) with one padded row; every flow equals its own
    batch-1 forward (oneDNN's batch-dependent kernels aside, 1e-5)."""
    pm = tiny[2]
    rng = np.random.default_rng(22)
    with ServeEngine(pm, _config(max_batch=4, max_wait_ms=300.0, ladder=(1,)), device="cpu") as eng:
        one = eng.submit(_image(rng), _image(rng))
        before = eng.stats()
        pairs = [(_image(rng), _image(rng)) for _ in range(3)]
        with ThreadPoolExecutor(3) as ex:
            results = list(ex.map(lambda p: eng.submit(*p), pairs))
        after = eng.stats()
    assert before["dispatched_rows"] == 1 and before["padded_rows"] == 0 and one.num_flow_updates == 1
    assert after["batches"] - before["batches"] == 1
    assert after["dispatched_rows"] - before["dispatched_rows"] == 4 and after["padded_rows"] == 1
    assert after["padding_waste"] == pytest.approx(1 / 5) and after["batch_ladder"] == [1, 2, 4]
    for (a, b), r in zip(pairs, results):
        with torch.inference_mode():
            want = pm(*(torch.from_numpy(_padded(x)).permute(0, 3, 1, 2) for x in (a, b)), num_flow_updates=1,
                      emit_all=False)[0].permute(1, 2, 0).numpy()
        np.testing.assert_allclose(r.flow, want[: HW[0], : HW[1]], rtol=0, atol=1e-5)


def test_iteration_rungs_honored(engine):
    """A per-request cap runs at the largest ladder rung not above it; the
    batch runs at the largest of its members' rungs."""
    rng = np.random.default_rng(23)
    assert engine._iter_rung(None) == 2 and engine._iter_rung(1) == 1 and engine._iter_rung(2) == 2
    assert engine.submit(_image(rng), _image(rng), num_flow_updates=1).num_flow_updates == 1
    assert engine.submit(_image(rng), _image(rng)).num_flow_updates == 2


@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_window_completes_in_dispatch_order(tiny, depth):
    """With a slowed dispatch the window fills to ``pipeline_depth``
    batches in flight (1: strictly synchronous) and requests complete in
    dispatch order."""
    rng = np.random.default_rng(24)
    eng = ServeEngine(tiny[2], _config(max_batch=1, pipeline_depth=depth, max_wait_ms=0.5, queue_capacity=32),
                      device="cpu")
    dispatched, finished = [], []
    orig = eng._dispatch_pair

    def dispatch(live):
        dispatched.extend(r.rid for r in live)
        return orig(live)

    eng._dispatch_pair = dispatch
    _slow_dispatch(eng, 0.05)
    with eng:
        reqs = []
        for _ in range(6):
            r = eng.submit_many([dict(image1=_image(rng), image2=_image(rng),
                                      on_done=lambda h: finished.append(h.rid))])[0]
            reqs.append(r)
        assert all(r.wait(30) for r in reqs)
        stats = eng.stats()
    assert all(r.error is None and np.isfinite(r.result.flow).all() for r in reqs)
    assert stats["inflight_peak"] == depth and stats["worker_errors"] == 0 and stats["expired"] == 0
    assert finished == dispatched and sorted(dispatched) == [r.rid for r in reqs]


def test_deadline_enforced_through_pipeline(tiny):
    """A request whose deadline passes while one dispatch stalls fails
    with DeadlineExceeded; served ones are on time; the engine recovers."""
    rng = np.random.default_rng(25)
    eng = ServeEngine(tiny[2], _config(max_batch=1, pipeline_depth=2, max_wait_ms=0.5, queue_capacity=32),
                      device="cpu")
    _slow_dispatch(eng, 0.5, which=lambda i: i == 1)
    with eng:
        eng.submit(_image(rng), _image(rng))
        with ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(eng.submit, _image(rng), _image(rng), deadline_ms=150) for _ in range(4)]
            outcomes = []
            for f in futs:
                try:
                    outcomes.append(f.result())
                except DeadlineExceeded as e:
                    outcomes.append(e)
        late = [o for o in outcomes if isinstance(o, DeadlineExceeded)]
        served = [o for o in outcomes if not isinstance(o, Exception)]
        assert late and all(np.isfinite(r.flow).all() and r.latency_ms <= 650 for r in served)
        assert np.isfinite(eng.submit(_image(rng), _image(rng)).flow).all() and eng.health()["healthy"]


def test_quarantine_through_pipeline(tiny):
    """One poisoned request among 8 at depth 2: its batch comes back
    non-finite and is retried as singles; exactly that request fails with
    PoisonedInput, the other 7 are served (its batch-mate by the retry)."""
    rng = np.random.default_rng(26)
    eng = ServeEngine(tiny[2], _config(pipeline_depth=2, max_wait_ms=2.0, queue_capacity=32), device="cpu")
    first = []
    _poison(eng, lambda: first[0] if first else None)
    orig = eng._dispatch_pair

    def dispatch(live):
        if not first:
            first.append(live[0].rid)
        return orig(live)

    eng._dispatch_pair = dispatch
    with eng, ThreadPoolExecutor(8) as ex:
        futs = [ex.submit(eng.submit, _image(rng), _image(rng)) for _ in range(8)]
        outcomes = []
        for f in futs:
            try:
                outcomes.append(f.result())
            except PoisonedInput as e:
                outcomes.append(e)
        stats, healthy = eng.stats(), eng.health()["healthy"]
    poisoned = [o for o in outcomes if isinstance(o, PoisonedInput)]
    served = [o for o in outcomes if not isinstance(o, Exception)]
    assert len(poisoned) == 1 and len(served) == 7 and healthy
    assert all(np.isfinite(r.flow).all() for r in served)
    assert stats["quarantined"] == 1 and stats["quarantined_rids"] == first and stats["nonfinite_batches"] >= 1
    assert stats["retried_singles"] <= 1 and sum(r.retried_single for r in served) == stats["retried_singles"]


def test_worker_survives_a_failed_dispatch(engine):
    rng = np.random.default_rng(27)
    orig, calls = engine._run_batch, [0]

    def run(p1, p2, iters):
        calls[0] += 1
        if calls[0] == 1:
            raise ValueError("injected: boom")
        return orig(p1, p2, iters)

    before = engine.stats()["worker_errors"]
    engine._run_batch = run
    try:
        with pytest.raises(ServeError, match="batch execution failed"):
            engine.submit(_image(rng), _image(rng))
        assert np.isfinite(engine.submit(_image(rng), _image(rng)).flow).all()
    finally:
        del engine._run_batch
    assert engine.health()["healthy"] and engine.stats()["worker_errors"] == before + 1


def test_drain_finishes_in_flight_then_refuses(tiny):
    """Batches handed to the worker's window (a slowed dispatch, depth 2)
    finish through a drain; a submit after it is refused retryably."""
    rng = np.random.default_rng(28)
    eng = ServeEngine(tiny[2], _config(max_batch=1), device="cpu")
    _slow_dispatch(eng, 0.1)
    with eng, ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(eng.submit, _image(rng), _image(rng)) for _ in range(2)]
        deadline = time.monotonic() + 10.0
        while eng.stats()["submitted"] < 2 and time.monotonic() < deadline:
            time.sleep(0.002)
        while (eng._queue.depth() or eng._queue.forming()) and time.monotonic() < deadline:
            time.sleep(0.002)  # both handed to the worker's window
        assert eng.drain(timeout=30.0) and eng._inflight_n == 0
        results = [f.result(timeout=30) for f in futs]
        with pytest.raises(Draining) as e:
            eng.submit(_image(rng), _image(rng))
        assert e.value.retryable
    assert all(np.isfinite(r.flow).all() for r in results)


# -- submit_many ---------------------------------------------------------------------------------


def test_submit_many_isolates_errors(tiny):
    """A burst of 8, two items invalid (a batched image, a NaN pixel), on a
    queue of 4 behind a stalled worker: one handle per item, in order; the
    invalid ones finished with InvalidInput, the overflow with a retryable
    Overloaded, the rest served; ``on_done`` fires for every item."""
    rng = np.random.default_rng(29)
    eng = ServeEngine(tiny[2], _config(queue_capacity=4, max_batch=1), device="cpu")
    gate = threading.Event()
    orig = eng._run_batch
    eng._run_batch = lambda p1, p2, iters: (gate.wait(30), orig(p1, p2, iters))[1]
    nan = _image(rng).astype(np.float32)
    nan[1, 2, 0] = np.nan
    items = [dict(image1=_image(rng), image2=_image(rng)) for _ in range(8)]
    items[1]["image1"] = items[1]["image1"][None]
    items[4]["image2"] = nan
    done = []
    for it in items:
        it["on_done"] = done.append
    with eng:
        blocker = eng.submit_many([dict(image1=_image(rng), image2=_image(rng))])[0]
        deadline = time.monotonic() + 10.0
        while eng._queue.depth() and time.monotonic() < deadline:  # the blocker is on the worker
            time.sleep(0.005)
        handles = eng.submit_many(items)
        gate.set()
        assert all(h.wait(30) for h in handles + [blocker])
        stats = eng.stats()
    assert len(handles) == 8 and len(done) == 8 and eng._queue.put_many_calls == 2
    errors = [type(h.error).__name__ if h.error is not None else None for h in handles]
    assert errors == [None, "InvalidInput", None, None, "InvalidInput", None, "Overloaded", "Overloaded"]
    assert all(h.error.retryable for h in handles[6:])
    assert all(np.isfinite(h.result.flow).all() and h.result.flow.shape == HW + (2,)
               for h in handles if h.error is None)
    assert stats["shed"] == 2 and stats["invalid"] == 1 and stats["completed"] == 5


def test_submit_many_slow_path_inline(tiny):
    """An un-bucketed item takes the slow path and comes back served;
    under 'reject' it comes back finished with ShapeRejected."""
    rng = np.random.default_rng(30)
    off = (60, 80)
    for mode, want in (("slow_path", None), ("reject", "ShapeRejected")):
        with ServeEngine(tiny[2], _config(unknown_shape=mode), device="cpu") as eng:
            h = eng.submit_many([dict(image1=_image(rng, off), image2=_image(rng, off)),
                                 dict(image1=_image(rng), image2=_image(rng))])
            assert all(x.wait(30) for x in h)
        assert (type(h[0].error).__name__ if h[0].error else None) == want and h[1].error is None
        if want is None:
            assert h[0].result.slow_path and h[0].result.flow.shape == off + (2,)
