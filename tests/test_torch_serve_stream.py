"""Stream serving in the port's engines and ``FlowStream``, against the JAX
package's, on the CPU.

The tiny model and weights of ``tests/test_torch_serve.py`` (its ``tiny``
fixture), bucket 48x64. The stream programs against JAX on the same numpy
inputs: ``encode`` against ``RAFT.encode_frame``, ``iterate`` against
``RAFT.iterate``, ``begin_features`` with a zero ``init_flow`` bit for bit
``begin_pair``'s rows and with a warm one against the JAX pool's
``begin_features``, ``forward_warp_flow`` equal to the JAX function. Then
the engines' stream behaviour as the JAX suite defines it
(``tests/test_serve.py``, ``tests/test_serve_adaptive.py``): stream flow
equal to pairwise flow, the encoder cache hit rate, expired and poisoned
frames invalidating the session, one frame in flight per stream, LRU
eviction, unbucketed shapes rejected, and the warm start's lifecycle in
the pool.

Tolerances: encoder outputs against JAX 1e-4 relative / 2e-4 absolute
(``tests/test_torch_model.py``'s model parity bound); flows against JAX
1e-3 px (``tests/test_torch_serve.py``'s engine bound); the pool state
rows as ``tests/test_torch_serve.py`` holds the pool programs; a stream's
flow against the same engine's pairwise flow 1e-5 px with oneDNN off (the
stream encodes one frame a batch, the pairwise forward two: oneDNN picks
batch-size-dependent kernels, PyTorch's native CPU convs do not).
"""

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import pytest
import torch

pytest.importorskip("raft_tpu")

import jax  # noqa: E402
from test_torch_serve import (  # noqa: E402,F401
    BUCKET,
    HW,
    _assert_state_close,
    _jax_state_np,
    _image,
    _padded,
    no_onednn,
    tiny,
)

from raft_tpu.serve import pool as jax_pool  # noqa: E402

import raft_tpu_torch as rt  # noqa: E402
from raft_tpu_torch.serve import (  # noqa: E402
    DeadlineExceeded,
    InvalidInput,
    PoisonedInput,
    ServeConfig,
    ServeEngine,
    ShapeRejected,
)
from raft_tpu_torch.serve.pool import PoolPrograms, forward_warp_flow  # noqa: E402

torch.set_num_threads(2)

ITERS = 2


def _config(**kw):
    base = dict(
        buckets=(BUCKET,), ladder=(ITERS, 1), max_batch=2, pool_capacity=0, queue_capacity=8, max_wait_ms=0.5,
        default_deadline_ms=30000.0, cooldown_batches=1, recover_after=1, high_watermark=1.0, low_watermark=0.25,
    )
    base.update(kw)
    return ServeConfig(**base)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous()


def _poison_after(engine, n):
    """Non-finite flow for the request that comes after ``n`` requests
    through the engine's per-request output seam (in its retry too)."""
    seen = []

    def request_flow(req, flow):
        if req.rid not in seen:
            seen.append(req.rid)
        return np.full_like(flow, np.nan) if len(seen) > n and req.rid == seen[n] else flow

    engine._request_flow = request_flow


# -- the programs against JAX ------------------------------------------------------------


def test_encode_and_iterate_match_jax(tiny):
    """The engine's ``encode`` at batch 2 against JAX ``encode_frame``; its
    ``iterate`` from the JAX features against JAX ``iterate``."""
    jm, variables, pm = tiny
    rng = np.random.default_rng(40)
    x1, x2 = (rng.uniform(-1, 1, (2,) + BUCKET + (3,)).astype(np.float32) for _ in range(2))
    encode = jax.jit(partial(jm.apply, train=False, method="encode_frame"))
    (jf1, jc1), (jf2, _) = encode(variables, x1), encode(variables, x2)
    iterate = jax.jit(partial(jm.apply, train=False, emit_all=False, num_flow_updates=ITERS, method="iterate"))
    flow = iterate(variables, jf1, jf2, jc1)
    eng = ServeEngine(pm, _config(), device="cpu")
    with torch.inference_mode():
        f1, c1 = eng._run_encode(x1)
        got = eng._run_iterate(*(_nchw(np.asarray(a)) for a in (jf1, jf2, jc1)), ITERS)
    for g, w in ((f1, jf1), (c1, jc1)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(flow), rtol=0, atol=1e-3)


def test_begin_features_cold_is_begin_pair_and_warm_matches_jax(tiny):
    """Zeros as ``init_flow`` reproduce ``begin_pair``'s rows bit for bit
    (from the same encoded features); a warm seed gives the JAX pool's
    ``begin_features`` state."""
    jm, variables, pm = tiny
    rng = np.random.default_rng(41)
    x1, x2 = (rng.uniform(-1, 1, (2,) + BUCKET + (3,)).astype(np.float32) for _ in range(2))
    h8, w8 = BUCKET[0] // 8, BUCKET[1] // 8
    init = rng.normal(0.0, 2.0, (2, h8, w8, 2)).astype(np.float32)
    with torch.inference_mode():
        progs = PoolPrograms(pm, "cpu", resid_len=4)
        f1, f2, ctx = pm._encode_pair(_nchw(x1), _nchw(x2))
        cold = progs.begin_features(f1, f2, ctx, torch.zeros(2, 2, h8, w8))
        want = progs.begin_pair(_nchw(x1), _nchw(x2))
        for k in ("coords1", "hidden", "context", "resid_hist", "converged"):
            assert torch.equal(cold[k], want[k]), k
        assert all(torch.equal(a, b) for a, b in zip(cold["pyramid"], want["pyramid"]))
        warm = progs.run_begin_features(f1, f2, ctx, _nchw(init))
    jprogs = jax_pool.PoolPrograms(jm, resid_len=4)
    jf = [np.asarray(a).transpose(0, 2, 3, 1) for a in (f1, f2, ctx)]
    _assert_state_close(warm, _jax_state_np(jprogs.begin_features(variables, *jf, init)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_warp_flow_equals_jax(seed):
    """Random 1/8-grid flows with many collisions and targets off the grid."""
    rng = np.random.default_rng(seed)
    flow = rng.normal(0.0, 3.0, (7, 9, 2)).astype(np.float32)
    flow[0, 0] = (-20.0, 0.0)
    flow[1:3, 1:3] = (2.0, 1.0)  # four cells onto four, two of them onto occupied cells
    got = forward_warp_flow(flow)
    np.testing.assert_array_equal(got, jax_pool.forward_warp_flow(flow))
    assert got.dtype == np.float32 and (got == 0).all(-1).any() and not np.array_equal(got, flow)


# -- the whole-request engine's streams ----------------------------------------------------


@pytest.fixture(scope="module")
def engine(tiny):
    with ServeEngine(tiny[2], _config(), device="cpu") as eng:
        yield eng


def test_stream_matches_pairwise_and_jax(tiny, engine, no_onednn):
    """Four frames: a prime, then three flows equal to the engine's
    pairwise flows on the same frames and to JAX's; 3 cache hits of 4."""
    jm, variables, _ = tiny
    rng = np.random.default_rng(42)
    frames = [_image(rng) for _ in range(4)]
    before = engine.stats()
    pairwise = [engine.submit(frames[t], frames[t + 1]).flow for t in range(3)]
    with engine.open_stream() as stream:
        first = stream.submit(frames[0])
        streamed = [stream.submit(f) for f in frames[1:]]
    stats = engine.stats()
    assert first.primed and first.flow is None
    apply = jax.jit(partial(jm.apply, train=False, emit_all=False, num_flow_updates=ITERS))
    want = np.asarray(apply(variables, *(np.concatenate([_padded(f) for f in fs]) for fs in (frames[:3], frames[1:]))))
    for t, (p, s) in enumerate(zip(pairwise, streamed)):
        assert not s.primed and s.num_flow_updates == ITERS and s.flow.shape == HW + (2,)
        np.testing.assert_allclose(s.flow, p, rtol=0, atol=1e-5)
        np.testing.assert_allclose(s.flow, want[t, : HW[0], : HW[1]], rtol=0, atol=1e-3)
    assert stats["encode_cache_hits"] - before["encode_cache_hits"] == 3
    assert stats["encode_cache_misses"] - before["encode_cache_misses"] == 1
    assert stats["stream_primes"] - before["stream_primes"] == 1
    assert stats["encoder_cache_hit_rate"] == pytest.approx(
        stats["encode_cache_hits"] / (stats["encode_cache_hits"] + stats["encode_cache_misses"]))


def test_poisoned_frame_invalidates_session(tiny):
    """A frame whose flow is non-finite even alone is quarantined and its
    session primes again instead of pairing across the failure."""
    rng = np.random.default_rng(43)
    eng = ServeEngine(tiny[2], _config(), device="cpu")
    _poison_after(eng, 1)  # the second frame with a flow (the stream's third)
    with eng, eng.open_stream() as stream:
        assert stream.submit(_image(rng)).primed
        assert np.isfinite(stream.submit(_image(rng)).flow).all()
        with pytest.raises(PoisonedInput):
            stream.submit(_image(rng))
        res = stream.submit(_image(rng))
        assert res.primed and res.flow is None
        assert np.isfinite(stream.submit(_image(rng)).flow).all()
        stats = eng.stats()
    assert stats["quarantined"] == 1 and stats["stream_invalidations"] >= 1 and stats["nonfinite_batches"] == 1


def test_expired_frame_invalidates_session(tiny):
    """A frame dropped by its deadline in the queue (the worker stalled by
    a pairwise dispatch) leaves a gap: the next frame primes again."""
    rng = np.random.default_rng(44)
    eng = ServeEngine(tiny[2], _config(), device="cpu")
    orig = eng._run_batch
    eng._run_batch = lambda p1, p2, iters: (time.sleep(0.4), orig(p1, p2, iters))[1]
    with eng, eng.open_stream() as stream:
        assert stream.submit(_image(rng)).primed
        with ThreadPoolExecutor(1) as ex:
            slow = ex.submit(eng.submit, _image(rng), _image(rng))
            time.sleep(0.05)
            with pytest.raises(DeadlineExceeded):
                stream.submit(_image(rng), deadline_ms=100)
            slow.result()
        deadline = time.monotonic() + 5.0
        while eng.stats()["stream_invalidations"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)  # the worker notices the expiry when it pops the frame
        res = stream.submit(_image(rng))
    assert res.primed and res.flow is None and eng.stats()["stream_invalidations"] >= 1


def test_one_frame_in_flight_per_stream(tiny):
    rng = np.random.default_rng(45)
    eng = ServeEngine(tiny[2], _config(), device="cpu")
    orig = eng._run_encode
    eng._run_encode = lambda frames: (time.sleep(0.15), orig(frames))[1]
    with eng:
        stream = eng.open_stream()
        with ThreadPoolExecutor(1) as ex:
            first = ex.submit(stream.submit, _image(rng))
            time.sleep(0.03)
            with pytest.raises(InvalidInput, match="in flight"):
                stream.submit(_image(rng))
            assert first.result().primed


def test_concurrent_streams_keep_their_own_frames(tiny):
    """Four sessions fed from four threads at once (a short switch
    interval): each session primes once, then pairs only its own frames;
    the cache's hit and prime counts add up. Each stream repeats one frame
    of its own, so every pair is that frame's still pair (1e-4 px: other
    batch sizes, oneDNN's other kernels)."""
    rng = np.random.default_rng(50)
    frames = [_image(rng) for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ServeEngine(tiny[2], _config(max_batch=4), device="cpu") as eng:
            def feed(k):
                with eng.open_stream() as stream:
                    return [stream.submit(frames[k]) for _ in range(4)]

            with ThreadPoolExecutor(4) as ex:
                runs = [f.result(timeout=60) for f in [ex.submit(feed, k) for k in range(4)]]
            stats = eng.stats()
    finally:
        sys.setswitchinterval(interval)
    progs = eng._batch_progs
    with torch.inference_mode():
        for k, run in enumerate(runs):
            fm, cx = progs.run_encode(_padded(frames[k]))
            still = progs.run_iterate(fm, fm, cx, ITERS).permute(0, 2, 3, 1).numpy()[0, : HW[0], : HW[1]]
            assert [r.primed for r in run] == [True, False, False, False]
            for r in run[1:]:  # another session's frame would move the flow by pixels
                np.testing.assert_allclose(r.flow, still, rtol=0, atol=1e-4)
    assert stats["stream_primes"] == 4 and stats["encode_cache_hits"] == 12 and stats["completed"] == 16


def test_lru_eviction_unbucketed_shape_and_disabled(tiny):
    """Sessions beyond ``stream_cache_size`` are evicted least recently
    used first and prime again; a frame no bucket admits is rejected
    (streams have no slow path); ``stream_cache_size=0`` turns streams
    off."""
    rng = np.random.default_rng(46)
    with ServeEngine(tiny[2], _config(stream_cache_size=2), device="cpu") as eng:
        s1, s2, s3 = (eng.open_stream() for _ in range(3))
        assert all(s.submit(_image(rng)).primed for s in (s1, s2, s3))  # s3 evicts s1
        assert not s3.submit(_image(rng)).primed
        res = s1.submit(_image(rng))
        assert res.primed and res.flow is None and eng.stats()["stream_evictions"] >= 1
        with pytest.raises(ShapeRejected, match="no bucket"):
            s2.submit(_image(rng, (100, 100)))
    with ServeEngine(tiny[2], _config(stream_cache_size=0), device="cpu") as eng:
        with pytest.raises(InvalidInput, match="disabled"):
            eng.open_stream()
        assert eng.program_counts()["encode"] == -1 and not eng.supports_init_flow


# -- the pool's streams and warm start ---------------------------------------------------


def test_pool_stream_matches_pairwise(tiny, no_onednn):
    """In the iteration pool a stream pair (encode once, then
    ``begin_features`` with a zero seed) gives the pool's pairwise flow,
    within 1e-4 px: the pool's pair admission feeds its convs contiguous
    NCHW images, the stream encode the NHWC-storage frames of the
    whole-request engine and ``FlowEstimator``, and the two layouts run
    other kernels (2.1e-5 px measured)."""
    rng = np.random.default_rng(47)
    frames = [_image(rng) for _ in range(3)]
    with ServeEngine(tiny[2], _config(pool_capacity=2), device="cpu") as eng:
        pairwise = [eng.submit(frames[t], frames[t + 1]).flow for t in range(2)]
        with eng.open_stream() as stream:
            assert stream.submit(frames[0]).primed
            streamed = [stream.submit(f) for f in frames[1:]]
    for p, s in zip(pairwise, streamed):
        assert not s.warm_started and s.num_flow_updates == ITERS
        np.testing.assert_allclose(s.flow, p, rtol=0, atol=1e-4)


def test_warm_start_lifecycle(tiny):
    """The first pair is cold, later pairs warm-started from the previous
    pair's forward-warped flow; a poisoned frame invalidates the session,
    so the stream primes again and its next pair is cold; a seeded pair
    submit is warm-started; warm start off never flags."""
    rng = np.random.default_rng(48)
    eng = ServeEngine(tiny[2], _config(pool_capacity=2, stream_warm_start=True), device="cpu")
    _poison_after(eng, 2)
    with eng, eng.open_stream() as stream:
        assert stream.submit(_image(rng)).primed
        first = stream.submit(_image(rng))
        second = stream.submit(_image(rng))
        assert not first.warm_started and second.warm_started and eng.stats()["stream_warm_starts"] == 1
        with pytest.raises(PoisonedInput):
            stream.submit(_image(rng))
        assert stream.submit(_image(rng)).primed
        after_gap = stream.submit(_image(rng))
        assert not after_gap.warm_started and np.isfinite(after_gap.flow).all()
        seeded = eng.submit(_image(rng), _image(rng), init_flow=np.full((5, 7, 2), 0.5, np.float32))
        assert seeded.warm_started and np.isfinite(seeded.flow).all()
        with pytest.raises(InvalidInput, match="init_flow"):
            eng.submit(_image(rng), _image(rng), init_flow=np.zeros((5, 7), np.float32))
        stats = eng.stats()
    assert stats["stream_invalidations"] >= 1 and stats["convergence"]["warm_start"]
    with ServeEngine(tiny[2], _config(pool_capacity=2), device="cpu") as eng, eng.open_stream() as stream:
        assert [stream.submit(_image(rng)).warm_started for _ in range(3)] == [False] * 3
        assert eng.stats()["stream_warm_starts"] == 0


# -- FlowStream ------------------------------------------------------------------------------


def test_flow_stream_matches_pairwise_and_guards(tiny, no_onednn):
    est = rt.FlowEstimator(tiny[2], num_flow_updates=ITERS, device="cpu")
    rng = np.random.default_rng(49)
    frames = [_image(rng) for _ in range(3)]
    stream = est.open_stream()
    assert stream(frames[0]) is None
    for t in (1, 2):
        np.testing.assert_allclose(stream(frames[t]), est(frames[t - 1], frames[t]), rtol=0, atol=1e-5)
    stream.reset()
    assert stream(frames[0]) is None and stream(frames[1]) is not None
    with pytest.raises(ValueError, match="share one resolution"):
        stream(_image(rng, (40, 60)))
    assert est.stream_programs() == {}  # no graphs on the CPU
