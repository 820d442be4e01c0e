"""The port's tiler (``raft_tpu_torch/serve/tiler.py``) and tiled serving
against the JAX package's, on the CPU.

The planner's plans, infeasibility errors and ``nearest_bucket`` hints
equal the JAX ``TilePlanner``'s over a grid of shapes and bucket sets;
``blend_tiles`` and the planner's feathered weights are the JAX
functions' bit for bit on seeded flows, and constant and linear fields
come back exact. The whole tiled path at fp32 (the tiny model and
weights of ``tests/test_torch_serve.py``'s ``tiny`` fixture, bucket 48x64)
against the JAX planner + the JAX model's ``apply(emit_all=False)`` on the
same padded tiles + the JAX blend, in the pool and at ``pool_capacity=0``,
within 1e-3 px (the engine-vs-JAX bound of ``tests/test_torch_serve.py``).
Then the engine's behaviour as ``tests/test_serve_zzzzz_tiler.py``'s
``TestEngineTiled`` defines it: one ``put_many`` acquisition a request,
shed tiles retried inside the deadline, no program outside the closed set
for new shapes, the envelope's accounting.
"""

from functools import partial

import numpy as np
import pytest
import torch

pytest.importorskip("raft_tpu")

import jax  # noqa: E402
from test_observability import TILER_STATS_KEYS  # noqa: E402
from test_torch_serve import BUCKET, TINY, _image, no_onednn, tiny  # noqa: E402,F401

from raft_tpu.inference import FlowEstimator as JaxFlowEstimator  # noqa: E402
from raft_tpu.serve import bucketing as jax_bucketing  # noqa: E402
from raft_tpu.serve import errors as jax_errors  # noqa: E402
from raft_tpu.serve import tiler as jax_tiler  # noqa: E402

from raft_tpu_torch.serve import PoisonedInput, ServeConfig, ServeEngine, ShapeRejected, aot, tiler  # noqa: E402

torch.set_num_threads(2)

ITERS = 2
# bucket sets: the engine's, a multi-bucket set whose cost model must pick,
# a tall and a wide bucket, and the golden gate's tiled bucket
BUCKET_SETS = [
    ((48, 64),),
    ((48, 64), (64, 80), (96, 136)),
    ((96, 48), (48, 96)),
    ((96, 128),),
]
SHAPES = [
    (1, 1), (45, 60), (48, 64), (49, 65), (60, 100), (92, 132), (100, 70), (375, 1242 // 8), (33, 500),
    (200, 40), (96, 136), (97, 137), (720 // 8, 1280 // 8), (17, 300), (250, 250),
]
PLANNER_KW = [dict(), dict(overlap_px=8, pad_penalty=0.0), dict(overlap_px=24, pad_penalty=3.0, max_tiles=6)]


def _config(**kw):
    base = dict(
        buckets=(BUCKET,), ladder=(ITERS, 1), max_batch=4, pool_capacity=3, queue_capacity=16, max_wait_ms=4.0,
        default_deadline_ms=30000.0, cooldown_batches=1, recover_after=1, high_watermark=1.0, low_watermark=0.25,
        unknown_shape="tiled",
    )
    base.update(kw)
    return ServeConfig(**base)


def _pair(rng, hw):
    return _image(rng, hw), _image(rng, hw)


def _plan_fields(p):
    return (p.hw, p.bucket, [(t.y0, t.x0, t.h, t.w) for t in p.tiles], p.grid, p.overlap, p.dispatched_px, p.pad_px,
            p.cost, p.n_tiles, p.pad_frac, p.waste_frac)


# -- the planner against JAX --------------------------------------------------------


class TestPlannerAgainstJax:
    @pytest.mark.parametrize("kw", PLANNER_KW, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
    @pytest.mark.parametrize("buckets", BUCKET_SETS, ids=lambda b: "+".join(f"{h}x{w}" for h, w in b))
    def test_plans_and_refusals_equal(self, buckets, kw):
        """Same bucket, tiles, waste (and every other field) on every
        shape; an infeasible shape raises the same typed error, message,
        bucket list and ``nearest`` hint; the cache counters agree."""
        want_p, got_p = jax_tiler.TilePlanner(buckets, **kw), tiler.TilePlanner(buckets, **kw)
        for hw in SHAPES + SHAPES[:4]:   # the repeats hit the plan cache
            try:
                want = _plan_fields(want_p.plan(hw))
            except jax_errors.ShapeRejected as e:
                with pytest.raises(ShapeRejected) as got:
                    got_p.plan(hw)
                assert str(got.value) == str(e)
                assert got.value.nearest == e.nearest and got.value.supported_buckets == e.supported_buckets
                continue
            assert _plan_fields(got_p.plan(hw)) == want, hw
        assert (got_p.plans_built, got_p.plan_cache_hits) == (want_p.plans_built, want_p.plan_cache_hits)

    def test_degenerate_and_constructor_errors_equal(self):
        for hw in ((0, 10), (10, 0)):
            with pytest.raises(jax_errors.ShapeRejected) as want:
                jax_tiler.TilePlanner(((48, 64),)).plan(hw)
            with pytest.raises(ShapeRejected) as got:
                tiler.TilePlanner(((48, 64),)).plan(hw)
            assert str(got.value) == str(want.value)
        for kw in (dict(overlap_px=7), dict(pad_penalty=-1.0), dict(max_tiles=0)):
            with pytest.raises(ValueError) as want:
                jax_tiler.TilePlanner(((48, 64),), **kw)
            with pytest.raises(ValueError) as got:
                tiler.TilePlanner(((48, 64),), **kw)
            assert str(got.value) == str(want.value)
        assert tiler.RECEPTIVE_MARGIN_PX == jax_tiler.RECEPTIVE_MARGIN_PX

    @pytest.mark.parametrize("buckets", BUCKET_SETS + [(), ((64, 64), (48, 80))], ids=str)
    def test_nearest_bucket_equal(self, buckets):
        for hw in SHAPES + [(64, 64), (48, 80), (56, 72), (70, 60)]:
            assert tiler.nearest_bucket(hw, buckets) == jax_tiler.nearest_bucket(hw, buckets), hw


# -- the blend against JAX ------------------------------------------------------------


class TestBlendAgainstJax:
    @pytest.mark.parametrize("hw", [(45, 100), (60, 100), (92, 132), (100, 70), (130, 250)])
    def test_weights_and_blend_bitwise(self, hw):
        """The feathered weights and the blended canvas are the JAX
        functions' bit for bit, on the JAX plan and on the port's."""
        buckets = ((48, 64), (64, 80))
        want_p, got_p = jax_tiler.TilePlanner(buckets), tiler.TilePlanner(buckets)
        wplan, gplan = want_p.plan(hw), got_p.plan(hw)
        wweights, gweights = want_p.weights(wplan), got_p.weights(gplan)
        assert got_p.weights(gplan) is gweights  # cached per plan
        for w, g in zip(wweights, gweights):
            np.testing.assert_array_equal(g, w)
        rng = np.random.default_rng(sum(hw))
        flows = [rng.normal(0.0, 3.0, (t.h, t.w, 2)).astype(np.float32) for t in gplan.tiles]
        want = jax_tiler.blend_tiles(wplan, wweights, flows)
        got = tiler.blend_tiles(gplan, gweights, flows)
        assert got.dtype == np.float32 and got.shape == hw + (2,)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("hw", [(92, 132), (60, 100), (45, 200)])
    def test_constant_and_linear_fields_exact(self, hw):
        """A field the tiles agree on comes back exactly: the weights
        place tile flows and never offset their values (a seam carries no
        bias)."""
        p = tiler.TilePlanner(((48, 64),))
        plan = p.plan(hw)
        weights = p.weights(plan)
        const = tiler.blend_tiles(plan, weights, [np.full((t.h, t.w, 2), (1.5, -2.25), np.float32)
                                                  for t in plan.tiles])
        np.testing.assert_allclose(const, np.broadcast_to(np.float32((1.5, -2.25)), hw + (2,)), rtol=0, atol=1e-6)
        ys, xs = np.meshgrid(np.arange(hw[0], dtype=np.float32), np.arange(hw[1], dtype=np.float32), indexing="ij")
        field = np.stack([0.25 * xs - 3.0, -0.5 * ys + 1.0], axis=-1)
        lin = tiler.blend_tiles(plan, weights, [field[t.y0:t.y0 + t.h, t.x0:t.x0 + t.w] for t in plan.tiles])
        np.testing.assert_allclose(lin, field, rtol=0, atol=1e-4)
        # every canvas pixel carries usable weight
        wsum = np.zeros(hw, np.float32)
        for t, w in zip(plan.tiles, weights):
            assert w.shape == (t.h, t.w) and (w > 0).all()
            wsum[t.y0:t.y0 + t.h, t.x0:t.x0 + t.w] += w
        assert (wsum > 0.5).all()


# -- the whole tiled path against JAX ----------------------------------------------


TILED_HW = ((45, 100), (60, 100))  # row padding + column seam; a 2x2 grid


@pytest.fixture(scope="module")
def jax_tiled(tiny):
    """The JAX reference of each TILED_HW request: the JAX planner, the
    JAX model's forward on the padded tiles (one batch), the JAX blend."""
    jm, variables, _ = tiny
    rng = np.random.default_rng(40)
    pairs = [_pair(rng, hw) for hw in TILED_HW]
    planner = jax_tiler.TilePlanner((BUCKET,))
    plans = [planner.plan(hw) for hw in TILED_HW]
    tiles = [[], []]
    for (im1, im2), plan in zip(pairs, plans):
        for k, im in enumerate((im1, im2)):
            x = JaxFlowEstimator._normalize(im)
            tiles[k] += [jax_bucketing.BucketRouter.pad_to(x[:, t.y0:t.y0 + t.h, t.x0:t.x0 + t.w], BUCKET)
                         for t in plan.tiles]
    apply = jax.jit(partial(jm.apply, train=False, emit_all=False, num_flow_updates=ITERS))
    flows = np.asarray(apply(variables, np.concatenate(tiles[0]), np.concatenate(tiles[1])))
    wants, i = [], 0
    for plan in plans:
        per_tile = [flows[i + j, :t.h, :t.w] for j, t in enumerate(plan.tiles)]
        i += plan.n_tiles
        wants.append(jax_tiler.blend_tiles(plan, planner.weights(plan), per_tile))
    return pairs, [p.n_tiles for p in plans], wants


@pytest.mark.parametrize("pool_capacity", [3, 0], ids=["pool", "whole_request"])
def test_tiled_flow_matches_jax(tiny, no_onednn, jax_tiled, pool_capacity):
    """The engine's tiled flow (fp32, CPU) against the JAX planner + model
    + blend on the same padded tiles, within 1e-3 px."""
    pairs, n_tiles, wants = jax_tiled
    with ServeEngine(tiny[2], _config(pool_capacity=pool_capacity), device="cpu") as eng:
        results = [eng.submit(*pair) for pair in pairs]
    for res, n, want, hw in zip(results, n_tiles, wants, TILED_HW):
        assert res.tiled and res.tiles == n and res.bucket == BUCKET and res.num_flow_updates == ITERS
        assert res.flow.shape == hw + (2,)
        np.testing.assert_allclose(res.flow, want, rtol=0, atol=1e-3)


# -- the engine's tiled behaviour --------------------------------------------------------


@pytest.fixture(scope="module")
def engine(tiny):
    """One shared 'tiled' pool engine; queue_capacity 16 holds the 9-tile
    (92, 132) plan whole, so the one-acquisition count is exact."""
    with ServeEngine(tiny[2], _config(), device="cpu") as eng:
        yield eng


class TestEngineTiled:
    def test_off_bucket_served_tiled(self, engine):
        res = engine.submit(*_pair(np.random.default_rng(1), (92, 132)))
        assert res.tiled is True and res.tiles == 9 and res.bucket == BUCKET  # 3x3 over (48, 64)
        assert res.flow.shape == (92, 132, 2) and np.isfinite(res.flow).all()
        assert res.exit_reason == "target" and res.num_flow_updates == ITERS

    def test_on_bucket_requests_untouched(self, engine):
        rng = np.random.default_rng(2)
        res = engine.submit(*_pair(rng, (45, 60)))
        assert res.tiled is False and res.tiles == 0
        # submit_tiled on an on-bucket shape falls through to submit
        res = engine.submit_tiled(*_pair(rng, (45, 60)))
        assert res.tiled is False and res.flow.shape == (45, 60, 2)

    def test_one_put_many_acquisition_per_request(self, engine):
        before = engine._queue.put_many_calls
        tb0 = engine.stats()["tiler"]
        res = engine.submit_tiled(*_pair(np.random.default_rng(3), (92, 132)))
        tb1 = engine.stats()["tiler"]
        assert res.tiled and res.tiles == 9
        assert engine._queue.put_many_calls - before == 1
        assert tb1["admission_acquisitions"] - tb0["admission_acquisitions"] == 1
        assert tb1["tiles_submitted"] - tb0["tiles_submitted"] == 9
        assert tb1["tiles_retried"] == tb0["tiles_retried"]

    def test_no_program_outside_the_closed_set(self, engine):
        """New off-bucket shapes run only programs of the closed set
        (``aot.program_specs``), capture nothing and take no slow path."""
        keys, orig = [], engine.ledger.run

        def run(key, fn):
            keys.append(key)
            return orig(key, fn)

        allowed = {s.key for s in aot.program_specs(engine)}
        c0, slow0 = aot.capture_events(), engine.stats()["slow_path"]
        engine.ledger.run = run
        try:
            rng = np.random.default_rng(4)
            for hw in ((60, 100), (91, 131), (100, 70)):
                res = engine.submit(*_pair(rng, hw))
                assert res.tiled and res.flow.shape == hw + (2,)
        finally:
            del engine.ledger.run
        ran = {k for k in keys if k[0] not in ("pool_insert", "pool_gather")}
        assert ran and ran <= allowed, ran - allowed
        assert aot.capture_events() == c0 and engine.stats()["slow_path"] == slow0

    def test_envelope_accounting(self, engine):
        tb0 = engine.stats()["tiler"]
        submitted0 = engine.stats()["submitted"]
        res = engine.submit(*_pair(np.random.default_rng(5), (92, 132)))
        st = engine.stats()
        tb = st["tiler"]
        assert res.tiled and frozenset(tb) == TILER_STATS_KEYS
        assert tb["enabled"] is True and tb["overlap_px"] == 16
        assert tb["requests"] - tb0["requests"] == 1 and tb["completed"] - tb0["completed"] == 1
        assert tb["failures"] == tb0["failures"]
        assert 0.0 < tb["waste_frac"] < 1.0 and tb["blend_ms"]["n"] > tb0["blend_ms"]["n"]
        assert tb["plans_built"] >= 1 and tb["plan_cache_hits"] >= 1
        # the tiles are the queue's citizens; the envelope is not counted
        assert st["submitted"] - submitted0 == 9

    def test_submit_many_routes_off_bucket_item_through_the_tiler(self, engine):
        rng = np.random.default_rng(6)
        completed0 = engine.stats()["completed"]
        items = [dict(zip(("image1", "image2"), _pair(rng, (45, 60)))),
                 dict(zip(("image1", "image2"), _pair(rng, (60, 100))))]
        handles = engine.submit_many(items)
        for h in handles:
            assert h.wait(30.0) and h.error is None
        assert not handles[0].result.tiled
        assert handles[1].result.tiled and handles[1].result.tiles == 4
        # 1 on-bucket + 4 tiles + the tiled item itself (its rid was
        # counted submitted, so its success is counted completed)
        assert engine.stats()["completed"] - completed0 == 6

    def test_terminal_tile_error_fails_the_request_typed(self, engine):
        """A tile whose flow comes back non-finite is quarantined; the
        tiled request fails with that tile's typed error."""
        failures0 = engine.stats()["tiler"]["failures"]
        engine._request_flow = lambda req, flow: np.full_like(flow, np.nan) if req.orig_hw == (48, 64) else flow
        try:
            with pytest.raises(PoisonedInput):
                engine.submit(*_pair(np.random.default_rng(7), (60, 100)))
        finally:
            del engine._request_flow
        assert engine.stats()["tiler"]["failures"] == failures0 + 1

    def test_infeasible_shape_rejected_with_hint(self, tiny):
        with ServeEngine(tiny[2], _config(tile_max_tiles=2), device="cpu") as eng:
            with pytest.raises(ShapeRejected) as e:
                eng.submit(*_pair(np.random.default_rng(8), (92, 132)))
            assert e.value.nearest == BUCKET and e.value.supported_buckets == (BUCKET,)
            assert eng.stats()["tiler"]["failures"] == 1 and eng.stats()["rejected"] == 1

    @pytest.mark.parametrize("pool_capacity", [3, 0], ids=["pool", "whole_request"])
    def test_shed_tiles_retry_within_deadline(self, tiny, pool_capacity):
        """A 9-tile plan against a queue of 8 sheds a tile at admission;
        the envelope retries it inside the request's deadline and serves
        the canvas."""
        with ServeEngine(tiny[2], _config(queue_capacity=8, pool_capacity=pool_capacity), device="cpu") as eng:
            res = eng.submit(*_pair(np.random.default_rng(9), (92, 132)), deadline_ms=60000)
            tb = eng.stats()["tiler"]
        assert res.tiled and res.flow.shape == (92, 132, 2) and np.isfinite(res.flow).all()
        assert tb["tiles_retried"] >= 1 and tb["completed"] == 1 and tb["failures"] == 0
        assert tb["admission_acquisitions"] == 1

    def test_default_is_reject(self, tiny):
        """Under the default 'reject' the tiler block still reports, off;
        submit_tiled serves all the same."""
        with ServeEngine(tiny[2], _config(unknown_shape="reject"), device="cpu") as eng:
            rng = np.random.default_rng(10)
            with pytest.raises(ShapeRejected):
                eng.submit(*_pair(rng, (60, 100)))
            res = eng.submit_tiled(*_pair(rng, (60, 100)))
            tb = eng.stats()["tiler"]
        assert res.tiled and res.tiles == 4
        assert tb["enabled"] is False and tb["completed"] == 1 and frozenset(tb) == TILER_STATS_KEYS
