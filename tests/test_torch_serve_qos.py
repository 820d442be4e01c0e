"""The port's QoS (``raft_tpu_torch/serve/qos.py`` and its enforcement in
the serving engine) against the JAX package's, on the CPU.

The module's decisions against ``raft_tpu/serve/qos.py``'s on the same
scripted sequences: ``validate_priority``, ``effective_rank``,
``brownout_level``, ``QosPolicy`` (token buckets driven by one scripted
clock, concurrency caps), ``QosStats`` and ``qos_stats_block``; the
config's QoS and tiler fields against the JAX config's. Then the engine's
behaviour as ``tests/test_serve_zzz_qos.py``'s ``TestEngineQos`` defines
it, on the tiny model of ``tests/test_torch_serve.py`` (its ``tiny``
fixture): the default-off schema, quota refusal and its accounting, a
preempted victim finished once and typed, class-aware brownout in the pool
and in the whole-request engine, and the tiled request charged once.

The preemption cases run an engine whose worker is not started (``_ready``
set by hand), so the queue holds exactly what the test put there.
"""

import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("raft_tpu")

from test_torch_serve import BUCKET, HW, _image, tiny  # noqa: E402,F401

from raft_tpu.serve import config as jax_config  # noqa: E402
from raft_tpu.serve import errors as jax_errors  # noqa: E402
from raft_tpu.serve import qos as jax_qos  # noqa: E402

from raft_tpu_torch.serve import InvalidInput, Overloaded, QuotaExceeded, ServeConfig, ServeEngine, qos  # noqa: E402
from raft_tpu_torch.serve.engine import ServeResult  # noqa: E402

torch.set_num_threads(2)

LADDER = (3, 2, 1)


def _config(**kw):
    base = dict(
        buckets=(BUCKET,), ladder=LADDER, max_batch=4, pool_capacity=3, queue_capacity=8, max_wait_ms=4.0,
        default_deadline_ms=30000.0, cooldown_batches=1, recover_after=1, high_watermark=1.0, low_watermark=0.25,
        qos_enabled=True,
    )
    base.update(kw)
    return ServeConfig(**base)


def _item(rng, **kw):
    return dict(image1=_image(rng), image2=_image(rng), **kw)


# -- the module against JAX -----------------------------------------------------------


class TestQosUnitsAgainstJax:
    def test_classes_and_keys_equal(self):
        assert qos.PRIORITIES == jax_qos.PRIORITIES
        assert (qos.DEFAULT_PRIORITY, qos.DEFAULT_TENANT) == (jax_qos.DEFAULT_PRIORITY, jax_qos.DEFAULT_TENANT)
        assert qos.QOS_STATS_KEYS == jax_qos.QOS_STATS_KEYS and qos.QOS_CLASS_KEYS == jax_qos.QOS_CLASS_KEYS
        for p in qos.PRIORITIES + ("nonsense", ""):
            assert qos.rank_of(p) == jax_qos.rank_of(p)

    def test_validate_priority_equal(self):
        for p in (None,) + qos.PRIORITIES:
            assert qos.validate_priority(p) == jax_qos.validate_priority(p)
        for bad in ("premium", "", "Batch"):
            with pytest.raises(jax_errors.InvalidInput) as want:
                jax_qos.validate_priority(bad)
            with pytest.raises(InvalidInput) as got:
                qos.validate_priority(bad)
            assert str(got.value) == str(want.value)

    def test_effective_rank_and_brownout_equal(self):
        now = 1000.0
        for rank in range(3):
            for age_ms in (0.0, 100.0, 499.9, 500.0, 2000.0):
                for aging_ms in (250.0, 500.0):
                    args = (rank, now - age_ms / 1e3, aging_ms, now)
                    assert qos.effective_rank(*args) == jax_qos.effective_rank(*args)
            for n_levels in (1, 2, 3, 5):
                for level in range(-1, n_levels):
                    assert qos.brownout_level(level, rank, n_levels) == jax_qos.brownout_level(level, rank, n_levels)

    def test_policy_decisions_equal_on_a_scripted_sequence(self):
        """Admissions and releases over four tenants (rate only,
        concurrency only, both, unlisted) on one scripted clock: the same
        refusals, retry hints, messages and snapshots, step by step."""
        quotas = (("r", 10.0, 2, 0), ("c", 0.0, 0, 2), ("rc", 5.0, 3.0, 1), ("burst0", 4.0, 0.5, 0))
        clock = [0.0]
        pols = [mod.QosPolicy(quotas) for mod in (qos, jax_qos)]
        for pol in pols:
            for st in pol._tenants.values():
                if st.bucket is not None:
                    st.bucket._clock = lambda: clock[0]
                    st.bucket._last = 0.0
        rng = np.random.default_rng(0)
        tenants = ("r", "c", "rc", "burst0", "u")
        outcomes = []
        for step in range(200):
            clock[0] += float(rng.choice([0.0, 0.01, 0.05, 0.2]))
            tenant = tenants[rng.integers(len(tenants))]
            op = "release" if rng.random() < 0.35 else "admit"
            got = []
            for pol, err in zip(pols, (QuotaExceeded, jax_errors.QuotaExceeded)):
                if op == "release":
                    pol.release(tenant)
                    got.append(("released",))
                    continue
                try:
                    pol.admit(tenant, "standard")
                    got.append(("admitted",))
                except err as e:
                    got.append(("refused", str(e), e.retry_after_ms, e.tenant, e.retryable))
            assert got[0] == got[1], (step, tenant, op, got)
            assert pols[0].snapshot() == pols[1].snapshot(), step
            outcomes.append(got[0][0])
        assert {"admitted", "refused", "released"} <= set(outcomes)

    def test_stats_and_block_equal(self):
        stats = [mod.QosStats(window=4) for mod in (qos, jax_qos)]
        rng = np.random.default_rng(1)
        classes = qos.PRIORITIES + ("bogus",)
        for _ in range(60):
            cls = classes[rng.integers(len(classes))]
            if rng.random() < 0.5:
                key = qos.QosStats.COUNTER_KEYS[rng.integers(len(qos.QosStats.COUNTER_KEYS))]
                for st in stats:
                    st.count(cls, key)
            else:
                lat = float(rng.uniform(1.0, 100.0))
                for st in stats:
                    st.observe_latency(cls, lat)
        assert stats[0].snapshot() == stats[1].snapshot()
        quotas = (("t", 1.0, 1, 2),)
        for enabled, pol in ((True, (qos.QosPolicy(quotas), jax_qos.QosPolicy(quotas))), (False, (None, None))):
            got = qos.qos_stats_block(enabled, 250.0, stats[0], pol[0])
            want = jax_qos.qos_stats_block(enabled, 250.0, stats[1], pol[1])
            assert got == want and frozenset(got) == qos.QOS_STATS_KEYS
            for cls in qos.PRIORITIES:
                assert frozenset(got["classes"][cls]) == qos.QOS_CLASS_KEYS


NEW_FIELDS = ("tile_overlap_px", "tile_pad_penalty", "tile_max_tiles", "qos_default_priority", "qos_default_tenant",
              "qos_tenant_quotas", "qos_aging_ms")
BAD_CONFIGS = [
    {"tile_overlap_px": 7},
    {"tile_pad_penalty": -0.5},
    {"tile_max_tiles": 0},
    {"qos_default_priority": "premium"},
    {"qos_default_tenant": ""},
    {"qos_aging_ms": 0.0},
    {"qos_tenant_quotas": (("a", 1.0, 1),)},
    {"qos_tenant_quotas": (("", 1.0, 1, 0),)},
    {"qos_tenant_quotas": (("a", 1.0, 1, 0), ("a", 2.0, 2, 0))},
    {"qos_tenant_quotas": (("a", 1.0, 0.5, 0),)},
    {"qos_tenant_quotas": (("a", 0.0, 0, 1.5),)},
]


class TestConfigAgainstJax:
    def test_new_fields_defaults_equal(self):
        port, ref = ServeConfig(), jax_config.ServeConfig()
        for name in NEW_FIELDS:
            assert getattr(port, name) == getattr(ref, name), name

    @pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: ",".join(kw))
    def test_validation_errors_equal(self, kw):
        with pytest.raises(ValueError) as want:
            jax_config.ServeConfig(**kw)
        with pytest.raises(ValueError) as got:
            ServeConfig(**kw)
        assert str(got.value) == str(want.value)


# -- the engine's QoS --------------------------------------------------------------------


def _idle_engine(model, **kw):
    """An engine admitting requests with no worker to take them: the queue
    holds exactly what the test puts there."""
    eng = ServeEngine(model, _config(**kw), device="cpu")
    eng._ready.set()
    return eng


class TestEngineQos:
    def test_default_off_pin(self, tiny):
        eng = ServeEngine(tiny[2], ServeConfig(buckets=(BUCKET,)), device="cpu")
        assert eng.config.qos_enabled is False
        assert eng._queue._qos is False and eng._qos_policy is None
        block = eng.stats()["qos"]
        assert block["enabled"] is False and frozenset(block) == qos.QOS_STATS_KEYS
        assert block["tenants"] == {}
        for cls in qos.PRIORITIES:
            assert frozenset(block["classes"][cls]) == qos.QOS_CLASS_KEYS
        assert {"tiled", "tiles"} <= set(ServeResult.__dataclass_fields__)

    def test_quota_refusal_and_accounting(self, tiny):
        with ServeEngine(tiny[2], _config(qos_tenant_quotas=(("capped", 0.0, 0, 1),)), device="cpu") as eng:
            rng = np.random.default_rng(1)
            im1, im2 = _image(rng), _image(rng)
            # hold the tenant's only slot: the next "capped" submit is
            # refused, typed and retryable, before anything is queued
            eng._qos_policy.admit("capped", "standard")
            submitted0 = eng.stats()["submitted"]
            with pytest.raises(QuotaExceeded) as e:
                eng.submit(im1, im2, tenant="capped", priority="batch")
            assert e.value.tenant == "capped" and e.value.retryable
            assert eng.stats()["submitted"] == submitted0
            handle = eng.submit_many([dict(image1=im1, image2=im2, tenant="capped")])[0]
            assert isinstance(handle.error, QuotaExceeded)
            eng._qos_policy.release("capped")
            res = eng.submit(im1, im2, tenant="capped", priority="interactive")
            assert res.flow.shape == HW + (2,)
            block = eng.stats()["qos"]
        assert block["enabled"] is True
        assert block["tenants"]["capped"] == {"inflight": 0, "quota_refused": 2, "max_concurrent": 1,
                                              "rate_limited": False}
        assert block["classes"]["batch"]["quota_refused"] == 1
        assert block["classes"]["standard"]["quota_refused"] == 1
        assert block["classes"]["interactive"]["submitted"] == 1
        assert block["classes"]["interactive"]["completed"] == 1 and block["classes"]["interactive"]["n"] == 1
        with ServeEngine(tiny[2], _config(), device="cpu") as eng, pytest.raises(InvalidInput, match="unknown priority"):
            eng.submit(im1, im2, priority="premium")

    def test_preempted_victim_finished_once_typed(self, tiny):
        """A full queue: an interactive arrival displaces the newest batch
        request, a standard one the other batch request; each victim is
        finished exactly once with a retryable ``Overloaded``, counted
        once as a shed and as preempted, and its quota slot returned. A
        batch arrival with nobody below it sheds."""
        eng = _idle_engine(tiny[2], queue_capacity=2, qos_tenant_quotas=(("t", 0.0, 0, 8),))
        rng = np.random.default_rng(2)
        calls = []
        try:
            first = eng.submit_many([_item(rng, priority="batch", tenant="t", on_done=calls.append)
                                     for _ in range(2)])
            assert not any(h.done for h in first)
            assert eng.stats()["qos"]["tenants"]["t"]["inflight"] == 2
            top = eng.submit_many([_item(rng, priority="interactive", tenant="t")])[0]
            assert not top.done and first[1].done and not first[0].done   # newest batch request displaced
            mid = eng.submit_many([_item(rng, priority="standard", tenant="t")])[0]
            assert not mid.done and first[0].done
            late = eng.submit_many([_item(rng, priority="batch", tenant="t")])[0]
            assert isinstance(late.error, Overloaded) and "queue at capacity" in str(late.error)
            for v in first:
                assert isinstance(v.error, Overloaded) and v.error.retryable and "preempted" in str(v.error)
                assert not v.finish(error=RuntimeError("again"))   # set-once
            assert sorted(calls, key=id) == sorted(first, key=id)   # one completion callback each
            st = eng.stats()
            assert st["shed"] == 3 and st["queue_depth"] == 2
            classes = st["qos"]["classes"]
            assert classes["batch"]["preempted"] == 2 and classes["batch"]["shed"] == 1
            assert classes["interactive"]["preempted"] == classes["standard"]["preempted"] == 0
            assert st["qos"]["tenants"]["t"]["inflight"] == 2
        finally:
            eng.stop()
        assert top.done and mid.done and st["qos"]["classes"]["batch"]["submitted"] == 3

    def test_quota_released_on_shed(self, tiny):
        eng = _idle_engine(tiny[2], queue_capacity=1, qos_tenant_quotas=(("t", 0.0, 0, 5),))
        rng = np.random.default_rng(3)
        try:
            handles = eng.submit_many([_item(rng, tenant="t") for _ in range(3)])
            assert [h.done for h in handles] == [False, True, True]
            assert eng.stats()["qos"]["tenants"]["t"]["inflight"] == 1
            with pytest.raises(Overloaded):
                eng.submit(_image(rng), _image(rng), tenant="t")
            assert eng.stats()["qos"]["tenants"]["t"]["inflight"] == 1
            assert eng.stats()["qos"]["classes"]["standard"]["shed"] == 3
        finally:
            eng.stop()
        assert eng.stats()["qos"]["tenants"]["t"]["inflight"] == 0

    @pytest.mark.parametrize("qos_enabled", [True, False])
    def test_pool_brownout_by_class(self, tiny, qos_enabled):
        """Under pressure (level 1, pinned through the engine's ``_observe``
        seam) each pool slot's target browns out by its class: interactive
        at the level's rung, batch at the floor; with QoS off every class
        runs the level's rung."""
        with ServeEngine(tiny[2], _config(qos_enabled=qos_enabled), device="cpu") as eng:
            eng._observe = lambda live: (LADDER[1], 1)
            rng = np.random.default_rng(4)
            handles = eng.submit_many([_item(rng, priority=p) for p in qos.PRIORITIES])
            res = [h.wait(30.0) and h.result for h in handles]
        got = [(r.num_flow_updates, r.level) for r in res]
        assert got == ([(2, 1), (1, 2), (1, 2)] if qos_enabled else [(2, 1)] * 3)
        assert res[2].num_flow_updates <= res[0].num_flow_updates

    def test_whole_request_brownout_by_class(self, tiny):
        """A whole-request batch runs at its highest class's level: a batch
        of batch-class requests at the floor, a batch holding an
        interactive request at the level's rung; both rungs of the ladder."""
        with ServeEngine(tiny[2], _config(pool_capacity=0), device="cpu") as eng:
            eng._observe = lambda live: (LADDER[1], 1)
            rng = np.random.default_rng(5)
            low = [h.wait(30.0) and h.result for h in
                   eng.submit_many([_item(rng, priority="batch") for _ in range(2)])]
            mixed = [h.wait(30.0) and h.result for h in
                     eng.submit_many([_item(rng, priority="interactive"), _item(rng, priority="batch")])]
        assert [(r.num_flow_updates, r.level) for r in low] == [(1, 2)] * 2
        assert [(r.num_flow_updates, r.level) for r in mixed] == [(2, 1)] * 2
        assert eng.stats()["batches"] == 2
        calm = ServeEngine(tiny[2], _config(pool_capacity=0), device="cpu")
        assert calm._qos_levels([], 3, 0) == (3, 0)

    def test_forecast_slack_by_class(self, tiny):
        eng = ServeEngine(tiny[2], _config(), device="cpu")
        off = ServeEngine(tiny[2], _config(qos_enabled=False), device="cpu")
        reqs = [type("R", (), {"rank": r})() for r in range(3)]
        assert [eng._qos_forecast_slack(r) for r in reqs] == [1.0] * 3
        eng._controller._level = off._controller._level = 1
        assert [eng._qos_forecast_slack(r) for r in reqs] == [1.0, 1.5, 2.0]
        assert [off._qos_forecast_slack(r) for r in reqs] == [1.0] * 3

    def test_tiled_request_charged_once(self, tiny):
        """Under 'tiled' a 4-tile request is one admission of its tenant:
        a concurrency cap of 1 and a one-token bucket both let it through,
        and its tiles inherit its class."""
        quotas = (("one", 0.0, 0, 1), ("rate", 0.001, 1, 0))
        with ServeEngine(tiny[2], _config(unknown_shape="tiled", queue_capacity=16, qos_tenant_quotas=quotas),
                         device="cpu") as eng:
            rng = np.random.default_rng(6)
            for tenant in ("one", "rate"):
                res = eng.submit(_image(rng, (60, 100)), _image(rng, (60, 100)), tenant=tenant, priority="batch")
                assert res.tiled and res.tiles == 4
            with pytest.raises(QuotaExceeded):   # the rate bucket's one token is spent
                eng.submit(_image(rng, (60, 100)), _image(rng, (60, 100)), tenant="rate")
            block = eng.stats()["qos"]
        assert block["tenants"]["one"]["inflight"] == 0 and block["tenants"]["one"]["quota_refused"] == 0
        assert block["tenants"]["rate"]["quota_refused"] == 1
        assert block["classes"]["batch"]["submitted"] == block["classes"]["batch"]["completed"] == 8

    def test_stream_frames_carry_their_class(self, tiny):
        with ServeEngine(tiny[2], _config(qos_tenant_quotas=(("s", 0.0, 0, 1),)), device="cpu") as eng:
            rng = np.random.default_rng(7)
            with eng.open_stream() as stream:
                first = stream.submit(_image(rng), priority="interactive", tenant="s")
                second = stream.submit(_image(rng), priority="interactive", tenant="s")
            block = eng.stats()["qos"]
        assert first.primed and second.flow.shape == HW + (2,)
        assert block["classes"]["interactive"]["submitted"] == block["classes"]["interactive"]["completed"] == 2
        assert block["tenants"]["s"]["inflight"] == 0

    def test_concurrent_quota_never_exceeded(self, tiny):
        """Eight threads of one tenant capped at two in flight: every
        submit is served or refused typed, and the cap held throughout."""
        peak, lock = [0], threading.Lock()
        with ServeEngine(tiny[2], _config(qos_tenant_quotas=(("t", 0.0, 0, 2),)), device="cpu") as eng:
            policy = eng._qos_policy
            admit = policy.admit

            def watched(tenant, priority):
                admit(tenant, priority)
                with lock:
                    peak[0] = max(peak[0], policy._tenants["t"].inflight)

            policy.admit = watched
            outcomes = []

            def client(seed):
                rng = np.random.default_rng(seed)
                for _ in range(2):
                    try:
                        eng.submit(_image(rng), _image(rng), tenant="t")
                        outcomes.append("ok")
                    except QuotaExceeded:
                        outcomes.append("quota")
                        time.sleep(0.01)

            threads = [threading.Thread(target=client, args=(10 + i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60.0)
            block = eng.stats()["qos"]
        assert len(outcomes) == 16 and "ok" in outcomes and peak[0] <= 2
        assert block["tenants"]["t"]["inflight"] == 0
        assert block["tenants"]["t"]["quota_refused"] == outcomes.count("quota")
