"""The port's serving engine (pool path) against the JAX package's, on the
CPU: the pool programs, the engine's flows against the model and against
JAX, the robustness ladder, the host modules, and the golden fixture
through the engine.

Both packages build the tiny model of ``tests/test_serve_pool.py``; the
JAX variables, shaped by ``jax.eval_shape`` and filled from a seeded numpy
generator, are carried across with ``state_dict_from_flax``. The flow
head's last conv is scaled by 0.05 so an update moves the flow a few
pixels (random weights otherwise make the recurrence chaotic). JAX pool
state is NHWC (``coords1`` is ``(cap, h8, w8, 2)``, the pyramid levels
``(cap, Q, hl, wl, 1)``); the port's is NCHW.

Tolerances: the pool programs' coords1, hidden, context and flow to 1e-5
(fp32 convs in two libraries over 4 updates), the pyramid's correlation
values (magnitude 5-20) to the model parity tolerance of
``tests/test_torch_model.py`` (1e-4 relative, 2e-4), residual histories to 1e-5 relative with the sentinel exact,
the converged mask and its packed token equal, frozen slots bit for bit.
The engine's flows against the port's own ``RAFT.forward`` to 1e-5, run
with oneDNN off: oneDNN picks batch-size-dependent conv kernels (a few
1e-6 px apart over 3 updates here), PyTorch's native CPU convs are
batch-invariant, so engine (batch 3-4) and forward (batch 1) then do the
same arithmetic. Against JAX 1e-3.
"""

from concurrent.futures import ThreadPoolExecutor
from functools import partial
import json
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("raft_tpu")

import jax  # noqa: E402

from raft_tpu.models import RAFT_SMALL as JAX_RAFT_SMALL  # noqa: E402
from raft_tpu.models import build_raft as jax_build_raft  # noqa: E402
from raft_tpu.models.corr import CorrBlock as JaxCorrBlock  # noqa: E402
from raft_tpu.models.zoo import init_variables  # noqa: E402
from raft_tpu.serve import bucketing as jax_bucketing  # noqa: E402
from raft_tpu.serve import config as jax_config  # noqa: E402
from raft_tpu.serve import degradation as jax_degradation  # noqa: E402
from raft_tpu.serve import errors as jax_errors  # noqa: E402
from raft_tpu.serve import pool as jax_pool  # noqa: E402
from raft_tpu.serve import queue as jax_queue  # noqa: E402

import raft_tpu_torch as rt  # noqa: E402
from raft_tpu_torch.checkpoint import state_dict_from_flax  # noqa: E402
from raft_tpu_torch.serve import (  # noqa: E402
    DeadlineExceeded,
    Draining,
    InvalidInput,
    Overloaded,
    PoisonedInput,
    ServeConfig,
    ServeEngine,
    ServeError,
    ShapeRejected,
)
from raft_tpu_torch.serve import bucketing, degradation, queue  # noqa: E402
from raft_tpu_torch.serve import errors as port_errors  # noqa: E402
from raft_tpu_torch.serve.pool import (  # noqa: E402
    RESID_SENTINEL,
    PoolPrograms,
    unpack_converged,
    zero_state,
)

torch.set_num_threads(2)

TINY = dict(
    feature_encoder_widths=(8, 8, 12, 16, 24),
    context_encoder_widths=(8, 8, 12, 16, 40),
    motion_corr_widths=(16,),
    motion_flow_widths=(16, 8),
    motion_out_channels=20,
    gru_hidden=24,
    flow_head_hidden=16,
    corr_levels=2,
)
BUCKET, HW = (48, 64), (45, 60)
FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "epe_golden"


def _fill(shapes, rng):
    out = {}
    for key in sorted(shapes):
        leaf = shapes[key]
        if hasattr(leaf, "items"):
            out[key] = _fill(leaf, rng)
            continue
        shp = leaf.shape
        if key == "kernel":
            arr = rng.normal(0.0, np.sqrt(2.0 / (shp[0] * shp[1] * shp[3])), shp)
        elif key == "bias":
            arr = rng.normal(0.0, 0.05, shp)
        elif key == "scale":
            arr = 1.0 + rng.normal(0.0, 0.1, shp)
        elif key == "mean":
            arr = rng.normal(0.0, 0.1, shp)
        elif key == "var":
            arr = rng.uniform(0.5, 1.5, shp)
        else:
            raise KeyError(key)
        out[key] = arr.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def tiny():
    """(jax model, variables, port model on the CPU), the same weights."""
    jm = jax_build_raft(JAX_RAFT_SMALL.replace(**TINY), corr_block=JaxCorrBlock(num_levels=2, radius=3))
    variables = _fill(jax.eval_shape(lambda: init_variables(jm)), np.random.default_rng(0))
    variables["params"]["update_block"]["flow_head"]["conv2"]["kernel"] *= 0.05
    pm = rt.build_raft(rt.RAFT_SMALL.replace(corr_radius=3, **TINY), device="cpu")
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, pm


@pytest.fixture
def no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _image(rng, hw=HW):
    return rng.integers(0, 255, hw + (3,), dtype=np.uint8)


def _config(**kw):
    base = dict(
        buckets=(BUCKET,), ladder=(3, 2, 1), max_batch=4, pool_capacity=3, queue_capacity=8,
        max_wait_ms=4.0, default_deadline_ms=30000.0, cooldown_batches=1, recover_after=1,
        high_watermark=1.0, low_watermark=0.25,
    )
    base.update(kw)
    return ServeConfig(**base)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _padded(im):
    return bucketing.BucketRouter.pad_to(rt.FlowEstimator._normalize(im), BUCKET)


# -- the pool programs against JAX ---------------------------------------------


def _jax_state_np(st):
    """A JAX pool state as numpy in the port's layout."""
    return {
        "pyramid": [np.asarray(lvl)[..., 0] for lvl in st["pyramid"]],
        "coords1": np.asarray(st["coords1"]).transpose(0, 3, 1, 2),
        "hidden": np.asarray(st["hidden"]).transpose(0, 3, 1, 2),
        "context": np.asarray(st["context"]).transpose(0, 3, 1, 2),
        "resid_hist": np.asarray(st["resid_hist"]),
        "converged": np.asarray(st["converged"]),
    }


def _port_state(np_state):
    return {k: (tuple(torch.from_numpy(np.array(x)) for x in v) if k == "pyramid" else torch.from_numpy(np.array(v)))
            for k, v in np_state.items()}


def _load(state, np_state):
    """Overwrite a port pool state with a JAX one (numpy, port layout)."""
    for lvl, v in zip(state["pyramid"], np_state["pyramid"]):
        lvl.copy_(torch.from_numpy(np.array(v)))
    for k in ("coords1", "hidden", "context", "resid_hist", "converged"):
        state[k].copy_(torch.from_numpy(np.array(np_state[k])))


def _assert_state_equal(got, want_np):
    for g, w in zip(got["pyramid"], want_np["pyramid"]):
        np.testing.assert_array_equal(g.numpy(), w)
    for k in ("coords1", "hidden", "context", "resid_hist", "converged"):
        np.testing.assert_array_equal(got[k].numpy(), want_np[k], err_msg=k)


def _assert_state_close(got, want_np):
    for k in ("coords1", "hidden", "context"):
        np.testing.assert_allclose(got[k].numpy(), want_np[k], rtol=0, atol=1e-5, err_msg=k)
    for g, w in zip(got["pyramid"], want_np["pyramid"]):
        # correlation values of magnitude ~5-20: the model parity tolerance
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=2e-4)
    hist, want = got["resid_hist"].numpy(), want_np["resid_hist"]
    sentinel = want >= RESID_SENTINEL * 0.5
    np.testing.assert_array_equal(hist[sentinel], want[sentinel])
    np.testing.assert_allclose(hist[~sentinel], want[~sentinel], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got["converged"].numpy(), want_np["converged"])


class TestPoolProgramsAgainstJax:
    CAP, R = 4, 8

    @pytest.fixture(scope="class")
    def jax_progs(self, tiny):
        return jax_pool.PoolPrograms(tiny[0], resid_len=self.R)

    def _jax(self, tiny, progs, thresh, streak, min_iters, steps, rng_seed=1):
        """The JAX programs' run: admission rows, the state before and
        after each step, the tokens, the gathered carry, the flow."""
        jm, variables, _ = tiny
        rng = np.random.default_rng(rng_seed)
        x1 = rng.uniform(-1, 1, (self.CAP,) + BUCKET + (3,)).astype(np.float32)
        x2 = rng.uniform(-1, 1, (self.CAP,) + BUCKET + (3,)).astype(np.float32)
        st = jax_pool.zero_state(jm, variables, self.CAP, BUCKET, resid_len=self.R)
        rows = progs.begin_pair(variables, x1, x2)
        rows_np = _jax_state_np(rows)
        idx, mask = np.asarray([2, 0, 1, 3], np.int32), np.asarray([True, True, False, True])
        st = progs.insert(st, rows, idx, mask)
        st = dict(st, converged=st["converged"].at[0].set(True))  # slot 0 frozen
        states, tokens = [_jax_state_np(st)], []
        for _ in range(steps):
            c1, hid, hist, conv, tok = progs.step(
                variables, st, np.float32(thresh), np.int32(streak), np.int32(min_iters)
            )
            st = dict(st, coords1=c1, hidden=hid, resid_hist=hist, converged=conv)
            states.append(_jax_state_np(st))
            tokens.append(np.asarray(tok))
        gidx = np.asarray([0, 2, 3, 0], np.int32)
        c1, hid, res = progs.gather(st["coords1"], st["hidden"], st["resid_hist"], gidx)
        flow = np.asarray(progs.final(variables, c1, hid))
        carry = (np.asarray(c1).transpose(0, 3, 1, 2), np.asarray(hid).transpose(0, 3, 1, 2), np.asarray(res))
        return (x1, x2, idx, mask, gidx), rows_np, states, tokens, carry, flow

    def _threshold(self, tiny, progs):
        """A threshold that freezes one admitted slot after its second
        step (streak 2, age 2) and not the other: between the two slots'
        largest residual of the first two steps."""
        _, _, states, _, _, _ = self._jax(tiny, progs, 0.0, 2, 2, steps=2)
        worst = np.maximum(states[1]["resid_hist"][:, -1], states[2]["resid_hist"][:, -1])
        s = 2 if worst[2] < worst[3] else 3
        return s, float(np.sqrt(worst[2] * worst[3]))

    def test_programs_match_jax(self, tiny, jax_progs):
        """Each program given the same input as its JAX counterpart: the
        admission images, the JAX rows to insert, the JAX state before
        each of 4 steps (slot 0 frozen, a threshold that freezes a second
        slot after its second step), the JAX state to gather from, the
        gathered carry to finalize."""
        s_freeze, thresh = self._threshold(tiny, jax_progs)
        steps = 4
        (x1, x2, idx, mask, gidx), jrows, states, tokens, (jc1, jhid, jres), want_flow = self._jax(
            tiny, jax_progs, thresh, 2, 2, steps
        )
        with torch.inference_mode():
            progs = PoolPrograms(tiny[2], "cpu", resid_len=self.R)
            progs.set_knobs(thresh, 2, 2)
            rows = progs.begin_pair(_nchw(x1), _nchw(x2))
            _assert_state_close(rows, jrows)
            st = zero_state(progs, self.CAP, BUCKET)
            progs.insert(st, _port_state(jrows), idx, mask)
            st["converged"][0] = True
            _assert_state_equal(st, states[0])
            for i in range(steps):
                _load(st, states[i])
                token = progs.run_step(st)
                _assert_state_close(st, states[i + 1])
                np.testing.assert_array_equal(token.numpy(), tokens[i])
                np.testing.assert_array_equal(unpack_converged(token.numpy(), self.CAP), states[i + 1]["converged"])
                # the frozen slot passes through bit for bit
                for k in ("coords1", "hidden", "resid_hist"):
                    np.testing.assert_array_equal(st[k][0].numpy(), states[i][k][0], err_msg=k)
            assert states[2]["converged"][s_freeze] and not states[1]["converged"][s_freeze]
            assert not states[2]["converged"][5 - s_freeze]
            _load(st, states[-1])
            c1, hid, res = progs.gather(st["coords1"], st["hidden"], st["resid_hist"], gidx)
            for got, want in zip((c1, hid, res), (jc1, jhid, jres)):
                np.testing.assert_array_equal(got.numpy(), want)
            flow = progs.run_final(c1, hid)
        np.testing.assert_allclose(_nhwc(flow), want_flow, rtol=0, atol=1e-5)

    def test_insert_later_row_wins_and_mask_skips(self, tiny):
        """Two live rows naming one slot: the later wins, as the JAX scan
        applies them in order; a masked lane touches nothing."""
        pm = tiny[2]
        with torch.inference_mode():
            progs = PoolPrograms(pm, "cpu", resid_len=4)
            x = torch.rand(3, 3, *BUCKET) * 2 - 1
            rows = progs.begin_pair(x, x.flip(-1))
            st = zero_state(progs, 3, BUCKET)
            progs.insert(st, rows, [1, 1, 0], [True, True, False])
            assert torch.equal(st["hidden"][1], rows["hidden"][1])
            assert not st["hidden"][0].any() and not st["hidden"][2].any()

    def test_int8_pyramid_refused_in_the_pool(self):
        model = rt.build_raft(rt.RAFT_SMALL.replace(corr_impl="fused", corr_dtype="int8", **TINY), device="cpu")
        with torch.inference_mode(), pytest.raises(NotImplementedError, match="int8"):
            PoolPrograms(model, "cpu").begin_pair(torch.zeros(1, 3, 128, 128), torch.zeros(1, 3, 128, 128))


# -- the engine against the model and JAX --------------------------------------


def test_engine_flows_match_model_and_jax(tiny, no_onednn):
    """6 requests from threads, targets (3, 2, 1, 3, 2, 1), pool capacity 3:
    each flow equals the port's RAFT.forward at its own target (padded
    and cropped the same way) and the JAX model.apply of the same padded
    pair."""
    jm, variables, pm = tiny
    rng = np.random.default_rng(3)
    targets = (3, 2, 1, 3, 2, 1)
    pairs = [(_image(rng), _image(rng)) for _ in targets]
    with ServeEngine(pm, _config(), device="cpu") as engine, ThreadPoolExecutor(len(pairs)) as ex:
        results = list(ex.map(lambda i: engine.submit(*pairs[i], num_flow_updates=targets[i]), range(len(pairs))))
        stats = engine.stats()
    apply = jax.jit(partial(jm.apply, train=False, emit_all=False), static_argnames=("num_flow_updates",))
    for n in sorted(set(targets)):
        idx = [i for i, t in enumerate(targets) if t == n]
        p1 = np.concatenate([_padded(pairs[i][0]) for i in idx])
        p2 = np.concatenate([_padded(pairs[i][1]) for i in idx])
        jwant = np.asarray(apply(variables, p1, p2, num_flow_updates=n))
        for j, i in enumerate(idx):
            res = results[i]
            assert res.num_flow_updates == n and res.exit_reason == "target" and not res.early_exit
            with torch.inference_mode():
                want = _nhwc(pm(_nchw(p1[j:j + 1]), _nchw(p2[j:j + 1]), num_flow_updates=n, emit_all=False))[0]
            np.testing.assert_allclose(res.flow, want[: HW[0], : HW[1]], rtol=0, atol=1e-5)
            np.testing.assert_allclose(res.flow, jwant[j, : HW[0], : HW[1]], rtol=0, atol=1e-3)
    assert stats["completed"] == 6 and stats["pool_ticks"] >= 3
    assert stats["early_exit_iters_saved"] == 6  # (3-3)+(3-2)+(3-1), twice
    assert stats["programs"]["pool_step"] == -1  # no graphs on the CPU


# -- the robustness ladder --------------------------------------------------------


@pytest.fixture(scope="module")
def engine(tiny):
    with ServeEngine(tiny[2], _config(), device="cpu") as eng:
        yield eng


class TestLadder:
    def test_invalid_input_at_admission(self, engine, rng=np.random.default_rng(4)):
        bad = _image(rng).astype(np.float32)
        bad[3, 4, 0] = np.nan
        with pytest.raises(InvalidInput, match="nonfinite"):
            engine.submit(bad, _image(rng))
        with pytest.raises(InvalidInput):
            engine.submit(_image(rng)[None], _image(rng)[None])
        with pytest.raises(InvalidInput, match="num_flow_updates"):
            engine.submit(_image(rng), _image(rng), num_flow_updates=4)

    def test_off_bucket_shape_rejected(self, engine):
        rng = np.random.default_rng(5)
        with pytest.raises(ShapeRejected) as e:
            engine.submit(_image(rng, (60, 80)), _image(rng, (60, 80)))
        assert e.value.supported_buckets == (BUCKET,) and e.value.nearest == BUCKET
        assert engine.stats()["rejected"] >= 1

    def test_expired_deadline(self, engine):
        rng = np.random.default_rng(6)
        with pytest.raises(DeadlineExceeded):
            engine.submit(_image(rng), _image(rng), deadline_ms=1e-3)

    def test_full_queue_sheds_retryably(self, tiny):
        """Slow ticks (a hook on the update block) keep 3 requests in the
        pool; 2 more fill the bounded queue and the next arrival sheds
        retryably; the rest are served."""
        pm = tiny[2]
        handle = pm.update_block.register_forward_hook(lambda mod, inp, out: time.sleep(0.1))
        rng = np.random.default_rng(7)
        try:
            with ServeEngine(pm, _config(queue_capacity=2), device="cpu") as eng, ThreadPoolExecutor(5) as ex:
                futs = []
                deadline = time.monotonic() + 10.0
                for k in range(3):  # one at a time: admitted with the queue calm
                    futs.append(ex.submit(eng.submit, _image(rng), _image(rng)))
                    while eng.stats()["pool"]["occupied"] <= k and time.monotonic() < deadline:
                        time.sleep(0.002)
                futs += [ex.submit(eng.submit, _image(rng), _image(rng)) for _ in range(2)]
                while eng._queue.depth() < 2 and time.monotonic() < deadline:
                    time.sleep(0.005)
                with pytest.raises(Overloaded) as e:
                    eng.submit(_image(rng), _image(rng))
                assert e.value.retryable and e.value.retry_after_ms > 0
                results = [f.result(timeout=30) for f in futs]
                stats = eng.stats()
        finally:
            handle.remove()
        # the resident three at full quality; the full queue degraded the rest
        assert [r.num_flow_updates for r in results[:3]] == [3, 3, 3]
        assert all(np.isfinite(r.flow).all() for r in results)
        assert stats["shed"] == 1 and stats["completed"] == 5

    def test_poisoned_slot_fails_alone(self, tiny):
        """A hook on the port's context encoder turns a slot's state
        non-finite when its first image is all white; that request fails
        with PoisonedInput, its pool neighbours finish."""
        pm = tiny[2]

        def poison(mod, inp, out):
            white = inp[0].flatten(1).amin(dim=1) > 0.999
            return torch.where(white[:, None, None, None], torch.full_like(out, float("nan")), out)

        handle = pm.context_encoder.register_forward_hook(poison)
        rng = np.random.default_rng(8)
        pairs = [(_image(rng), _image(rng)) for _ in range(3)]
        pairs[1] = (np.full(HW + (3,), 255, np.uint8), pairs[1][1])
        try:
            with ServeEngine(pm, _config(), device="cpu") as eng, ThreadPoolExecutor(3) as ex:
                futs = [ex.submit(eng.submit, a, b) for a, b in pairs]
                outcomes = []
                for f in futs:
                    try:
                        outcomes.append(f.result(timeout=60))
                    except ServeError as e:
                        outcomes.append(e)
                stats = eng.stats()
        finally:
            handle.remove()
        assert isinstance(outcomes[1], PoisonedInput)
        assert all(np.isfinite(o.flow).all() for i, o in enumerate(outcomes) if i != 1)
        assert stats["quarantined"] == 1 and stats["completed"] == 2 and stats["worker_errors"] == 0

    def test_flood_sheds_degrades_and_recovers(self, tiny):
        """A 4x-queue flood sheds retryably, degradation assigns lower
        per-request targets at admission, and the level recovers after
        the flood."""
        cfg = _config(high_watermark=0.5, default_deadline_ms=60000.0, pool_capacity=2)
        rng = np.random.default_rng(9)
        results, errors = [], []
        lock = threading.Lock()

        def client(a, b):
            try:
                r = eng.submit(a, b)
            except ServeError as e:
                r = e
            with lock:
                (errors if isinstance(r, ServeError) else results).append(r)

        with ServeEngine(tiny[2], cfg, device="cpu") as eng:
            flood = 4 * cfg.queue_capacity
            pairs = [(_image(rng), _image(rng)) for _ in range(flood)]
            with ThreadPoolExecutor(flood) as ex:
                list(ex.map(lambda p: client(*p), pairs))
            for _ in range(4):  # a calm trickle drives the recovery
                results.append(eng.submit(_image(rng), _image(rng)))
            stats, health = eng.stats(), eng.health()
        shed = [e for e in errors if isinstance(e, Overloaded)]
        assert shed and len(shed) == len(errors)
        assert all(e.retryable and e.retry_after_ms > 0 for e in shed)
        degr = stats["degradation"]
        assert degr["steps_down"] >= 1 and degr["steps_up"] >= 1 and degr["level"] == 0, degr
        assert any(r.degraded and r.num_flow_updates < 3 for r in results)
        assert all(np.isfinite(r.flow).all() for r in results)
        assert stats["expired"] == 0 and stats["worker_errors"] == 0 and stats["completed"] == len(results)
        assert health["healthy"] and health["queue_depth"] == 0

    def test_deadline_early_exit_returns_anytime_flow(self, tiny):
        """A request whose deadline cannot fit its remaining iterations is
        finalized early (a slow step, by a hook on the update block)."""
        pm = tiny[2]
        handle = pm.update_block.register_forward_hook(lambda mod, inp, out: time.sleep(0.3))
        rng = np.random.default_rng(10)
        try:
            cfg = _config(ladder=(8, 1), pool_capacity=1, pipeline_depth=1)
            with ServeEngine(pm, cfg, device="cpu") as eng:
                res = eng.submit(_image(rng), _image(rng), deadline_ms=1500)
                stats = eng.stats()
        finally:
            handle.remove()
        assert res.exit_reason == "deadline" and res.early_exit and 1 <= res.num_flow_updates < 8
        assert np.isfinite(res.flow).all() and stats["early_exits_deadline"] == 1

    def test_drain_finishes_in_flight_then_refuses(self, tiny):
        pm = tiny[2]
        handle = pm.update_block.register_forward_hook(lambda mod, inp, out: time.sleep(0.05))
        rng = np.random.default_rng(11)
        try:
            with ServeEngine(pm, _config(), device="cpu") as eng, ThreadPoolExecutor(2) as ex:
                futs = [ex.submit(eng.submit, _image(rng), _image(rng)) for _ in range(2)]
                deadline = time.monotonic() + 10.0
                while eng.stats()["pool"]["occupied"] < 2 and time.monotonic() < deadline:
                    time.sleep(0.005)
                assert eng.stats()["pool"]["occupied"] == 2
                assert eng.drain(timeout=30.0)
                results = [f.result(timeout=30) for f in futs]
                with pytest.raises(Draining) as e:
                    eng.submit(_image(rng), _image(rng))
                assert e.value.retryable
        finally:
            handle.remove()
        assert all(r.num_flow_updates == 3 and np.isfinite(r.flow).all() for r in results)

    @pytest.mark.parametrize(
        "kw",
        [
            dict(pool_capacity=0),
            dict(stream_warm_start=True),
            dict(unknown_shape="tiled"),
            dict(apply_timeout_s=1.0),
            dict(trace_sample_rate=0.5),
            dict(qos_enabled=True),
        ],
    )
    def test_unported_knobs_raise(self, tiny, kw):
        with pytest.raises(NotImplementedError, match="not ported"):
            ServeEngine(tiny[2], _config(**kw), device="cpu")

    def test_open_stream_not_ported(self, engine):
        with pytest.raises(NotImplementedError, match="open_stream"):
            engine.open_stream()

    def test_slow_path_serves_off_bucket_shape(self, tiny, no_onednn):
        """Under unknown_shape='slow_path' an off-bucket request is served
        whole on the worker thread, between the ticks of pool requests
        submitted beside it; every flow equals RAFT.forward at its own
        shape and target."""
        pm = tiny[2]
        rng = np.random.default_rng(12)
        pairs = [(_image(rng), _image(rng)) for _ in range(3)] + [(_image(rng, (60, 80)), _image(rng, (60, 80)))]
        targets = (3, 3, 3, 2)
        threads = []
        handle = pm.register_forward_hook(lambda *_: threads.append(threading.current_thread().name))
        try:
            with ServeEngine(pm, _config(unknown_shape="slow_path"), device="cpu") as eng, \
                    ThreadPoolExecutor(len(pairs)) as ex:
                results = list(ex.map(lambda i: eng.submit(*pairs[i], num_flow_updates=targets[i]), range(4)))
                stats = eng.stats()
        finally:
            handle.remove()
        res = results[-1]
        assert res.slow_path and res.flow.shape == (60, 80, 2) and res.num_flow_updates == 2
        assert threads == ["raft-serve-worker"] and stats["slow_path"] == 1 and stats["completed"] == 4
        natural = bucketing.BucketRouter((BUCKET,)).natural_shape(60, 80)
        for (a, b), n, r in zip(pairs, targets, results):
            shape = BUCKET if not r.slow_path else natural
            p1, p2 = (bucketing.BucketRouter.pad_to(rt.FlowEstimator._normalize(x), shape) for x in (a, b))
            # the pool's images are NCHW; the slow path's FlowEstimator
            # hands the model NHWC memory viewed as NCHW, as here
            x1, x2 = (torch.from_numpy(p).permute(0, 3, 1, 2) for p in (p1, p2))
            if not r.slow_path:
                x1, x2 = x1.contiguous(), x2.contiguous()
            with torch.inference_mode():
                want = _nhwc(pm(x1, x2, num_flow_updates=n, emit_all=False))[0]
            np.testing.assert_allclose(r.flow, want[: a.shape[0], : a.shape[1]], rtol=0, atol=1e-5)


def test_engine_needs_a_card_unless_cpu(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tiny[2], _config())


# -- host modules against JAX ------------------------------------------------------


BAD_CONFIGS = [
    {"buckets": ()},
    {"buckets": ((45, 64),)},
    {"buckets": ((48, 64), (48, 64))},
    {"ladder": (12, 20, 32)},
    {"ladder": (32, 32)},
    {"ladder": ()},
    {"unknown_shape": "drop"},
    {"high_watermark": 0.2, "low_watermark": 0.5},
    {"max_batch": 0},
    {"queue_capacity": 0},
    {"default_deadline_ms": 0},
    {"apply_timeout_s": 0},
    {"batch_ladder": (2, 4, 8)},
    {"batch_ladder": (1, 4)},
    {"batch_ladder": (1, 4, 2, 8)},
    {"batch_ladder": ()},
    {"pipeline_depth": 0},
    {"stream_cache_size": -1},
    {"pool_capacity": -1},
    {"pool_min_iters": 0},
    {"pool_converge_thresh": 0.0},
    {"pool_converge_streak": 0},
    {"pool_converge_thresh": 0.1, "pool_converge_streak": 40},
    {"drain_retry_after_ms": 0},
    {"trace_sample_rate": 1.5},
    {"ledger_sample_every": -1},
    {"precision": "fast"},
    {"compute_dtype": "float16"},
    {"corr_dtype": "float16"},
    {"corr_dtype": "int8"},
]


class TestHostModulesAgainstJax:
    @pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: ",".join(kw))
    def test_config_validation_errors_equal(self, kw):
        with pytest.raises(ValueError) as want:
            jax_config.ServeConfig(**kw)
        with pytest.raises(ValueError) as got:
            ServeConfig(**kw)
        assert str(got.value) == str(want.value)

    def test_admit_ladders_equal(self):
        for max_batch in (1, 2, 3, 5, 8, 16):
            for cap in (0, 1, 2, 3, 4, 8, 12):
                kw = dict(max_batch=max_batch, pool_capacity=cap)
                want = jax_config.ServeConfig(**kw)
                got = ServeConfig(**kw)
                assert got.resolved_admit_ladder() == want.resolved_admit_ladder()
                assert got.resolved_batch_ladder() == want.resolved_batch_ladder()
        for name in ("quality", "throughput", "edge"):
            assert ServeConfig.preset(name).model_overrides() == jax_config.ServeConfig.preset(name).model_overrides()

    def test_router_equal(self):
        buckets = ((64, 80), (48, 64), (96, 136))
        want, got = jax_bucketing.BucketRouter(buckets), bucketing.BucketRouter(buckets)
        assert got.buckets == want.buckets
        for hw in [(45, 60), (48, 64), (49, 60), (92, 132), (100, 140), (1, 1), (64, 81)]:
            assert got.route(*hw) == want.route(*hw)
            assert got.natural_shape(*hw) == want.natural_shape(*hw)
        img = np.random.default_rng(13).random((1, 45, 60, 3)).astype(np.float32)
        np.testing.assert_array_equal(got.pad_to(img, (48, 64)), want.pad_to(img, (48, 64)))
        np.testing.assert_array_equal(got.crop(img, (40, 50)), want.crop(img, (40, 50)))
        for mod in (jax_bucketing, bucketing):
            with pytest.raises(ValueError, match="exceeds bucket"):
                mod.BucketRouter.pad_to(img, (40, 64))

    def test_token_bucket_equal(self):
        def trace(mod):
            clock = [0.0]
            tb = mod.TokenBucket(2.0, burst=2, clock=lambda: clock[0])
            out = []
            for dt in (0.0, 0.0, 0.0, 0.1, 0.4, 0.0, 1.7, 0.0, 0.0, 0.0):
                clock[0] += dt
                out.append((tb.try_take(), round(tb.retry_after_ms(), 9)))
            return out

        assert trace(bucketing) == trace(jax_bucketing)

    def test_degradation_controller_equal(self):
        seq = [(0.1, None), (0.8, None), (0.9, 50.0), (0.9, None), (0.5, None), (0.1, None), (0.0, None),
               (0.2, 400.0), (0.0, None), (0.0, None), (0.0, None), (1.0, None), (0.0, None)]
        kw = dict(slo_p99_ms=300.0, high_watermark=0.75, low_watermark=0.25, cooldown=1, recover_after=2)
        want = jax_degradation.DegradationController((32, 20, 12), **kw)
        got = degradation.DegradationController((32, 20, 12), **kw)
        assert [got.observe(*s) for s in seq] == [want.observe(*s) for s in seq]
        assert got.snapshot() == want.snapshot()

    @pytest.mark.parametrize("qos", [False, True])
    def test_queue_forming_and_shedding_equal(self, qos):
        """EDF batch forming, per-class headroom and shedding (with QoS:
        a higher-class arrival preempts the newest lowest-class request,
        and seeds first)."""
        def trace(qmod, errmod):
            q = qmod.MicroBatchQueue(4, qos=qos)
            now = time.monotonic()
            x = np.zeros((1, 8, 8, 3), np.float32)
            spec = [((48, 64), 5.0, "batch"), ((48, 64), 1.0, "standard"), ((64, 80), 0.5, "batch"),
                    ((48, 64), 3.0, "standard")]
            for rid, (bucket, slack, pr) in enumerate(spec):
                q.put(qmod.Request(rid, bucket, x, x, (8, 8), now + slack, priority=pr))
            out = []
            try:
                pre = []
                q.put(qmod.Request(9, (48, 64), x, x, (8, 8), now + 9.0, priority="interactive"), preempted=pre)
                out.append(("preempted", [r.rid for r in pre]))
            except errmod.Overloaded as e:
                out.append(("shed", e.retryable, e.retry_after_ms))
            out.append([r.rid for r in q.next_batch(2, 0.0, poll=0.0)])
            out.append([r.rid for r in q.next_batch(4, 0.0, poll=0.0, cap=lambda b, k: 1)])
            out.append([r.rid for r in q.next_batch(4, 0.0, poll=0.0)])
            out.append((q.depth(), q.forming()))
            out.append([r.rid for r in q.next_batch(4, 0.0, poll=0.0)])
            return out

        assert trace(queue, port_errors) == trace(jax_queue, jax_errors)


# -- the golden fixture through the engine ----------------------------------------------


def test_golden_epe_through_the_engine():
    """The golden fixture at 'quality' through ServeEngine, 32 updates:
    each pair padded as the Sintel protocol pads it (split, to the 96x136
    bucket), the flow unpadded; the pixel-weighted EPE within 1e-3 px of
    the reference."""
    from raft_tpu_torch.data import Sintel
    from raft_tpu_torch.eval.padder import InputPadder

    expected = json.loads((FIXTURE / "expected.json").read_text())
    arch = dict(
        feature_encoder_widths=(16, 16, 24, 32, 48), context_encoder_widths=(16, 16, 24, 32, 80),
        motion_corr_widths=(48,), motion_flow_widths=(32, 16), motion_out_channels=40, gru_hidden=48,
        flow_head_hidden=64, corr_levels=3, corr_radius=3,
    )
    model = rt.raft_for_serving(
        ServeConfig.preset("quality"), arch="raft_small", checkpoint=str(FIXTURE / "weights.msgpack"),
        device="cpu", **arch,
    )
    ds = Sintel(str(FIXTURE), split="training", dstype="clean")
    samples = [ds[i] for i in range(len(ds))]
    padders = [InputPadder(s["image1"].shape, mode="sintel") for s in samples]
    cfg = ServeConfig(buckets=((96, 136),), pool_capacity=3, max_batch=3, default_deadline_ms=600_000.0)
    with ServeEngine(model, cfg, device="cpu") as engine, ThreadPoolExecutor(len(samples)) as ex:
        results = list(ex.map(
            lambda i: engine.submit(*padders[i].pad(samples[i]["image1"], samples[i]["image2"])),
            range(len(samples)),
        ))
    epe = np.concatenate([
        np.linalg.norm(p.unpad(r.flow[None])[0] - s["flow"], axis=-1).reshape(-1)
        for p, r, s in zip(padders, results, samples)
    ]).mean()
    assert all(r.num_flow_updates == 32 for r in results)
    assert abs(epe - expected["reference"]["clean"]) < 1e-3, epe
