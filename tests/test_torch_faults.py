"""The port's stall watchdog, fault injector and host-sync tripwire, and
the Trainer's and ``StabilityMonitor``'s use of them, on the CPU.

* ``Watchdog`` in main-thread mode (``StallError`` raised at the stalled
  call, all-thread stacks in the dump) and in callback mode (the callback
  on the watcher thread, no signal handler), each trip a recorder event
  and a bundle valid under JAX's ``validate_bundle``;
* ``FaultInjector``: plan matching, actions, and each installer over the
  port's own seams;
* ``HostSyncTripwire`` counting each patched site, scoped by ``arm`` /
  ``pause``, its patches restored;
* the Trainer's window loop (tiny raft_small, 128x128, windows of 2)
  making no armed host sync between its boundaries, a stall injected into
  its data fetch raising ``StallError`` at ``data/next``;
* ``StabilityMonitor``'s recorder events and divergence bundle equal to
  the JAX monitor's for one scripted skip sequence.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("raft_tpu")

from test_torch_train_window import _config, _model, chairs, tiny_arch  # noqa: E402,F401

from raft_tpu.obs.recorder import FlightRecorder as JaxFlightRecorder  # noqa: E402
from raft_tpu.obs.recorder import validate_bundle as jax_validate_bundle  # noqa: E402
from raft_tpu.train import stability as jax_stability  # noqa: E402

from raft_tpu_torch.obs import FlightRecorder  # noqa: E402
from raft_tpu_torch.train import Trainer  # noqa: E402
from raft_tpu_torch.train import stability  # noqa: E402
from raft_tpu_torch.utils.faults import FaultInjector, StallError, Watchdog, tear_checkpoint  # noqa: E402
from raft_tpu_torch.utils.tripwire import HostSyncError, HostSyncTripwire  # noqa: E402

torch.set_num_threads(2)


# -- the watchdog ----------------------------------------------------------------


def test_watchdog_main_thread_mode(tmp_path):
    """A stalled section raises StallError in the main thread near the
    timeout, with every thread's stack in the dump, a recorder event and
    a valid bundle; healthy sections and beats never trip; the SIGUSR1
    handler is restored on close."""
    import signal

    before = signal.getsignal(signal.SIGUSR1)
    dump, rec = tmp_path / "stalls.log", FlightRecorder(proc="trainer")
    with Watchdog(0.3, poll=0.05, dump_path=str(dump), recorder=rec) as wd:
        for _ in range(3):
            with wd.section("ok"):
                time.sleep(0.02)
        with wd.section("alive"):
            for _ in range(4):
                time.sleep(0.1)
                wd.beat()
        time.sleep(0.4)  # disarmed idle time never counts
        assert wd.stall_count == 0
        t0 = time.monotonic()
        with pytest.raises(StallError, match="'spin' stalled for more than 0.3s"):
            with wd.section("spin"):
                time.sleep(30)
        assert time.monotonic() - t0 < 3.0
    assert wd.stall_count == 1 and wd.last_stall == "spin"
    text = dump.read_text()
    assert "watchdog: 'spin' exceeded 0.3s" in text and "Thread" in text
    assert [e["section"] for e in rec.events("watchdog_trip")] == ["spin"]
    assert rec.last_bundle["reason"] == "watchdog_trip:spin" and jax_validate_bundle(rec.last_bundle) == []
    assert signal.getsignal(signal.SIGUSR1) == before
    with pytest.raises(ValueError, match="positive"):
        Watchdog(0)


def test_watchdog_callback_mode():
    """``install_handler=False`` off the main thread: a section with
    ``on_timeout`` calls back on the watcher thread once per arm, and the
    guarded code runs on undisturbed."""
    out = {}

    def worker():
        wd = Watchdog(0.2, poll=0.05, install_handler=False)
        calls = []
        with wd.section("serve/apply", on_timeout=lambda name: calls.append((name, threading.current_thread().name))):
            time.sleep(0.6)
        out.update(calls=calls, stalls=wd.stall_count, handler=wd._handler_installed)
        wd.close()

    t = threading.Thread(target=worker)
    t.start()
    t.join(10)
    assert out["calls"] == [("serve/apply", "raft-watchdog")]
    assert out["stalls"] == 1 and out["handler"] is False


# -- the fault injector -------------------------------------------------------------


def test_fault_injector_plans_and_actions(tmp_path):
    inj = FaultInjector()
    seen = []
    inj.on("a", when=1, action=ValueError("boom"))
    inj.on("a", when={2, 3}, action=KeyError)
    inj.on("b", when=lambda i, ctx: ctx == "x", action=seen.append)
    inj.on("c", when=0, action=0.05)
    inj.fire("a")
    with pytest.raises(ValueError, match="boom"):
        inj.fire("a")
    for _ in range(2):
        with pytest.raises(KeyError, match="injected fault"):
            inj.fire("a")
    inj.fire("b", "y")
    inj.fire("b", "x")
    t0 = time.monotonic()
    inj.fire("c")
    assert time.monotonic() - t0 >= 0.05
    assert dict(inj.counts) == {"a": 4, "b": 2, "c": 1} and dict(inj.fired) == {"a": 3, "b": 1, "c": 1}
    assert seen == ["x"]
    # the model-fault and serve actions
    batch = {"image1": torch.ones(2, 3, 4, 4), "image2": torch.ones(2, 3, 4, 4)}
    FaultInjector.nan_grads(batch)
    FaultInjector.loss_spike(batch)
    assert torch.isnan(batch["image1"]).all() and torch.equal(batch["image2"], torch.full((2, 3, 4, 4), 100.0))
    ctx = {"rid": 3, "flow": np.zeros((4, 4, 2), np.float32)}
    FaultInjector.nan_flow(ctx)
    assert np.isnan(ctx["flow"]).all()
    # a committed checkpoint torn after its save
    step_dir = tmp_path / "ckpt" / "4"
    step_dir.mkdir(parents=True)
    (step_dir / "state.pt").write_bytes(b"x" * 100)

    class Manager:
        directory = str(tmp_path / "ckpt")

        def save(self, step, state, **kw):
            return step == 4

    mgr = Manager()
    inj2 = FaultInjector().on("ckpt.commit", when=0, action=FaultInjector.tear)
    with inj2.patch_checkpoint_commits(mgr):
        assert mgr.save(4, None) and not mgr.save(5, None)
    assert (step_dir / "state.pt").stat().st_size == 50 and inj2.counts["ckpt.commit"] == 1
    assert "save" not in vars(mgr)  # restored
    with pytest.raises(FileNotFoundError):
        tear_checkpoint(str(tmp_path / "ckpt"), 9)


def test_patch_reads_and_patch_engine_seams(tmp_path):
    """``patch_reads`` sees reads through both data modules; ``patch_engine``
    wraps every dispatch seam of the port's engine (names, stages, ctx)
    and restores them."""
    from raft_tpu_torch.data import datasets, io

    path = tmp_path / "a.ppm"
    path.write_bytes(b"P6\n2 2\n255\n" + bytes(12))
    inj = FaultInjector().on("io.read", when=1, action=OSError("flaky"))
    with inj.patch_reads():
        io.read_image(str(path))
        with pytest.raises(OSError, match="flaky"):
            datasets.read_image(str(path))
    assert inj.counts["io.read"] == 2 and io.read_image.__name__ == "read_image"

    calls = []

    class Engine:
        def _run_batch(self, p1, p2, iters):
            calls.append("pair")

        def _run_encode(self, frames):
            calls.append("encode")

        def _run_iterate(self, f1, f2, ctx, iters):
            calls.append("iterate")

        def _run_pool_begin(self, p1, p2):
            calls.append("pool_begin")

        def _run_pool_begin_features(self, f1, f2, ctx, init_flow):
            calls.append("pool_begin_features")

        def _run_pool_step(self, pool):
            calls.append("pool_step")

        def _run_pool_final(self, coords1, hidden):
            calls.append("pool_final")

        def _request_flow(self, req, flow):
            return flow

    eng, x = Engine(), torch.zeros(2, 3, 8, 8)
    pool = type("Pool", (), {"state": {"coords1": torch.zeros(5, 2, 1, 1)}})()
    ctxs = []
    inj = FaultInjector().on("infer.slow_apply", when=lambda i, ctx: True, action=ctxs.append)
    inj.on("infer.nan_flow", when=lambda i, ctx: ctx["rid"] == 7, action=FaultInjector.nan_flow)
    with inj.patch_engine(eng):
        eng._run_batch(x, x, 12)
        eng._run_encode(x)
        eng._run_iterate(x, x, x, 20)
        eng._run_pool_begin(x, x)
        eng._run_pool_begin_features(x, x, x, x)
        eng._run_pool_step(pool)
        eng._run_pool_final(x, x)
        req = type("Req", (), {"rid": 7})()
        flow = eng._request_flow(req, np.zeros((2, 2, 2), np.float32))
    assert calls == ["pair", "encode", "iterate", "pool_begin", "pool_begin_features", "pool_step", "pool_final"]
    assert [(c["stage"], c["batch"], c["iters"]) for c in ctxs] == [
        ("pair", 2, 12), ("encode", 2, 0), ("iterate", 2, 20), ("pool_begin", 2, 0),
        ("pool_begin_features", 2, 0), ("pool_step", 5, 1), ("pool_final", 2, 0)]
    assert np.isnan(flow).all()
    assert not vars(eng)  # every seam restored to the class's


# -- the tripwire ---------------------------------------------------------------------


def test_tripwire_counts_each_site():
    orig_sync = torch.cuda.synchronize
    a = torch.tensor([1.0, 2.0])
    with HostSyncTripwire(device_types=("cpu",)) as tw:
        (a * 2).sum()  # tensor work without a host read: free
        assert tw.total == 0
        a.sum().item()
        a.tolist()
        a.numpy()
        a.cpu()
        float(a[0])
        int(a[0])
        bool(a[0] > 0)
        [0, 1, 2][torch.tensor(1)]
        for fn in (torch.cuda.synchronize, lambda: torch.cuda.Event.synchronize(object()),
                   lambda: torch.cuda.Stream.synchronize(object())):
            try:
                fn()  # no card here: each raises after being counted
            except Exception:
                pass
        with tw.pause():
            a.sum().item()
        tw.disarm()
        float(a[1])
        tw.arm()
        snap = tw.snapshot()
        with pytest.raises(HostSyncError, match="11 host sync"):
            tw.assert_none()
    assert snap == dict.fromkeys(HostSyncTripwire.TENSOR_SITES, 1) | {
        "cuda.synchronize": 1, "Event.synchronize": 1, "Stream.synchronize": 1}
    assert "item" not in torch.Tensor.__dict__ and torch.cuda.synchronize is orig_sync
    with HostSyncTripwire() as tw:  # default: CUDA tensors only
        a.sum().item()
        assert tw.total == 0


# -- the Trainer ---------------------------------------------------------------------------


class _LoopTripwire(HostSyncTripwire):
    """Counts the trainer's own thread only: on the CPU the pipeline's
    staging buffers are CPU tensors its prefetch thread fills through
    ``.numpy()`` (host memory on the card as well, never counted there)."""

    def _hit(self, site):
        if threading.current_thread() is threading.main_thread():
            super()._hit(site)


def test_trainer_window_loop_makes_no_host_sync(chairs, tiny_arch, tmp_path):
    """Windows of 2 between boundaries every 4 steps: from the first
    window's return to each boundary's one fetch, nothing touches the
    host (the tripwire holds CPU tensors to the rule a CUDA tensor obeys
    on the card), with the traces, phase histograms and counters on."""
    trainer = Trainer(_config(tmp_path, window_size=2, num_steps=8, log_every=4, checkpoint_every=4), chairs,
                      init_from=_model().state_dict())
    tw = _LoopTripwire(armed=False, device_types=("cpu",))
    window_fn, host_window = trainer.window_fn, trainer._host_window

    def arming(state, batch):
        out = window_fn(state, batch)
        tw.arm()  # count from the first window's return ...
        return out

    def disarming(window):
        tw.disarm()  # ... to the boundary's fetch
        return host_window(window)

    trainer.window_fn, trainer._host_window = arming, disarming
    with tw:
        trainer.run(log_fn=lambda *_: None)
    tw.assert_none("the Trainer's window loop between boundaries")
    assert int(trainer.state.step) == 8
    traces = trainer.tracer.snapshot()
    assert [t["kind"] for t in traces] == ["train_window"] * 4
    assert [sp["name"] for sp in traces[1]["spans"]] == ["data_wait", "dispatch", "metric_fetch", "checkpoint"]
    snap = trainer.metrics.snapshot()
    assert snap["train/counters/windows"] == 4 and snap["train/counters/boundaries"] == 2
    assert snap["train/dispatch_ms_count"] == 4 and snap["train/counters/checkpoints"] == 2


def test_data_fetch_stall_raises_stall_error(chairs, tiny_arch, tmp_path):
    """A stall injected into the trainer's data fetch (``patch_batches``'
    ``data.next`` site) raises StallError at ``data/next`` near the
    timeout, writes ``<log_dir>/stall_stacks.log``, and dumps a valid
    bundle through the recorder into the logger's events file."""
    log_dir = tmp_path / "logs"
    trainer = Trainer(_config(None, num_steps=4, log_every=1, watchdog_timeout=0.5, log_dir=str(log_dir)), chairs,
                      init_from=_model().state_dict())
    inj = FaultInjector().on("data.next", when=2, action=30.0)
    t0 = time.monotonic()
    with inj.patch_batches(trainer), pytest.raises(StallError, match="'data/next' stalled"):
        trainer.run(log_fn=lambda *_: None)
    assert time.monotonic() - t0 < 20.0
    assert trainer.watchdog.stall_count == 1 and trainer.watchdog.last_stall == "data/next"
    assert inj.counts["data.next"] == 3 and inj.counts["step.nan_grads"] == 2
    text = (log_dir / "stall_stacks.log").read_text()
    assert "'data/next' exceeded" in text and "Thread" in text
    bundle = trainer.recorder.last_bundle
    assert bundle["reason"] == "watchdog_trip:data/next" and jax_validate_bundle(bundle) == []
    assert [t["kind"] for t in bundle["traces"]] == ["train_window"] * 2
    assert os.path.getsize(log_dir / "events.jsonl") > 0
    assert "_next_batch" not in vars(trainer)  # the seams restored


# -- the stability monitor ----------------------------------------------------------------


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("t", "wall", "dumped_wall", "dumped_t", "pid")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def test_stability_recorder_events_equal_jax():
    """One scripted skip sequence (skips under budget, a breach, two
    rollbacks, death) through both monitors: the same events and the same
    divergence bundle, timestamps aside."""

    def drive(mod, rec_cls):
        rec = rec_cls(proc="trainer")
        mon = mod.StabilityMonitor(mod.StabilityPolicy(skip_budget=2, max_rollbacks=2, rollback_lr_scale=0.5),
                                   base_seed=7, recorder=rec)
        out = []
        for step, skips in ((10, 0), (20, 1), (30, 5), (40, 3), (50, 2), (60, 4)):
            breached = mon.breached(skips)
            out.append(breached)
            if breached:
                try:
                    mon.check_escalation(step, skips)
                except mod.DivergenceError as e:
                    out.append(str(e))
                    break
                mon.record_rollback(step, step - 10, skips)
        return out, _strip(rec.events()), _strip(rec.bundles())

    got = drive(stability, FlightRecorder)
    want = drive(jax_stability, JaxFlightRecorder)
    assert got == want
    kinds = [e["kind"] for e in got[1]]
    assert kinds == ["nan_skip_window", "skip_budget_breach", "rollback", "skip_budget_breach", "rollback",
                     "nan_skip_window", "skip_budget_breach", "divergence_death"]
    assert got[2][0]["reason"] == "divergence" and len(got[2][0]["extra"]["attempts"]) == 2
