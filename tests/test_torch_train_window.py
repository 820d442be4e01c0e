"""The window step (``train.step.make_window_step``), stacked batch windows
(``data.pipeline``) and the Trainer's window loop, against the port's own
per-step loop on the CPU: a window of ``k`` steps must be ``k`` per-step
calls bit for bit (the JAX package's ``make_window_step_fn`` scans the
same per-step body; its own window tests fail today, so the yardstick is
the per-step function, as ROADMAP queue 3 says).

Model: ``tests/test_train.py``'s tiny raft_small widths at 128x128, 2
updates, seeded random weights, the flow head's last conv scaled by 0.05.
This module imports no JAX.
"""

import os

import numpy as np
import pytest
import torch

import raft_tpu_torch as rt
from raft_tpu_torch.data import FlyingChairs
from raft_tpu_torch.data.pipeline import TrainPipeline
from raft_tpu_torch.train import (
    TrainConfig,
    Trainer,
    TrainState,
    make_optimizer,
    make_train_step_fn,
    make_window_step,
    one_cycle_lr,
)
from raft_tpu_torch.train import trainer as port_trainer

torch.set_num_threads(2)

TINY = dict(feature_encoder_widths=(8, 8, 12, 16, 24), context_encoder_widths=(8, 8, 12, 16, 40),
            motion_corr_widths=(16,), motion_flow_widths=(16, 8), motion_out_channels=20, gru_hidden=24,
            flow_head_hidden=16)
UPDATES, HW = 2, 128
GUARD = dict(numerics_policy="skip", spike_factor=1.5, spike_warmup=1, check_numerics=True)


def _model(corr_impl="dense"):
    model = rt.build_raft(rt.RAFT_SMALL.replace(**TINY, corr_impl=corr_impl), device="cpu", seed=3)
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.05)
    return model


def _tx():
    return make_optimizer(one_cycle_lr(1e-4, 100), weight_decay=1e-4, clip_norm=1.0)


def _batches(k, b=2, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        arr = {"image1": rng.uniform(-1, 1, (b, 3, HW, HW)), "image2": rng.uniform(-1, 1, (b, 3, HW, HW)),
               "flow": rng.uniform(-5, 5, (b, 2, HW, HW)), "valid": (rng.random((b, HW, HW)) > 0.1)}
        out.append({key: torch.tensor(v, dtype=torch.float32) for key, v in arr.items()})
    return out


def _state_tensors(state):
    sd = state.state_dict()
    return ([sd["model"][k] for k in sorted(sd["model"])] + sd["opt_state"]["mu"] + sd["opt_state"]["nu"]
            + [sd["opt_state"]["count"]] + [sd[k] for k in ("step", "skipped_steps", "good_steps", "grad_ema")])


def _bitwise(a, b):
    """Bit for bit, NaN where NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
    return torch.equal(a, b)


@pytest.mark.parametrize("corr_impl", ["dense", "fused"])
def test_window_step_is_the_per_step_loop(corr_impl):
    """A k=3 window against three per-step calls from the same weights, the
    skip guard armed and the middle batch poisoned (NaN image): the state
    (parameters, BatchNorm buffers, Adam, counters, EMA) and every step's
    metrics bit for bit, the poisoned step skipped in both."""
    batches = _batches(3)
    batches[1]["image1"][0, :, :8] = float("nan")
    per_model, win_model = _model(corr_impl), _model(corr_impl)
    tx = _tx()
    per_state, win_state = TrainState.create(per_model, tx), TrainState.create(win_model, tx)
    step = make_train_step_fn(per_model, tx, num_flow_updates=UPDATES, **GUARD)
    per_metrics = []
    for b in batches:
        per_state, m = step(per_state, b)
        per_metrics.append(m)
    window = {key: torch.stack([b[key] for b in batches]) for key in batches[0]}
    win_state, win_metrics = make_window_step(win_model, tx, window_size=3, num_flow_updates=UPDATES,
                                              **GUARD)(win_state, window)
    assert [float(m["skipped"]) for m in per_metrics] == win_metrics["skipped"].tolist() == [0.0, 1.0, 0.0]
    assert int(win_state.skipped_steps) == 1 and int(win_state.good_steps) == 2 and int(win_state.step) == 3
    assert all(_bitwise(a, b) for a, b in zip(_state_tensors(per_state), _state_tensors(win_state)))
    assert set(win_metrics) == set(per_metrics[0])
    for key, stacked in win_metrics.items():
        assert stacked.shape[0] == 3
        for i, m in enumerate(per_metrics):
            assert _bitwise(stacked[i], m[key]), (key, i)
    with pytest.raises(ValueError, match="window_size"):
        make_window_step(win_model, tx, window_size=2)(win_state, window)


# -- the pipeline and the Trainer -----------------------------------------------


def _write_chairs(root, n=6, hw=(136, 144), seed=5):
    """A FlyingChairs tree: PPM frames, .flo flows, every pair in the
    training split."""
    from raft_tpu_torch.data.io import write_flo

    rng = np.random.default_rng(seed)
    os.makedirs(root / "data", exist_ok=True)
    h, w = hw
    for i in range(n):
        for k in (1, 2):
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            (root / "data" / f"{i:05d}_img{k}.ppm").write_bytes(f"P6\n{w} {h}\n255\n".encode() + img.tobytes())
        write_flo(str(root / "data" / f"{i:05d}_flow.flo"), rng.uniform(-4, 4, (h, w, 2)).astype(np.float32))
    np.savetxt(root / "FlyingChairs_train_val.txt", [1] * n, fmt="%d")
    return root


@pytest.fixture(scope="module")
def chairs(tmp_path_factory):
    return FlyingChairs(str(_write_chairs(tmp_path_factory.mktemp("chairs"))))


def test_pipeline_windows_are_the_per_step_batches(chairs):
    """Windows of 3 are the per-step pipeline's batches, stacked in order,
    bit for bit, NCHW with a leading window axis; ``step`` counts batches;
    a pipeline resumed at step 3 continues with the second window."""
    from raft_tpu_torch.data.augment import AugmentConfig, FlowAugmentor

    aug = FlowAugmentor(AugmentConfig(crop_size=(HW, HW)))
    per = TrainPipeline(chairs, 2, augmentor=aug, seed=4, device="cpu")
    it = iter(per)
    steps = [next(it) for _ in range(6)]
    it.close()
    win = TrainPipeline(chairs, 2, augmentor=aug, seed=4, device="cpu", window_size=3)
    it = iter(win)
    windows = [next(it) for _ in range(2)]
    it.close()
    assert win.step >= 6 and win.step % 3 == 0
    assert windows[0]["image1"].shape == (3, 2, 3, HW, HW) and windows[0]["valid"].shape == (3, 2, HW, HW)
    for w, window in enumerate(windows):
        for i in range(3):
            for key, value in steps[3 * w + i].items():
                assert torch.equal(window[key][i], value), (w, i, key)
    it = iter(TrainPipeline(chairs, 2, augmentor=aug, seed=4, device="cpu", window_size=3, start_step=3))
    resumed = next(it)
    it.close()
    assert all(torch.equal(resumed[key], windows[1][key]) for key in resumed)
    with pytest.raises(ValueError, match="window_size"):
        TrainPipeline(chairs, 2, device="cpu", window_size=0)


class _Copy:
    """A recorded host-to-device copy, finished or still running."""

    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done

    def synchronize(self):
        raise AssertionError("window staging waited on the card")


def test_window_staging_never_waits_on_a_copy():
    """A ring slot whose last copy still runs gets a fresh buffer instead
    of a wait (a wait there is a host sync of the window loop); a slot
    whose copy has finished is rewritten in place."""
    from raft_tpu_torch.data.pipeline import _WindowStaging

    staging = _WindowStaging(2, torch.device("cpu"))
    window = [{"a": np.full((2, 3), j, np.float32), "b": np.full((4,), 10 + j, np.float32)} for j in range(2)]
    first = [staging.stack(window)[0] for _ in range(2)]
    ring = next(iter(staging._rings.values()))
    ring[0][1], ring[1][1] = _Copy(False), _Copy(True)
    fresh, layout, slot, _ = staging.stack(window)
    kept = staging.stack(window)[0]
    assert slot == 0 and fresh is not first[0] and ring[0][0] is fresh and kept is first[1] and staging.fresh == 1
    expected = np.concatenate([np.stack([w[key] for w in window]).ravel() for key, _, _ in layout])
    np.testing.assert_array_equal(fresh.numpy(), expected)
    np.testing.assert_array_equal(kept.numpy(), expected)


def _config(tmp, **kw):
    base = dict(arch="raft_small", stage="chairs", num_steps=4, global_batch_size=2, learning_rate=1e-4,
                num_flow_updates=UPDATES, crop_size=(HW, HW), log_every=2, seed=3, device="cpu",
                checkpoint_dir=None if tmp is None else str(tmp), checkpoint_every=2)
    return TrainConfig(**{**base, **kw})


@pytest.fixture
def tiny_arch(monkeypatch):
    monkeypatch.setitem(port_trainer.CONFIGS, "raft_small", rt.RAFT_SMALL.replace(**TINY))


def test_trainer_window_run_is_the_per_step_run(chairs, tiny_arch, tmp_path):
    """``window_size=2`` against ``window_size=1``, 4 steps from the same
    weights: the logged metrics at each boundary (their means over the
    steps since the last; ``lr`` is the schedule at the window's first
    step, as in the JAX Trainer) and the final state bit for bit; the window run's device-time ledger timed every window
    dispatch (``ledger_sample_every=1``, family
    ``train_window_step/2``)."""
    init = _model().state_dict()
    runs = {}
    for k in (1, 2):
        logs = []
        trainer = Trainer(_config(tmp_path / f"k{k}", window_size=k, ledger_sample_every=1 if k == 2 else 0),
                          chairs, init_from=init)
        state = trainer.run(log_fn=lambda s, m: logs.append((s, m)))
        runs[k] = (logs, state, trainer)
    (logs1, state1, _), (logs2, state2, trainer2) = runs[1], runs[2]
    assert [s for s, _ in logs1] == [s for s, _ in logs2] == [2, 4]
    for (_, a), (_, b) in zip(logs1, logs2):
        for key in ("loss", "epe", "grad_norm", "1px"):
            assert a[key] == b[key], key
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(state1), _state_tensors(state2)))
    family = trainer2.ledger.breakdown()["by_family"]["train_window_step/2"]
    assert family["executions"] == family["sampled"] == 2 and family["est_total_ms"] > 0


def test_window_alignment_and_misaligned_resume(chairs, tiny_arch, tmp_path):
    """Every boundary interval and ``num_steps`` must be a multiple of the
    window (the JAX Trainer's checks and messages); a run checkpointed at
    step 3 does not resume under ``window_size=2``."""
    for kw, name in [(dict(log_every=3), "log_every"), (dict(num_steps=5), "num_steps"),
                     (dict(checkpoint_every=3), "checkpoint_every"), (dict(eval_every=3), "eval_every")]:
        with pytest.raises(ValueError, match=f"{name}=[0-9]+ is not a multiple of window_size=2"):
            Trainer(_config(tmp_path / "a", window_size=2, **kw), chairs, eval_fn=lambda m: {})
    # without a checkpoint directory the checkpoint interval is not a boundary
    Trainer(_config(None, window_size=2, checkpoint_every=3, num_steps=2), chairs)
    Trainer(_config(tmp_path / "b", num_steps=3, log_every=1, checkpoint_every=3), chairs).run(
        log_fn=lambda s, m: None)
    resumed = Trainer(_config(tmp_path / "b", window_size=2, num_steps=6), chairs)
    assert int(resumed.state.step) == 3
    with pytest.raises(ValueError, match="resumed at step 3, which is not a multiple of window_size=2"):
        resumed.run(log_fn=lambda s, m: None)


def test_rollback_reenters_at_a_window_start(chairs, tiny_arch, tmp_path):
    """Windows of 2 with the skip guard and no skip budget: the second
    window's last step is poisoned (NaN image) and skipped, the boundary
    at step 4 breaches the budget, the run rolls back to the known-good
    checkpoint at step 2 (a window start) and trains on to step 8 with the
    pipeline restarted there."""
    cfg = _config(tmp_path, window_size=2, num_steps=8, numerics_policy="skip", spike_factor=0.0, skip_budget=0)
    trainer = Trainer(cfg, chairs, init_from=_model().state_dict())
    window_fn, calls = trainer.window_fn, []

    def poisoned(state, window):
        calls.append(int(state.step))
        if len(calls) == 2:
            window = dict(window, image1=window["image1"].clone())
            window["image1"][1, 0, :, :8] = float("nan")
        return window_fn(state, window)

    trainer.window_fn = poisoned
    logs = []
    state = trainer.run(log_fn=lambda s, m: logs.append((s, m)))
    assert calls == [0, 2, 2, 4, 6]
    assert [s for s, m in logs if "loss" in m] == [2, 4, 4, 6, 8]
    assert [m["stability/rollback_to"] for s, m in logs if "stability/rollback_to" in m] == [2.0]
    assert len(trainer.stability.rollbacks) == 1 and int(state.step) == 8
    assert trainer.pipeline.seed != cfg.seed and int(state.skipped_steps) == 0


class _HostEvent:
    """``torch.cuda.Event`` on the host clock, for the bench on the CPU."""

    def __init__(self, enable_timing=False):
        self.t = 0.0

    def record(self, stream=None):
        import time

        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_bench_train_takes_the_jax_knobs(capsys, monkeypatch, tiny_arch):
    """``bench --train`` with ``--corr fused --corr-dtype bfloat16 --dtype
    bfloat16 --remat-policy corr`` on the CPU, its shape shrunk and the
    card's calls stood in for: the metric names and the JAX labels (the
    config string, the policy in the protocol), the info line's K1
    launches a step; int8 refused as in the JAX bench."""
    import functools
    import json

    from raft_tpu_torch import bench

    monkeypatch.setattr(bench, "bench_train", functools.partial(bench.bench_train, batch=1, crop=(HW, HW),
                                                                iters=UPDATES))
    monkeypatch.setattr(bench, "resolve_device", lambda: torch.device("cpu"))
    monkeypatch.setattr(bench, "card_line", lambda: "host, no card")
    for name, fake in [("Event", _HostEvent), ("synchronize", lambda dev=None: None),
                       ("reset_peak_memory_stats", lambda dev=None: None),
                       ("max_memory_allocated", lambda dev=None: 0), ("get_device_name", lambda dev=None: "cpu")]:
        monkeypatch.setattr(torch.cuda, name, fake)
    assert bench.main(["--train", "--models", "raft_small", "--steps", "1", "--corr", "fused", "--corr-dtype",
                       "bfloat16", "--dtype", "bfloat16", "--remat-policy", "corr"]) == 0
    info, line = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert line["metric"] == "raft_small_train_pairs_s" and line["value"] > 0
    assert line["config"] == "corr_impl=fused, corr_dtype=bf16, compute_dtype=bf16, batch=6, tf32=off"
    assert line["protocol"].endswith(", remat, eager, remat_policy=corr")
    assert info["k1_launches_per_step"] == {"raft_small_train_pairs_s": 0.0}  # the CPU path launches nothing
    with pytest.raises(ValueError, match="inference-only"):
        bench.bench_train("raft_small", corr="fused", corr_dtype="int8", device="cpu")
