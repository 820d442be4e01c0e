"""The port's training slice against the JAX package: the sequence loss,
the one-cycle schedule, clip + AdamW, the train step (one and three steps,
BatchNorm statistics and Adam state included) at ``dense`` and at
``fused``, the skip guard, remat, the stability monitor, the checkpoint
manager and the Trainer as a whole.

Models: ``tests/test_train.py``'s ``tiny_cfg`` widths, small and large
(the large one has the BatchNorm context encoder), at 128x128 (the least
a 4-level pyramid takes), 2 updates, ``corr_impl='dense'``; one JAX
variable tree (shapes from ``jax.eval_shape``, values from a seeded numpy
generator, the flow head's last conv scaled by 0.05) loaded into both
packages (the fused step is held against the JAX dense step). The JAX
steps are jitted once a module.

Tolerances:
  * loss and EPE 1e-5 relative, ``grad_norm`` 1e-4 relative (the
    gradient is summed in another order), the 1/3/5 px shares 1e-4
    absolute (three of the batch's ~29500 valid pixels crossing a
    threshold);
  * Adam's ``mu``/``nu`` 5e-2 in relative L2 norm per parameter: some
    gradients (the encoders' early weights, BatchNorm biases) reach the
    parameters through long cancelling sums, and there the JAX package
    disagrees with itself by up to 1.0e-2 (2e-2 on a square, in ``nu``):
    the same gradient jitted and op by op, measured on these weights;
  * the parameters' updates 5e-2 in relative L2 norm over all parameters
    and 0.5 per parameter tensor: Adam's m/(sqrt(v)+eps) turns every
    gradient element into a step of about lr, so an element whose
    gradient is rounding-sized steps either way (measured: 0.021 overall,
    0.33 at worst in one tensor, on the first step). Biases of
    convolutions that feed a norm get no gradient but rounding residue:
    their update is held to ``lr`` a step;
  * BatchNorm running statistics 1e-5; counts exactly;
  * the schedule and the optimizer on given gradients 1e-6 relative (the
    same fp32 formulas; only the global norm is summed in another order),
    parameters and moments within 1e-8 absolute (about ten ulps of a
    value of 1e-2: the clip's norm, summed in another order, and XLA's
    fused arithmetic may round a step the other way);
  * the skip guard's state bitwise unchanged over a skipped step.
"""

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

# a card machine may lack the JAX package's dependencies (it has jax but no
# flax): these modules then skip as a whole
pytest.importorskip("raft_tpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from raft_tpu.models import build_raft as jax_build_raft  # noqa: E402
from raft_tpu.models.zoo import init_variables  # noqa: E402
from raft_tpu.train import TrainState as JaxTrainState  # noqa: E402
from raft_tpu.train import make_optimizer as jax_make_optimizer  # noqa: E402
from raft_tpu.train import one_cycle_lr as jax_one_cycle_lr  # noqa: E402
from raft_tpu.train import sequence_loss as jax_sequence_loss  # noqa: E402
from raft_tpu.train.stability import DivergenceError as JaxDivergenceError  # noqa: E402
from raft_tpu.train.stability import StabilityMonitor as JaxStabilityMonitor  # noqa: E402
from raft_tpu.train.stability import StabilityPolicy as JaxStabilityPolicy  # noqa: E402
from raft_tpu.train.step import make_train_step_fn as jax_make_train_step_fn  # noqa: E402
from tests.test_torch_model import _fill  # noqa: E402
from tests.test_train import tiny_cfg  # noqa: E402

import raft_tpu_torch as rt  # noqa: E402
from raft_tpu_torch.checkpoint import CheckpointManager, state_dict_from_flax  # noqa: E402
from raft_tpu_torch.kernels import lookup_xtap  # noqa: E402
from raft_tpu_torch.models.layers import ConvNormAct  # noqa: E402
from raft_tpu_torch.train import (  # noqa: E402
    DivergenceError,
    StabilityMonitor,
    StabilityPolicy,
    TrainConfig,
    Trainer,
    TrainState,
    make_optimizer,
    make_train_step_fn,
    one_cycle_lr,
    sequence_loss,
)
from raft_tpu_torch.utils.faults import CheckpointRestoreError  # noqa: E402

torch.set_num_threads(2)

UPDATES, B, HW = 2, 2, 128
LR, TOTAL = 1e-4, 100
LOSS_RTOL, NORM_RTOL, MOMENT_REL, STATS_TOL = 1e-5, 1e-4, 5e-2, 1e-5
UPDATE_REL, LEAF_UPDATE_REL, SHARE_TOL = 5e-2, 0.5, 1e-4


def _port_cfg(jcfg):
    """The port's RAFTConfig with the JAX config's shared fields."""
    fields = {f.name for f in dataclasses.fields(rt.RAFTConfig)}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name in fields}
    return rt.RAFTConfig(**kw).replace(corr_impl="dense", remat=False, remat_policy=None)


def _variables(jm, seed=0):
    variables = _fill(jax.eval_shape(lambda: init_variables(jm)), np.random.default_rng(seed))
    variables["params"]["update_block"]["flow_head"]["conv2"]["kernel"] *= 0.05
    return variables


def _batch(seed=1, b=B, hw=HW):
    rng = np.random.default_rng(seed)
    return {
        "image1": rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32),
        "image2": rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32),
        "flow": rng.uniform(-5, 5, (b, hw, hw, 2)).astype(np.float32),
        "valid": (rng.random((b, hw, hw)) > 0.1).astype(np.float32),
    }


def _port_batch(batch):
    return {k: torch.from_numpy(v).permute(0, 3, 1, 2).contiguous() if v.ndim == 4 else torch.from_numpy(v)
            for k, v in batch.items()}


class _Setup:
    """One architecture: the JAX model and weights, port models on demand,
    and the JAX steps, jitted once each."""

    def __init__(self, large):
        self.jcfg = tiny_cfg(large)
        self.jm = jax_build_raft(self.jcfg)
        self.variables = _variables(self.jm)
        self.state_dict = state_dict_from_flax(self.variables)
        self._steps = {}

    def port_model(self, **over):
        model = rt.build_raft(_port_cfg(self.jcfg).replace(**over), device="cpu")
        model.load_state_dict(self.state_dict, strict=True)
        return model

    def jax_tx(self):
        return jax_make_optimizer(jax_one_cycle_lr(LR, TOTAL), weight_decay=1e-4, clip_norm=1.0)

    def jax_step(self, **kw):
        key = tuple(sorted(kw.items()))
        if key not in self._steps:
            self._steps[key] = jax.jit(jax_make_train_step_fn(self.jm, self.jax_tx(), num_flow_updates=UPDATES, **kw))
        return self._steps[key]


_SETUPS = {}


def _setup(large):
    if large not in _SETUPS:
        _SETUPS[large] = _Setup(large)
    return _SETUPS[large]


@pytest.fixture(scope="module", params=[False, True], ids=["small", "large"])
def setup(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def small():
    return _setup(False)


# the skip guard armed, as the guard test needs it: with no fault it
# changes nothing (the JAX package's test_no_fault_identical_to_unguarded),
# and the step tests share its one jitted JAX step
GUARD = dict(numerics_policy="skip", spike_factor=1.5, spike_warmup=1)


def _port_tx():
    return make_optimizer(one_cycle_lr(LR, TOTAL), weight_decay=1e-4, clip_norm=1.0)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def _noise_biases(model):
    """Biases of convolutions that feed a norm: their true gradient is 0."""
    return {f"{n}.0.bias" for n, m in model.named_modules()
            if isinstance(m, ConvNormAct) and m.has_norm and m[0].bias is not None}


def _jax_params_sd(jstate):
    tree = {"params": jstate.params}
    if jstate.batch_stats is not None:
        tree["batch_stats"] = jstate.batch_stats
    return state_dict_from_flax(jax.device_get(tree))


def _assert_state_matches(jstate, pstate, initial, steps):
    """Parameters, BatchNorm statistics, Adam's count and moments."""
    model = pstate.model
    jsd, psd = _jax_params_sd(jstate), model.state_dict()
    noise = _noise_biases(model)
    du_j, du_p = [], []
    for k, want in jsd.items():
        if k.endswith("num_batches_tracked"):  # torch's counter; Flax keeps none
            continue
        got = psd[k].numpy()
        if "running" in k:
            np.testing.assert_allclose(got, want.numpy(), atol=STATS_TOL, rtol=0, err_msg=k)
        elif k in noise:
            assert np.abs(got - initial[k].numpy()).max() <= steps * LR * 1.001, k
        else:
            du_j.append((want.numpy() - initial[k].numpy()).ravel())
            du_p.append((got - initial[k].numpy()).ravel())
            assert _rel(du_p[-1], du_j[-1]) < LEAF_UPDATE_REL, (k, _rel(du_p[-1], du_j[-1]))
    assert _rel(np.concatenate(du_p), np.concatenate(du_j)) < UPDATE_REL
    adam = jstate.opt_state[1][0]
    assert int(adam.count) == int(pstate.opt_state["count"]) == steps
    names = [n for n, _ in model.named_parameters()]
    for key, tree in (("mu", adam.mu), ("nu", adam.nu)):
        want = state_dict_from_flax({"params": jax.device_get(tree)})
        for name, got in zip(names, pstate.opt_state[key]):
            if name not in noise:
                assert _rel(got.numpy(), want[name].numpy()) < MOMENT_REL, (key, name)


def _assert_metrics_match(jm, pm):
    for k in ("loss", "epe"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    for k in ("1px", "3px", "5px"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=0, atol=SHARE_TOL, err_msg=k)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_RTOL)


# -- loss, schedule, optimizer ------------------------------------------------


@pytest.mark.parametrize("valid_kind", ["none", "bool", "float"])
def test_sequence_loss_matches_jax(valid_kind):
    """Loss and final-prediction metrics, with masks and max_flow."""
    rng = np.random.default_rng(2)
    preds = rng.normal(0, 3, (3, 2, 12, 16, 2)).astype(np.float32)
    gt = rng.normal(0, 3, (2, 12, 16, 2)).astype(np.float32)
    gt[0, 0, :4] = 500.0  # beyond max_flow
    valid = {"none": None, "bool": rng.random((2, 12, 16)) > 0.3,
             "float": (rng.random((2, 12, 16)) > 0.3).astype(np.float32)}[valid_kind]
    jl, jmet = jax_sequence_loss(jnp.asarray(preds), jnp.asarray(gt), None if valid is None else jnp.asarray(valid),
                                 gamma=0.7, max_flow=400.0)
    pl, pmet = sequence_loss(torch.from_numpy(preds).permute(0, 1, 4, 2, 3), torch.from_numpy(gt).permute(0, 3, 1, 2),
                             None if valid is None else torch.from_numpy(valid), gamma=0.7, max_flow=400.0)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    assert set(pmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("pct_start", [0.01, 0.05, 0.5, 0.9])
def test_schedule_matches_optax(pct_start):
    """Every count of the schedule, the warm-up boundary and past the end."""
    total = 400
    jsched = jax_one_cycle_lr(2.5e-4, total, pct_start=pct_start)
    psched = one_cycle_lr(2.5e-4, total, pct_start=pct_start)
    counts = np.arange(0, total + 50, dtype=np.int32)
    want = np.asarray(jax.vmap(jsched)(jnp.asarray(counts)))
    got = psched(torch.from_numpy(counts)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    warmup = max(int(pct_start * total), 1)
    # fp32 arithmetic: the peak and the start within a few ulps
    assert float(psched(warmup)) == pytest.approx(2.5e-4, rel=1e-5)
    assert float(psched(0)) == pytest.approx(2.5e-4 / 25, rel=1e-5)


def test_optimizer_matches_optax():
    """Clip + AdamW over five updates of a random parameter list, the
    second one clipped, against optax on the same gradients (optax's
    update and apply jitted: one compile each, where op by op every
    primitive compiles on its own)."""
    rng = np.random.default_rng(3)
    shapes = [(4, 3, 3, 3), (4,), (7, 5), (1,)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    sched = lambda c: 1e-2 * (1.0 + 0.1 * c)  # noqa: E731
    jtx = jax_make_optimizer(sched, weight_decay=1e-2, clip_norm=1.0)
    jupdate, japply = jax.jit(jtx.update), jax.jit(optax.apply_updates)
    jparams = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jparams)
    ptx = make_optimizer(lambda c: 1e-2 * (1.0 + 0.1 * c.to(torch.float32)), weight_decay=1e-2, clip_norm=1.0)
    pparams = [torch.from_numpy(p.copy()) for p in params]
    pstate = ptx.init(pparams)
    for i, scale in enumerate([0.01, 5.0, 0.02, 0.05, 0.03]):
        grads = [(scale * rng.normal(0, 1, s)).astype(np.float32) for s in shapes]
        assert (float(optax.global_norm(grads)) >= 1.0) == (i == 1)
        updates, jstate = jupdate([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = japply(jparams, updates)
        pparams, pstate = ptx.update([torch.from_numpy(g) for g in grads], pstate, pparams)
        for got, want in zip(pparams, jparams):
            # atol: about ten ulps of an update of size lr (XLA fuses the
            # update's arithmetic and may round each step the other way)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-8)
    adam = jstate[1][0]
    assert int(pstate["count"]) == int(adam.count) == 5
    for key, want in (("mu", adam.mu), ("nu", adam.nu)):
        for got, w in zip(pstate[key], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6, atol=1e-8)


# -- the train step -----------------------------------------------------------


def test_train_step_matches_jax(setup):
    """One step, then two more, from the same weights and batch (the guard
    armed, no step skipped): loss, metrics and grad_norm every step;
    parameters, BatchNorm statistics and Adam's state after the first and
    the third."""
    batch = _batch()
    jstep = setup.jax_step(**GUARD)
    jstate = JaxTrainState.create(setup.variables, setup.jax_tx())
    model = setup.port_model()
    tx = _port_tx()
    pstate = TrainState.create(model, tx)
    pstep = make_train_step_fn(model, tx, num_flow_updates=UPDATES, **GUARD)
    pb = _port_batch(batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(3):
        jstate, jm = jstep(jstate, jb)
        pstate, pm = pstep(pstate, pb)
        assert set(pm) == set(jm) and float(pm["skipped"]) == float(jm["skipped"]) == 0.0
        _assert_metrics_match(jm, pm)
        if i in (0, 2):
            _assert_state_matches(jstate, pstate, setup.state_dict, i + 1)
    assert int(pstate.step) == int(jstate.step) == 3


def test_fused_train_step_matches_jax(small):
    """One step, then two more, at ``corr_impl='fused'`` (the skip guard
    armed, none skipped) against the module's jitted JAX dense step (the
    JAX package makes its fused step's gradient the dense one's by
    construction; its interpret-mode kernel inside a jitted step would
    take minutes to compile here), same weights and batch: metrics every
    step, parameters, BatchNorm statistics and Adam's state after the
    first and third (the step test's bounds); the fused model's bf16
    weight copy (kept per weight version) is remade after each optimizer
    update."""
    batch = _batch()
    jstep = small.jax_step(**GUARD)
    jstate = JaxTrainState.create(small.variables, small.jax_tx())
    model = small.port_model(corr_impl="fused")
    assert type(model.corr_block) is lookup_xtap.FusedLookupCorrBlock
    tx = _port_tx()
    pstate = TrainState.create(model, tx)
    pstep = make_train_step_fn(model, tx, num_flow_updates=UPDATES, **GUARD)
    weight = model.update_block.motion_encoder.convcorr1[0].weight
    pb, jb = _port_batch(batch), {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(3):
        copy = model.corr_block.weight_bf16(weight)
        assert model.corr_block.weight_bf16(weight) is copy
        jstate, jm = jstep(jstate, jb)
        pstate, pm = pstep(pstate, pb)
        assert float(pm["skipped"]) == float(jm["skipped"]) == 0.0
        _assert_metrics_match(jm, pm)
        if i in (0, 2):
            _assert_state_matches(jstate, pstate, small.state_dict, i + 1)
        fresh = model.corr_block.weight_bf16(weight)  # the update bumped the weight's version
        assert fresh is not copy and torch.equal(fresh, lookup_xtap.project_weight_bf16(weight))


def test_skip_guard_matches_jax(small):
    """A good step, a NaN batch, a finite gradient spike (both images
    scaled by 1e4: the gradient norm grows 1.9x here, past
    ``spike_factor=1.5``; batches of this kind vary it by 1%), a good step:
    the skipped steps leave params, Adam's count/mu/nu and the counters'
    state bitwise, the lr count lags ``step``; flags, counters and the
    EMA match JAX's."""
    kw = GUARD
    good = _batch()
    nan = dict(good, image1=np.full_like(good["image1"], np.nan))
    spike = dict(good, image1=good["image1"] * 1e4, image2=good["image2"] * 1e4)
    jstep = small.jax_step(**kw)
    jstate = JaxTrainState.create(small.variables, small.jax_tx())
    model = small.port_model()
    tx = _port_tx()
    pstate = TrainState.create(model, tx)
    pstep = make_train_step_fn(model, tx, num_flow_updates=UPDATES, **kw)
    flags = []
    for batch in (good, nan, spike, good):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt_before = {"count": pstate.opt_state["count"].clone(), "mu": [t.clone() for t in pstate.opt_state["mu"]],
                      "nu": [t.clone() for t in pstate.opt_state["nu"]]}
        ema_before = pstate.grad_ema.clone()
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, pm = pstep(pstate, _port_batch(batch))
        assert float(pm["skipped"]) == float(jm["skipped"])
        flags.append(float(pm["skipped"]))
        if float(pm["skipped"]):
            after = model.state_dict()
            assert all(torch.equal(before[k], after[k]) for k in before)
            assert torch.equal(opt_before["count"], pstate.opt_state["count"])
            assert all(torch.equal(a, b) for a, b in zip(opt_before["mu"] + opt_before["nu"],
                                                         pstate.opt_state["mu"] + pstate.opt_state["nu"]))
            assert torch.equal(ema_before, pstate.grad_ema)
        for k in ("skipped_steps", "good_steps", "step"):
            assert int(getattr(pstate, k)) == int(getattr(jstate, k)), k
        np.testing.assert_allclose(float(pstate.grad_ema), float(jstate.grad_ema), rtol=NORM_RTOL)
        # how far a NaN spreads through the backward depends on each
        # library's NaN handling (max, relu); whether one arises does not
        assert (float(pm["nonfinite_grads"]) > 0) == (float(jm["nonfinite_grads"]) > 0)
    assert flags == [0.0, 1.0, 1.0, 0.0]
    assert int(pstate.opt_state["count"]) == 2 and int(pstate.step) == 4
    _assert_state_matches(jstate, pstate, small.state_dict, 2)


def test_remat_gradients_equal_plain(small):
    """remat=True recomputes each refinement step in the backward: the
    same loss and gradients (1e-6 relative, the same ops recomputed)."""
    batch = _port_batch(_batch())
    grads = []
    for remat in (False, True):
        model = small.port_model(remat=remat).train()
        preds = model(batch["image1"], batch["image2"], num_flow_updates=UPDATES)
        loss, _ = sequence_loss(preds, batch["flow"], batch["valid"])
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9)


def test_unported_knobs_raise(small):
    """What does not train still raises: ``pallas`` (K3 defines no
    gradient, in either package), int8 pyramids, and the Trainer's
    profiler server (a deliberate difference: PyTorch has no profiler
    server); ``fused`` builds a step."""
    model = rt.build_raft(_port_cfg(small.jcfg).replace(corr_impl="pallas"), device="cpu")
    with pytest.raises(NotImplementedError, match="defines no gradient"):
        make_train_step_fn(model, _port_tx())
    model = rt.build_raft(_port_cfg(small.jcfg).replace(corr_impl="fused", corr_dtype="int8"), device="cpu")
    with pytest.raises(ValueError, match="inference-only"):
        make_train_step_fn(model, _port_tx())
    make_train_step_fn(small.port_model(corr_impl="fused"), _port_tx())
    with pytest.raises(ValueError, match="numerics_policy"):
        make_train_step_fn(small.port_model(), _port_tx(), numerics_policy="ignore")
    with pytest.raises(NotImplementedError, match="PyTorch has no profiler server"):
        Trainer(TrainConfig(device="cpu", profile_port=9999), dataset=None)
    with pytest.raises(NotImplementedError, match="defines no gradient"):
        Trainer(TrainConfig(device="cpu", corr_impl="pallas"), dataset=None)
    with pytest.raises(ValueError, match="inference-only"):
        Trainer(TrainConfig(device="cpu", corr_dtype="int8"), dataset=None)


# -- stability monitor ----------------------------------------------------------


def test_stability_monitor_matches_jax():
    """The same boundary calls give the same outcomes, seeds, scales and
    death message."""

    def drive(policy_cls, monitor_cls, error_cls):
        mon = monitor_cls(policy_cls(skip_budget=2, max_rollbacks=2, rollback_lr_scale=0.5), base_seed=7)
        trail = []
        for step, skips in [(10, 0), (20, 3), (30, 1), (40, 5), (50, 9)]:
            breached = mon.breached(skips)
            trail.append(("breached", step, breached))
            if breached:
                try:
                    mon.check_escalation(step, skips)
                except error_cls as e:
                    trail.append(("died", str(e), len(e.attempts)))
                    break
                seed, scale = mon.next_seed(), mon.next_lr_scale()
                attempt = mon.record_rollback(step, step - 10, skips, seed=seed, lr_scale=scale)
                trail.append(("rollback", attempt.describe()))
        return trail, mon.total_skipped

    assert drive(StabilityPolicy, StabilityMonitor, DivergenceError) == drive(
        JaxStabilityPolicy, JaxStabilityMonitor, JaxDivergenceError)
    with pytest.raises(ValueError):
        StabilityPolicy(rollback_lr_scale=0.0)


# -- checkpoints --------------------------------------------------------------


def _tiny_state(small, seed=None):
    model = small.port_model()
    state = TrainState.create(model, _port_tx())
    if seed is not None:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(float(seed))
            state.step.fill_(seed)
    return state


def test_checkpoint_manager(small, tmp_path):
    """Save on the interval, keep the newest 3, restore the latest into a
    fresh state bitwise, known-good tagging and rollback order, and a torn
    step quarantined on restore."""
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3, save_interval_steps=2)
    assert mgr.restore(_tiny_state(small)) is None
    for s in range(1, 11):
        saved = mgr.save(s, _tiny_state(small, s))
        assert saved == (s % 2 == 0)
    assert mgr.all_steps() == [6, 8, 10] and mgr.latest_step() == 10
    assert mgr.save(11, _tiny_state(small, 11), force=True)
    assert mgr.all_steps() == [8, 10, 11]
    state = mgr.restore(_tiny_state(small))
    ref = _tiny_state(small, 11).state_dict()
    got = state.state_dict()
    assert int(state.step) == 11
    assert all(torch.equal(got["model"][k], v) for k, v in ref["model"].items())
    mgr.tag_good(8, {"loss": 1.0})
    assert set(mgr.good_steps()) == {8}
    assert int(mgr.restore_known_good(_tiny_state(small), before=11).step) == 8
    # a torn newest step: quarantined, the walk falls back to step 10
    path = tmp_path / "11" / "state.pt"
    path.write_bytes(path.read_bytes()[:1000])
    assert int(mgr.restore(_tiny_state(small)).step) == 10
    assert mgr.all_steps() == [8, 10] and mgr.quarantined_steps == [11]
    assert (tmp_path / "quarantined" / "11").is_dir()
    # a state that does not fit (another architecture) fails validation
    other = TrainState.create(rt.build_raft(_port_cfg(tiny_cfg(True)), device="cpu"), _port_tx())
    with pytest.raises(CheckpointRestoreError):
        mgr.restore(other)


# -- the Trainer as a whole ---------------------------------------------------


def _write_chairs(root, n=6, hw=(136, 144), seed=5):
    """A FlyingChairs tree: PPM frames, .flo flows, a split file (the last
    pair in the validation split)."""
    from raft_tpu_torch.data.io import write_flo

    rng = np.random.default_rng(seed)
    os.makedirs(root / "data", exist_ok=True)
    h, w = hw
    for i in range(n):
        for k in (1, 2):
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            (root / "data" / f"{i:05d}_img{k}.ppm").write_bytes(f"P6\n{w} {h}\n255\n".encode() + img.tobytes())
        write_flo(str(root / "data" / f"{i:05d}_flow.flo"), rng.uniform(-4, 4, (h, w, 2)).astype(np.float32))
    np.savetxt(root / "FlyingChairs_train_val.txt", [1] * (n - 1) + [2], fmt="%d")
    return root


@pytest.fixture(scope="module")
def chairs(tmp_path_factory):
    return _write_chairs(tmp_path_factory.mktemp("chairs"))


def _train_config(**kw):
    return {**dict(arch="raft_small", stage="chairs", num_steps=3, global_batch_size=2, learning_rate=LR,
                   num_flow_updates=UPDATES, crop_size=(HW, HW), log_every=1, seed=3), **kw}


class _Stop(Exception):
    """Ends a Trainer's run from its log function."""


def _log_until(logs, last):
    def log(step, m):
        logs.append((step, m))
        if step == last:
            raise _Stop
    return log


def test_trainer_matches_jax_trainer(small, chairs, monkeypatch):
    """Both Trainers on one synthetic Chairs tree, one seed, one set of
    initial weights, the skip guard armed, stopped after 3 steps of a
    ``TOTAL``-step schedule: the logged losses (the augmentors' resize and
    HSV differ from OpenCV's by float rounding, so 1e-4 relative) and
    learning rates, and the parameters after step 3 (the step test's
    bounds). The JAX Trainer's optimizer and step are then the step
    tests' own, so it is handed their jitted step (its factory checks the
    model and the step's arguments) and compiles nothing more."""
    from raft_tpu.data import FlyingChairs as JaxFlyingChairs
    from raft_tpu.train import step as jax_step_module
    from raft_tpu.train import trainer as jax_trainer

    from raft_tpu_torch.data import FlyingChairs
    from raft_tpu_torch.train import trainer as port_trainer

    def make_train_step(model, tx, **kw):
        # the correlation block is a plain object: compared by its fields
        assert model.clone(corr_block=None) == small.jm.clone(corr_block=None)
        assert vars(model.corr_block) == vars(small.jm.corr_block)
        assert kw == dict(num_flow_updates=UPDATES, gamma=0.8, max_flow=400.0, check_numerics=False, **GUARD)
        return small.jax_step(**GUARD)

    monkeypatch.setattr(jax_step_module, "make_train_step", make_train_step)
    monkeypatch.setitem(jax_trainer.CONFIGS, "raft_small", small.jcfg)
    monkeypatch.setitem(port_trainer.CONFIGS, "raft_small", _port_cfg(small.jcfg))
    # the step tests' optimizer: one_cycle_lr(LR, TOTAL), weight decay 1e-4, clip 1
    config = _train_config(num_steps=TOTAL, weight_decay=1e-4, clip_norm=1.0, **GUARD)
    jlogs, plogs = [], []
    jt = jax_trainer.Trainer(jax_trainer.TrainConfig(**config, data_mesh=False), JaxFlyingChairs(str(chairs)),
                             init_from=small.variables)
    with pytest.raises(_Stop):
        jt.run(log_fn=_log_until(jlogs, 3))
    pt = port_trainer.Trainer(port_trainer.TrainConfig(**config, device="cpu"), FlyingChairs(str(chairs)),
                              init_from=small.state_dict)
    with pytest.raises(_Stop):
        pt.run(log_fn=_log_until(plogs, 3))
    assert [s for s, _ in plogs] == [s for s, _ in jlogs] == [1, 2, 3]
    for (_, pm), (_, jm) in zip(plogs, jlogs):
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-4)
        np.testing.assert_allclose(pm["lr"], jm["lr"], rtol=1e-6)
        assert pm["train/skipped"] == jm["train/skipped"] == 0.0
    _assert_state_matches(jt.state, pt.state, small.state_dict, 3)


def test_resume_equals_uninterrupted(small, chairs, monkeypatch, tmp_path):
    """A run preempted after step 2 (SIGTERM's flag, checkpoint at the
    boundary) and resumed by a second Trainer ends bitwise where an
    uninterrupted run ends: parameters, BatchNorm buffers, Adam state,
    counters, and the pipeline's batches."""
    from raft_tpu_torch.data import FlyingChairs
    from raft_tpu_torch.train import trainer as port_trainer

    monkeypatch.setitem(port_trainer.CONFIGS, "raft_small", _port_cfg(small.jcfg))
    ds = FlyingChairs(str(chairs))

    def config(d):
        return port_trainer.TrainConfig(**_train_config(device="cpu", checkpoint_dir=str(d), checkpoint_every=2),
                                        ).replace(num_steps=4)

    whole = Trainer(config(tmp_path / "whole"), ds, init_from=small.state_dict).run(log_fn=lambda s, m: None)
    first = Trainer(config(tmp_path / "split"), ds, init_from=small.state_dict)

    def preempt_at_two(step, m):
        if step == 2:
            handler = signal.getsignal(signal.SIGTERM)
            if "_install_preemption_handler" in getattr(handler, "__qualname__", ""):
                os.kill(os.getpid(), signal.SIGTERM)  # the trainer's handler only sets its flag
            else:  # not the main thread: no handler could be installed
                first._preempted = True

    first.run(log_fn=preempt_at_two)
    assert first.manager.all_steps() == [2]
    second = Trainer(config(tmp_path / "split"), ds, init_from=small.state_dict)
    assert int(second.state.step) == 2 and second.pipeline.step == 2
    resumed = second.run(log_fn=lambda s, m: None)
    a, b = whole.state_dict(), resumed.state_dict()
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    for key in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(a["opt_state"][key], b["opt_state"][key]))
    for key in ("step", "skipped_steps", "good_steps", "grad_ema"):
        assert torch.equal(a[key], b[key])
    assert torch.equal(a["opt_state"]["count"], b["opt_state"]["count"])


def test_in_loop_eval_exports_best_pt_and_logs_jsonl(small, chairs, monkeypatch, tmp_path):
    """``eval_every``: the best EPE's weights go to ``best.pt`` (a torch
    state_dict that ``checkpoint=`` reads; the JAX trainer writes
    ``best.msgpack``) with ``best.json``; the model is back in train mode
    after an eval that left it in eval mode, as ``validate`` does; scalars
    go to ``scalars.jsonl`` only (no TensorBoard files)."""
    import json

    from raft_tpu_torch.data import FlyingChairs
    from raft_tpu_torch.models.zoo import load_checkpoint
    from raft_tpu_torch.train import trainer as port_trainer

    monkeypatch.setitem(port_trainer.CONFIGS, "raft_small", _port_cfg(small.jcfg))
    epes = iter([2.0, 1.0, 3.0])
    snapshots = []

    def eval_fn(model):
        model.eval()
        snapshots.append({k: v.clone() for k, v in model.state_dict().items()})
        return {"epe": next(epes), "1px": 0.5}

    ckpt, logs = tmp_path / "ckpt", tmp_path / "logs"
    cfg = port_trainer.TrainConfig(**_train_config(device="cpu", checkpoint_dir=str(ckpt), checkpoint_every=10,
                                                   eval_every=1, log_dir=str(logs)))
    trainer = Trainer(cfg, FlyingChairs(str(chairs)), init_from=small.state_dict, eval_fn=eval_fn)
    trainer.run(log_fn=lambda s, m: None)
    assert trainer.model.training
    assert json.loads((ckpt / "best.json").read_text()) == {"step": 2, "epe": 1.0}
    best = load_checkpoint(str(ckpt / "best.pt"))
    assert all(torch.equal(best[k], v) for k, v in snapshots[1].items())
    assert sorted(os.listdir(logs)) == ["scalars.jsonl"]
    records = [json.loads(line) for line in (logs / "scalars.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 1, 2, 2, 3, 3]
    assert [r["eval/epe"] for r in records if "eval/epe" in r] == [2.0, 1.0, 3.0]
    assert all(isinstance(v, float) for r in records for k, v in r.items() if k != "step")
