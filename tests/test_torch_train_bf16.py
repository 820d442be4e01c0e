"""A train step at ``compute_dtype='bfloat16'`` with a bf16 correlation
pyramid, at ``corr_impl='dense'`` and ``'fused'``, against the JAX
package's step on the same weights and batch.

The reference is the JAX ``dense`` step (its fused step's gradient is the
dense one's by construction, and its interpret-mode kernel inside a
jitted step would take minutes to compile here), jitted as the JAX
package trains: XLA then keeps some bf16 values at fp32 (the sum of a
convolution's rounded product and its bias goes to the norm unrounded),
and the port's bf16 semantics follow that program (F3). Jitted with
excess precision off, XLA rounds there too and the JAX package's own
first gradient moves by 7.9e-2 in relative L2 (measured on these
weights; the port is 7.7e-2 from that program, 2.7e-2 from the package's).

Bounds: the loss within 1e-2 relative and the first step's gradient, read
as Adam's first moment after it (``(1 - b1)`` times the clipped gradient,
the same clip on both sides to within the global norm's rounding), within
5e-2 in relative L2 norm over all parameters. Most of the difference
lies in the feature encoder's first convolutions, whose gradients reach
them through instance norms' cancelling sums (at fp32 they are the
least accurate too, 1.5e-3 where the rest agree to 2e-4), where a bf16
rounding taken or not moves them by 20-60 %; the fused block's forward
also differs from the dense one's at bf16 levels (the kernel contracts y
first into bf16 rows, the JAX ``ydot_in_kernel`` form).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("raft_tpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raft_tpu.models import build_raft as jax_build_raft  # noqa: E402
from raft_tpu.train import TrainState as JaxTrainState  # noqa: E402
from raft_tpu.train.step import make_train_step_fn as jax_make_train_step_fn  # noqa: E402
from tests.test_torch_train import UPDATES, _batch, _port_batch, _port_tx, _setup  # noqa: E402

from raft_tpu_torch.checkpoint import state_dict_from_flax  # noqa: E402
from raft_tpu_torch.train import TrainState, make_train_step_fn  # noqa: E402

torch.set_num_threads(2)

BF16 = dict(compute_dtype="bfloat16", corr_dtype="bfloat16")
LOSS_REL, GRAD_REL = 1e-2, 5e-2


@pytest.fixture(scope="module")
def jax_bf16_step():
    """The JAX dense step at bf16 convs and pyramid, one step from the
    shared weights: its metrics and Adam's first moment by parameter
    name."""
    small = _setup(False)
    jm = jax_build_raft(small.jcfg.replace(**BF16))
    step = jax_make_train_step_fn(jm, small.jax_tx(), num_flow_updates=UPDATES)
    state = JaxTrainState.create(small.variables, small.jax_tx())
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    state, metrics = jax.jit(step)(state, batch)
    mu = state_dict_from_flax({"params": jax.device_get(state.opt_state[1][0].mu)})
    return {k: float(v) for k, v in metrics.items()}, mu


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("impl", ["dense", "fused"])
def test_bf16_train_step_matches_jax(jax_bf16_step, impl):
    jm, jmu = jax_bf16_step
    small = _setup(False)
    model = small.port_model(corr_impl=impl, **BF16)
    assert model.corr_block.dtype == torch.bfloat16
    tx = _port_tx()
    state = TrainState.create(model, tx)
    state, pm = make_train_step_fn(model, tx, num_flow_updates=UPDATES)(state, _port_batch(_batch()))
    names = [n for n, _ in model.named_parameters()]
    got = np.concatenate([m.detach().numpy().ravel() for m in state.opt_state["mu"]])
    want = np.concatenate([jmu[n].numpy().ravel() for n in names])
    loss_rel = abs(float(pm["loss"]) - jm["loss"]) / abs(jm["loss"])
    grad_rel = _rel(got.astype(np.float64), want.astype(np.float64))
    print(f"{impl}: loss {loss_rel:.3e} relative, first gradient {grad_rel:.3e} relative L2")
    assert loss_rel <= LOSS_REL and grad_rel <= GRAD_REL, (loss_rel, grad_rel)
    assert np.isfinite(float(pm["grad_norm"]))
