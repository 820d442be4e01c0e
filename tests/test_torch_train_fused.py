"""Training through the kernels on the CPU: the fused block's gradients
(``lookup_fused_diff`` / ``project_fused_diff``) against the dense
block's and the JAX package's, and the selective remat policies.

On the CPU the wrappers' forward is the kernels' plain version; their
backward is autograd of the dense block's formulation there as on the card,
so its gradients must be the dense block's bit for bit.

Tolerances:
  * fused against dense block, same dtypes: bitwise (the same ops, the
    loss linear in the output so the incoming gradient is the same);
  * port against ``jax.grad`` through the JAX ``FusedLookupCorrBlock``
    (its kernel in interpret mode, its backward the XLA formulation's
    VJP; jitted with XLA's excess precision off, which gives its op-by-op
    result bit for bit, where with it on its own gradients move by up to
    9e-2 at bf16 levels), per tensor in relative L2 norm: 1e-5 (measured
    at most 3e-7 at either level dtype), except the centroids' gradient
    at bf16 levels, 1e-2 (measured 2.3e-3): JAX's VJP of the bf16
    x-contraction's broadcast product sums its S terms in bf16, one
    rounding an add (the transpose of a broadcast), where PyTorch sums
    them in fp32 and rounds once. The model never asks for that gradient
    (the centroids are detached). The JAX fused block's ``index_pyramid``
    cannot be differentiated at bf16 levels (its kernel returns bf16 taps,
    its backward's formulation fp32 ones, and ``custom_vjp`` refuses the
    cotangent), so there the port is held against the JAX dense block, the
    formulation that backward differentiates;
  * the remat policies: ``test_remat_gradients_equal_plain``'s 1e-6.

A train step at ``fused`` is held against the JAX package's step in
``tests/test_torch_train.py`` (``test_fused_train_step_matches_jax``),
which compiles that step once for its module.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("raft_tpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raft_tpu.kernels.lookup_xtap import FusedLookupCorrBlock as JaxFusedLookupCorrBlock  # noqa: E402
from raft_tpu.models.corr import CorrBlock as JaxCorrBlock  # noqa: E402
from raft_tpu.models.zoo import init_variables  # noqa: E402
from tests.test_torch_train import (  # noqa: E402
    UPDATES,
    _batch,
    _port_batch,
    _setup,
)

import raft_tpu_torch as rt  # noqa: E402
from raft_tpu_torch.kernels import lookup_xtap  # noqa: E402
from raft_tpu_torch.models.corr import CorrBlock  # noqa: E402
from raft_tpu_torch.train import sequence_loss  # noqa: E402

torch.set_num_threads(2)

LEVELS, RADIUS, C_OUT = 3, 3, 12
GRAD_REL, BF16_CENTROID_REL = 1e-5, 1e-2
DTYPES = {"fp32": (None, None), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _block_inputs(seed=0, b=1, h=8, w=16, c=8):
    """Feature maps NHWC, centroids, the projection's JAX kernel and bias,
    and the loss's fixed cotangent, from one seed."""
    rng = np.random.default_rng(seed)
    c_in = LEVELS * (2 * RADIUS + 1) ** 2
    return {
        "f1": rng.normal(size=(b, h, w, c)).astype(np.float32),
        "f2": rng.normal(size=(b, h, w, c)).astype(np.float32),
        "cents": rng.uniform(-3, w + 3, (b, h, w, 2)).astype(np.float32),
        "kernel": (0.1 * rng.normal(size=(1, 1, c_in, C_OUT))).astype(np.float32),
        "bias": (0.1 * rng.normal(size=(C_OUT,))).astype(np.float32),
        "cot": rng.normal(size=(b, h, w, C_OUT)).astype(np.float32),
        "cot_taps": rng.normal(size=(b, h, w, c_in)).astype(np.float32),
    }


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _port_weight(kernel):
    return _t(kernel.transpose(3, 2, 0, 1))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jit_exact(fn, *args):
    """``fn`` jitted for ``args`` with XLA's excess precision off: every
    bf16 value rounded where the program says, as op by op."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})


def _loss(out, cot, project):
    """A loss linear in the block's output: its gradient is ``cot``
    whatever the forward computed (the fused and dense forwards may differ
    by rounding at bf16 levels)."""
    if project:  # NCHW out, NHWC cotangent
        out = out.permute(0, 2, 3, 1)
    return (out.float() * cot).sum()


@pytest.mark.parametrize("proj", ["fp32", "bf16", "taps"])
@pytest.mark.parametrize("levels", ["fp32", "bf16"])
def test_fused_grads_are_dense_grads_bitwise(levels, proj):
    """One ``index_project`` (or, ``taps``, ``index_pyramid``) call: the
    gradients reaching every level, the centroids, the weight and the bias
    through the fused block are the dense block's bit for bit."""
    x = _block_inputs()
    dtype = DTYPES[levels][0]
    proj_dtype = None if proj == "taps" else DTYPES[proj][0]
    with torch.no_grad():
        pyramid = CorrBlock(LEVELS, RADIUS, dtype).build_pyramid(_t(x["f1"]).permute(0, 3, 1, 2),
                                                                  _t(x["f2"]).permute(0, 3, 1, 2))
    grads = []
    for block in (CorrBlock(LEVELS, RADIUS, dtype), lookup_xtap.FusedLookupCorrBlock(LEVELS, RADIUS, dtype)):
        leaves = [lvl.detach().clone().requires_grad_() for lvl in pyramid]
        cents = _t(x["cents"]).requires_grad_()
        weight, bias = _port_weight(x["kernel"]).requires_grad_(), _t(x["bias"]).requires_grad_()
        if proj == "taps":
            out, cot, wrt = block.index_pyramid(leaves, cents), _t(x["cot_taps"]), leaves + [cents]
        else:
            out = block.index_project(leaves, cents, weight, bias, dtype=proj_dtype)
            cot, wrt = _t(x["cot"]), leaves + [cents, weight, bias]
        grads.append(torch.autograd.grad(_loss(out, cot, proj != "taps"), wrt))
    for i, (got, want) in enumerate(zip(grads[1], grads[0])):
        assert got.dtype == want.dtype and torch.equal(got, want), i


@pytest.mark.parametrize("proj", ["project", "taps"])
@pytest.mark.parametrize("levels", ["fp32", "bf16"])
def test_fused_grads_match_jax(levels, proj):
    """``jax.grad`` through the JAX fused block (interpret mode) against
    the port's: the feature maps', the centroids' and (``project``) the
    kernel's and bias's gradients, through the pyramid build."""
    x = _block_inputs(1)
    pdt, jdt = DTYPES[levels]
    project = proj == "project"
    if levels == "bf16" and not project:
        jblock = JaxCorrBlock(LEVELS, RADIUS, dtype=jdt)
    else:
        jblock = JaxFusedLookupCorrBlock(LEVELS, RADIUS, dtype=jdt, interpret=True)
        assert isinstance(jblock.build_pyramid(jnp.asarray(x["f1"]), jnp.asarray(x["f2"])), dict), "must fuse"

    def jloss(f1, f2, cents, kernel, bias):
        pyr = jblock.build_pyramid(f1, f2)
        if project:
            return jnp.sum(jblock.index_project(pyr, cents, kernel, bias).astype(jnp.float32) * x["cot"])
        return jnp.sum(jblock.index_pyramid(pyr, cents).astype(jnp.float32) * x["cot_taps"])

    args = [jnp.asarray(x[k]) for k in ("f1", "f2", "cents", "kernel", "bias")]
    want = _jit_exact(jax.grad(jloss, argnums=(0, 1, 2, 3, 4) if project else (0, 1, 2)), *args)(*args)

    block = lookup_xtap.FusedLookupCorrBlock(LEVELS, RADIUS, pdt)
    f1, f2, cents = (_t(x[k]).requires_grad_() for k in ("f1", "f2", "cents"))
    weight, bias = _port_weight(x["kernel"]).requires_grad_(), _t(x["bias"]).requires_grad_()
    pyr = block.build_pyramid(f1.permute(0, 3, 1, 2), f2.permute(0, 3, 1, 2))
    if project:
        loss = _loss(block.index_project(pyr, cents, weight, bias), _t(x["cot"]), True)
        got = torch.autograd.grad(loss, [f1, f2, cents, weight, bias])
        got = [g.numpy() for g in got[:3]] + [got[3].numpy().transpose(2, 3, 1, 0), got[4].numpy()]
    else:
        loss = _loss(block.index_pyramid(pyr, cents), _t(x["cot_taps"]), False)
        got = [g.numpy() for g in torch.autograd.grad(loss, [f1, f2, cents])]
    for i, (g, w) in enumerate(zip(got, want)):
        bound = BF16_CENTROID_REL if (levels == "bf16" and i == 2) else GRAD_REL
        assert _rel(g, np.asarray(w)) < bound, (i, _rel(g, np.asarray(w)))


# -- the selective remat policies ---------------------------------------------


@pytest.mark.parametrize("impl", ["dense", "fused"])
def test_remat_policies_equal_plain(impl, monkeypatch):
    """Each policy's loss and gradients equal ``remat=False``'s (tiny
    raft_large-style model, the BatchNorm context encoder in train mode,
    2 updates), and each saves what it names: with 'dots' the backward
    recomputes no convolution, with 'dots_no_batch' and no policy it
    recomputes every step's; with 'corr' the fused block's lookup +
    projection runs once a step (twice under plain remat)."""
    large = _setup(True)
    batch = _port_batch(_batch())
    calls = {"project": 0}
    real = lookup_xtap.lookup_project_reference

    def counted(*a, **k):
        calls["project"] += 1
        return real(*a, **k)

    monkeypatch.setattr(lookup_xtap, "lookup_project_reference", counted)
    results = {}
    for policy in (False, None, "dots", "dots_no_batch", "corr"):
        calls["project"] = 0
        model = large.port_model(corr_impl=impl, remat=policy is not False,
                                 remat_policy=policy or None).train()
        preds = model(batch["image1"], batch["image2"], num_flow_updates=UPDATES)
        loss, _ = sequence_loss(preds, batch["flow"], batch["valid"])
        with _ConvCounter() as convs:
            grads = torch.autograd.grad(loss, list(model.parameters()))
        results[policy] = (loss.detach(), grads, convs.forward, calls["project"])
    plain_loss, plain_grads, plain_convs, _ = results[False]
    assert plain_convs == 0
    for policy, (loss, grads, convs, projects) in results.items():
        assert torch.equal(loss, plain_loss), policy
        for a, b in zip(grads, plain_grads):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    assert results["dots"][2] == 0
    assert results[None][2] == results["dots_no_batch"][2] == results["corr"][2] > 0
    if impl == "fused":
        assert (results[False][3], results[None][3], results["corr"][3]) == (UPDATES, 2 * UPDATES, UPDATES)


class _ConvCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the forward convolutions run inside the block (those a
    backward pass runs are recomputations)."""

    def __init__(self):
        super().__init__()
        self.forward = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.forward += 1
        return func(*args, **(kwargs or {}))


def test_remat_policy_errors_are_jax():
    """An unknown policy and a policy without remat raise the JAX
    package's errors (at the port's model build; in JAX at its trace)."""
    from raft_tpu.models import build_raft as jax_build_raft

    small = _setup(False)
    for over in (dict(remat=True, remat_policy="everything"), dict(remat=False, remat_policy="dots")):
        with pytest.raises(ValueError) as jerr:
            jax.eval_shape(lambda: init_variables(jax_build_raft(small.jcfg.replace(**over))))
        with pytest.raises(ValueError) as perr:
            small.port_model(**over)
        assert str(perr.value) == str(jerr.value)
    assert set(rt.models.REMAT_POLICIES) == {"dots", "dots_no_batch", "corr"}
