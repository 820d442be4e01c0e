"""The RAFT orchestrator: encode, correlate, iteratively refine (NCHW).

Structure, as in the JAX package's ``models/raft.py``:
  1. Feature-encode both frames in one batch-stacked pass.
  2. Build the correlation pyramid once.
  3. Context-encode frame 1; split into the GRU hidden-state init (tanh)
     and context features (relu).
  4. Refine iteratively: a Python loop over the same step body.

``emit_all=False`` runs the recurrence carry-only and upsamples once at the
end. The surface is split into ``encode_frame`` (per-frame encode, the
stream-cache unit) and ``iterate`` (pyramid + loop + upsample), and further
into ``begin_pair`` / ``begin_refinement`` / ``iterate_step`` /
``finalize_flow`` for iteration-level callers; N ``iterate_step`` calls
reproduce an N-step ``iterate``.

Images are ``(B, 3, H, W)`` in [-1, 1] with H and W divisible by 8; flows
are ``(B, 2, H, W)`` with channel 0 = x. Every entry point runs under
:func:`~raft_tpu_torch.device.fp32_precision`: fp32 convolutions and
matmuls are IEEE fp32 whatever the caller's global TF32 flags say.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from raft_tpu_torch.device import fp32_precision
from raft_tpu_torch.models.corr import LazyCorrFeatures, map_levels
from raft_tpu_torch.ops.sampling import coords_grid
from raft_tpu_torch.ops.upsample import upsample_flow

__all__ = ["RAFT", "REMAT_POLICIES"]

_aten = torch.ops.aten
# the aten ops a matmul or a convolution reaches under autograd: JAX's
# dot_general without batch dimensions, with them, and conv_general_dilated
_MATMULS_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})
_MATMULS = _MATMULS_NO_BATCH | {_aten.bmm.default, _aten.baddbmm.default}
_CONVS = frozenset({_aten.convolution.default})


def _saving(ops):
    """A selective-checkpoint policy that keeps the outputs of ``ops`` and
    recomputes everything else."""

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


# The JAX package's selective-remat policies (``raft_tpu/models/raft.py``),
# each the set of aten ops whose outputs a checkpointed refinement step
# keeps: 'dots' is jax.checkpoint_policies.checkpoint_dots (dot_general and
# conv_general_dilated), 'dots_no_batch' dots_with_no_batch_dims_saveable
# (matmuls without batch dimensions). 'corr' keeps exactly the
# correlation features, convcorr1's output (the JAX ``checkpoint_name(c,
# "corr_features")`` anchor): no op names it here, as K1 launches outside
# PyTorch's dispatcher, so RAFT computes it before the checkpointed region
# and passes it in (``_corr_features``); its value is ``None``.
REMAT_POLICIES = {
    "dots": _saving(_MATMULS | _CONVS),
    "dots_no_batch": _saving(_MATMULS_NO_BATCH),
    "corr": None,
}


class RAFT(nn.Module):
    """RAFT optical-flow estimator (Teed & Deng, arXiv:2003.12039).

    ``corr_block`` is parameter-free and exposes ``build_pyramid`` /
    ``index_pyramid`` / ``index_project`` / ``out_channels``;
    ``mask_predictor`` (optional) outputs 8*8*9 channels.

    ``remat=True`` recomputes each refinement step (with its upsample when
    every iteration is emitted) in the backward pass instead of keeping
    its activations, through ``torch.utils.checkpoint`` (the JAX
    package's ``nn.remat`` of the scanned step); it changes nothing
    without gradients. ``remat_policy`` (a key of :data:`REMAT_POLICIES`)
    makes it selective: ``'dots'`` keeps every convolution's and matmul's
    output, ``'dots_no_batch'`` the matmuls' without batch dimensions,
    ``'corr'`` the correlation features alone. A policy changes memory and
    time, never values.
    """

    def __init__(
        self,
        feature_encoder: nn.Module,
        context_encoder: nn.Module,
        corr_block,
        update_block: nn.Module,
        mask_predictor: Optional[nn.Module] = None,
        remat: bool = False,
        remat_policy: Optional[str] = None,
    ):
        super().__init__()
        if remat_policy is not None and not remat:
            raise ValueError(
                "remat_policy is set but remat=False — the policy would be "
                "silently ignored; enable remat or drop the policy"
            )
        if remat_policy is not None and remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; choose from {sorted(REMAT_POLICIES)}")
        self.remat = remat
        self.remat_policy = remat_policy
        self.feature_encoder = feature_encoder
        self.context_encoder = context_encoder
        self.corr_block = corr_block
        self.update_block = update_block
        self.mask_predictor = mask_predictor

    # -- encode ------------------------------------------------------------

    @staticmethod
    def _check_grid(image, out, what: str):
        if tuple(out.shape[2:4]) != (image.shape[2] // 8, image.shape[3] // 8):
            raise ValueError(f"{what} must downsample exactly 8x")

    def _encode_pair(self, image1, image2):
        b, _, h, w = image1.shape
        if image2.shape != image1.shape:
            raise ValueError("input images must have identical shapes")
        if h % 8 or w % 8:
            raise ValueError("input H and W must be divisible by 8")
        fmaps = self.feature_encoder(torch.cat([image1, image2], dim=0))
        self._check_grid(image1, fmaps, "feature encoder")
        fmap1, fmap2 = fmaps.split(b, dim=0)
        context_out = self.context_encoder(image1)
        self._check_grid(image1, context_out, "context encoder")
        return fmap1, fmap2, context_out

    @fp32_precision()
    def forward(self, image1, image2, num_flow_updates: int = 12, emit_all: bool = True):
        """Flow from ``image1`` to ``image2``: ``(N, B, 2, H, W)`` with every
        iteration's flow when ``emit_all``, else the final ``(B, 2, H, W)``."""
        fmap1, fmap2, context_out = self._encode_pair(image1, image2)
        return self.iterate(
            fmap1, fmap2, context_out, num_flow_updates=num_flow_updates, emit_all=emit_all
        )

    @fp32_precision()
    def encode_frame(self, image):
        """Encode ONE frame batch ``(B, 3, H, W)`` -> (feature map, raw context
        output), both at /8. Per-sample normalization makes this equal to the
        batch-stacked pairwise encode."""
        if image.shape[2] % 8 or image.shape[3] % 8:
            raise ValueError("input H and W must be divisible by 8")
        fmap = self.feature_encoder(image)
        self._check_grid(image, fmap, "feature encoder")
        context_out = self.context_encoder(image)
        self._check_grid(image, context_out, "context encoder")
        return fmap, context_out

    # -- refine ------------------------------------------------------------

    def _split_context(self, context_out):
        hidden_size = self.update_block.hidden_state_size
        if context_out.shape[1] <= hidden_size:
            raise ValueError(
                f"context encoder outputs {context_out.shape[1]} channels; "
                f"needs > hidden_state_size={hidden_size}"
            )
        hidden, context = context_out.split([hidden_size, context_out.shape[1] - hidden_size], dim=1)
        return torch.tanh(hidden), torch.relu(context)

    def _step(self, coords0, coords1, hidden, context, pyramid, projected=None):
        """One refinement iteration; ``projected`` is its correlation
        features when computed beforehand (:meth:`_corr_features`)."""
        # flow targets do not backprop through the accumulated coordinates
        coords1 = coords1.detach()
        centroids = coords1.permute(0, 2, 3, 1)  # (B, h, w, 2)
        corr_features = LazyCorrFeatures(self.corr_block, pyramid, centroids, projected)
        hidden, delta_flow = self.update_block(hidden, context, corr_features, coords1 - coords0)
        return coords1 + delta_flow, hidden

    @fp32_precision()
    def _refine(self, coords0, coords1, hidden, context, pyramid, emit_all: bool, projected=None):
        """One refinement iteration and, when ``emit_all``, its upsampled
        flow (else ``None``): the unit ``remat`` recomputes, pinned to
        IEEE fp32 on its own so a backward-pass recompute is too."""
        coords1, hidden = self._step(coords0, coords1, hidden, context, pyramid, projected)
        flow = self._upsample(coords1 - coords0, hidden) if emit_all else None
        return coords1, hidden, flow

    @fp32_precision()
    def _corr_features(self, coords1, pyramid):
        """The step's correlation features, ``convcorr1``'s output, for
        ``remat_policy='corr'``: kept, where the step after it is
        recomputed. A block whose projection keeps only its inputs for the
        backward (the fused one) runs as is; the dense lookup's own
        intermediates are recomputed in the backward, as JAX does."""
        motion = self.update_block.motion_encoder
        proj = motion.convcorr1[0]
        centroids = coords1.detach().permute(0, 2, 3, 1)
        project = partial(self.corr_block.index_project, dtype=motion.compute_dtype)
        if getattr(self.corr_block, "projection_keeps_inputs", False):
            return project(pyramid, centroids, proj.weight, proj.bias)
        return checkpoint(project, pyramid, centroids, proj.weight, proj.bias, use_reentrant=False,
                          preserve_rng_state=False)

    def _upsample(self, flow, hidden):
        up_mask = self.mask_predictor(hidden) if self.mask_predictor is not None else None
        return upsample_flow(flow, up_mask)

    @fp32_precision()
    def iterate(self, fmap1, fmap2, context_out, num_flow_updates: int = 12, emit_all: bool = True):
        """Correlation pyramid + iterative refinement from encoded inputs;
        ``context_out`` is the raw context-encoder output."""
        b, _, h8, w8 = fmap1.shape
        if fmap2.shape != fmap1.shape:
            raise ValueError("feature maps must have identical shapes")
        if tuple(context_out.shape[2:4]) != (h8, w8):
            raise ValueError("context output must match the feature grid")
        pyramid = self.corr_block.build_pyramid(fmap1, fmap2)
        hidden, context = self._split_context(context_out)
        coords0 = coords_grid(b, h8, w8, device=fmap1.device)
        coords1 = coords0.clone()
        flows = []
        remat = self.remat and torch.is_grad_enabled()
        policy = REMAT_POLICIES.get(self.remat_policy)
        context_fn = {} if policy is None else {"context_fn": partial(create_selective_checkpoint_contexts, policy)}
        for _ in range(num_flow_updates):
            args = (coords0, coords1, hidden, context, pyramid, emit_all)
            if remat:
                if self.remat_policy == "corr":
                    args += (self._corr_features(coords1, pyramid),)
                coords1, hidden, flow = checkpoint(self._refine, *args, use_reentrant=False,
                                                   preserve_rng_state=False, **context_fn)
            else:
                coords1, hidden, flow = self._refine(*args)
            if emit_all:
                flows.append(flow)
        if emit_all:
            return torch.stack(flows, dim=0)
        return self._upsample(coords1 - coords0, hidden)

    # -- iteration-level entry points --------------------------------------

    @fp32_precision()
    def begin_pair(self, image1, image2, init_flow=None):
        """Encode both frames (batch-stacked, as ``forward`` does) and return
        the :meth:`begin_refinement` state."""
        fmap1, fmap2, context_out = self._encode_pair(image1, image2)
        return self.begin_refinement(fmap1, fmap2, context_out, init_flow=init_flow)

    @fp32_precision()
    def begin_refinement(self, fmap1, fmap2, context_out, init_flow=None):
        """Refinement state from encoded inputs: the pyramid levels as
        ``(B, Q, hl, wl)``, ``coords1`` ``(B, 2, h, w)``, ``hidden`` and
        ``context``. ``init_flow`` ``(B, 2, h, w)`` (1/8-grid pixels)
        warm-starts ``coords1``; zeros or ``None`` is the cold start."""
        b, _, h8, w8 = fmap1.shape
        if fmap2.shape != fmap1.shape:
            raise ValueError("feature maps must have identical shapes")
        if tuple(context_out.shape[2:4]) != (h8, w8):
            raise ValueError("context output must match the feature grid")
        pyramid = self.corr_block.build_pyramid(fmap1, fmap2)
        pyramid = map_levels(pyramid, lambda lvl: lvl.reshape((b, h8 * w8) + tuple(lvl.shape[1:])))
        hidden, context = self._split_context(context_out)
        coords1 = coords_grid(b, h8, w8, device=fmap1.device)
        if init_flow is not None:
            if tuple(init_flow.shape) != (b, 2, h8, w8):
                raise ValueError(
                    f"init_flow must be (B, 2, H/8, W/8) = {(b, 2, h8, w8)}, "
                    f"got {tuple(init_flow.shape)}"
                )
            coords1 = coords1 + init_flow
        return {"pyramid": pyramid, "coords1": coords1, "hidden": hidden, "context": context}

    @fp32_precision()
    def iterate_step(self, state):
        """Advance refinement state by exactly one GRU iteration."""
        coords1 = state["coords1"]
        b, _, h8, w8 = coords1.shape
        pyramid = map_levels(state["pyramid"], lambda lvl: lvl.reshape((-1,) + tuple(lvl.shape[2:])))
        coords0 = coords_grid(b, h8, w8, device=coords1.device)
        coords1, hidden = self._step(coords0, coords1, state["hidden"], state["context"], pyramid)
        return {
            "pyramid": state["pyramid"],
            "coords1": coords1,
            "hidden": hidden,
            "context": state["context"],
        }

    @fp32_precision()
    def finalize_flow(self, coords1, hidden):
        """The final-upsample tail of :meth:`iterate`, standalone."""
        b, _, h8, w8 = coords1.shape
        coords0 = coords_grid(b, h8, w8, device=coords1.device)
        return self._upsample(coords1 - coords0, hidden)
