"""Model zoo: named RAFT configurations, assembly, and weights.

Hyperparameters reproduce torchvision's raft_large / raft_small, field for
field as the JAX package's ``RAFTConfig``. Weights are seeded random
(torchvision's initializer) unless a local checkpoint is given, a torch
``.pth`` state_dict or the JAX package's Flax ``.msgpack``: nothing is ever
fetched.

Precision knobs (``compute_dtype``, ``corr_dtype``) change activation and
storage casts only, as in the JAX package (``raft_tpu/models/zoo.py``):
parameters, norm statistics, coordinates, flow and the upsample's softmax
stay fp32, so the parameter tree and a loaded checkpoint never change.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from raft_tpu_torch.device import resolve_device
from raft_tpu_torch.models.corr import CorrBlock
from raft_tpu_torch.models.encoders import FeatureEncoder
from raft_tpu_torch.models.layers import BottleneckBlock, Conv2d, ResidualBlock
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.models.update import (
    FlowHead,
    MaskPredictor,
    MotionEncoder,
    RecurrentBlock,
    UpdateBlock,
)

__all__ = [
    "RAFTConfig",
    "RAFT_LARGE",
    "RAFT_SMALL",
    "CONFIGS",
    "build_raft",
    "load_checkpoint",
    "raft_for_serving",
    "raft_large",
    "raft_small",
]

_BLOCKS = {"residual": ResidualBlock, "bottleneck": BottleneckBlock}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """Flat hyperparameter set fully describing a RAFT variant."""

    name: str
    feature_encoder_widths: Tuple[int, int, int, int, int]
    feature_encoder_block: str  # 'residual' | 'bottleneck'
    feature_encoder_norm: Optional[str]  # 'batch' | 'instance' | None
    context_encoder_widths: Tuple[int, int, int, int, int]
    context_encoder_block: str
    context_encoder_norm: Optional[str]
    corr_levels: int
    corr_radius: int
    motion_corr_widths: Tuple[int, ...]
    motion_flow_widths: Tuple[int, int]
    motion_out_channels: int
    gru_hidden: int
    gru_kernels: Tuple[Tuple[int, int], ...]
    gru_pads: Tuple[Tuple[int, int], ...]
    flow_head_hidden: int
    use_mask_predictor: bool
    mask_predictor_hidden: int = 256
    # 'dense': plain PyTorch volume, pyramid and lookup; 'fused': lookup +
    # convcorr1 in the CUDA kernel (kernels/lookup_xtap.py); 'pallas':
    # volume + pyramid in the CUDA kernel (kernels/corr_pallas.py), plain
    # lookup. Parameter-free either way.
    corr_impl: str = "dense"
    # conv stacks' compute dtype: 'float32' | 'bfloat16'
    compute_dtype: str = "float32"
    # pyramid storage: None (follows compute_dtype) | 'float32' |
    # 'bfloat16' | 'int8' (corr_impl='fused' only, inference only)
    corr_dtype: Optional[str] = None
    # recompute each refinement step in the backward pass (training)
    remat: bool = False
    # selective remat under remat=True: a key of models.raft.REMAT_POLICIES
    # ('dots', 'dots_no_batch', 'corr'); None recomputes whole steps
    remat_policy: Optional[str] = None

    def replace(self, **kw) -> "RAFTConfig":
        return dataclasses.replace(self, **kw)


RAFT_LARGE = RAFTConfig(
    name="raft_large",
    feature_encoder_widths=(64, 64, 96, 128, 256),
    feature_encoder_block="residual",
    feature_encoder_norm="instance",
    context_encoder_widths=(64, 64, 96, 128, 256),
    context_encoder_block="residual",
    context_encoder_norm="batch",
    corr_levels=4,
    corr_radius=4,
    motion_corr_widths=(256, 192),
    motion_flow_widths=(128, 64),
    motion_out_channels=128,
    gru_hidden=128,
    gru_kernels=((1, 5), (5, 1)),
    gru_pads=((0, 2), (2, 0)),
    flow_head_hidden=256,
    use_mask_predictor=True,
)

RAFT_SMALL = RAFTConfig(
    name="raft_small",
    feature_encoder_widths=(32, 32, 64, 96, 128),
    feature_encoder_block="bottleneck",
    feature_encoder_norm="instance",
    context_encoder_widths=(32, 32, 64, 96, 160),
    context_encoder_block="bottleneck",
    context_encoder_norm=None,
    corr_levels=4,
    corr_radius=3,
    motion_corr_widths=(96,),
    motion_flow_widths=(64, 32),
    motion_out_channels=82,
    gru_hidden=96,
    gru_kernels=((3, 3),),
    gru_pads=((1, 1),),
    flow_head_hidden=128,
    use_mask_predictor=False,
)

CONFIGS = {"raft_large": RAFT_LARGE, "raft_small": RAFT_SMALL}


def _resolve_dtypes(config: RAFTConfig):
    """(compute dtype, pyramid dtype), ``None`` for fp32, as the JAX
    ``build_raft`` resolves them: ``corr_dtype=None`` follows
    ``compute_dtype``; int8 needs ``corr_impl='fused'``."""
    if config.corr_impl == "onthefly":
        raise NotImplementedError(
            "corr_impl='onthefly' is not ported yet: ROADMAP queue 1 item 5"
        )
    if config.corr_impl not in ("dense", "fused", "pallas"):
        raise ValueError(f"unknown corr_impl {config.corr_impl!r}")
    if config.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {config.compute_dtype!r}")
    compute = _DTYPES[config.compute_dtype]
    compute = None if compute == torch.float32 else compute
    if config.corr_dtype == "int8":
        # symmetric per-level quantized pyramid: fused-impl inference only
        if config.corr_impl != "fused":
            raise ValueError("corr_dtype='int8' requires corr_impl='fused'")
        return compute, torch.int8
    if config.corr_dtype is not None and config.corr_dtype not in _DTYPES:
        raise ValueError(f"corr_dtype must be None, 'int8' or one of {sorted(_DTYPES)}, "
                         f"got {config.corr_dtype!r}")
    corr = _DTYPES[config.corr_dtype] if config.corr_dtype is not None else compute
    return compute, None if corr == torch.float32 else corr


def _set_compute_dtype(model: RAFT, dtype) -> None:
    """Every conv computes at ``dtype`` except the flow head's ``conv2`` and
    the mask head's last conv, which stay fp32 (``raft_tpu/models/
    update.py:161,200``); the ``convcorr1`` projection follows ``dtype``."""
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = dtype
    model.update_block.flow_head.conv2.compute_dtype = None
    if model.mask_predictor is not None:
        model.mask_predictor.conv.compute_dtype = None
    model.update_block.motion_encoder.compute_dtype = dtype


def _init_weights(model: nn.Module) -> None:
    """torchvision RAFT's initializer: kaiming-normal (fan_out) convs with
    zero bias, unit/zero norm affines."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def build_raft(config: RAFTConfig, *, device=None, seed: int = 0) -> RAFT:
    """Assemble a RAFT module from a config with seeded random weights, in
    eval mode on ``device`` (the CUDA card unless ``'cpu'`` is named)."""
    compute_dtype, corr_dtype = _resolve_dtypes(config)
    dev = resolve_device(device)
    # the kernel modules are imported here: they build on models.corr
    if config.corr_impl == "fused":
        from raft_tpu_torch.kernels.lookup_xtap import FusedLookupCorrBlock

        corr_block = FusedLookupCorrBlock(config.corr_levels, config.corr_radius, corr_dtype)
    elif config.corr_impl == "pallas":
        from raft_tpu_torch.kernels.corr_pallas import PallasCorrBlock

        corr_block = PallasCorrBlock(config.corr_levels, config.corr_radius, corr_dtype)
    else:
        corr_block = CorrBlock(config.corr_levels, config.corr_radius, corr_dtype)
    hidden = config.gru_hidden
    context_channels = config.context_encoder_widths[-1] - hidden
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = RAFT(
            feature_encoder=FeatureEncoder(
                _BLOCKS[config.feature_encoder_block],
                config.feature_encoder_widths,
                config.feature_encoder_norm,
            ),
            context_encoder=FeatureEncoder(
                _BLOCKS[config.context_encoder_block],
                config.context_encoder_widths,
                config.context_encoder_norm,
            ),
            corr_block=corr_block,
            update_block=UpdateBlock(
                MotionEncoder(
                    corr_block.out_channels,
                    config.motion_corr_widths,
                    config.motion_flow_widths,
                    config.motion_out_channels,
                ),
                RecurrentBlock(
                    hidden,
                    context_channels + config.motion_out_channels,
                    config.gru_kernels,
                    config.gru_pads,
                ),
                FlowHead(hidden, config.flow_head_hidden),
            ),
            mask_predictor=(
                MaskPredictor(hidden, config.mask_predictor_hidden)
                if config.use_mask_predictor
                else None
            ),
            remat=config.remat,
            remat_policy=config.remat_policy,
        )
        _init_weights(model)
    _set_compute_dtype(model, compute_dtype)
    return model.to(dev).eval()


def load_checkpoint(path: str):
    """The state_dict in a weight file, by its content: a torch file (a zip
    archive, ``PK``, or a legacy pickle, byte ``0x80``) goes to
    ``torch.load(weights_only=True)``; a Flax ``.msgpack`` variable tree (a
    non-empty msgpack map: a first byte ``0x81``-``0x8f``, ``0xde`` or
    ``0xdf``) to ``state_dict_from_flax(load_msgpack(path))``. Anything
    else raises a ``ValueError``."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head.startswith(b"PK") or (len(head) == 2 and head[0] == 0x80):
        return torch.load(path, map_location="cpu", weights_only=True)
    if head and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        from raft_tpu_torch.checkpoint.convert import load_msgpack, state_dict_from_flax

        return state_dict_from_flax(load_msgpack(path))
    raise ValueError(
        f"{path}: not a weight file this port reads; expected a torch .pth "
        "state_dict (torch.save) or a Flax .msgpack variable tree (the JAX "
        "package's weights)"
    )


def _make(arch: str, pretrained: bool, checkpoint: Optional[str], device, seed: int, **overrides) -> RAFT:
    if arch not in CONFIGS:
        raise ValueError(f"unknown arch {arch!r}; choose from {sorted(CONFIGS)}")
    if pretrained and checkpoint is None:
        raise FileNotFoundError(
            f"pretrained {arch} weights are not bundled and are never "
            "downloaded; pass checkpoint=<path to a .pth state_dict or a "
            "Flax .msgpack>"
        )
    config = CONFIGS[arch]
    if overrides:
        config = config.replace(**overrides)
    model = build_raft(config, device=device, seed=seed)
    if checkpoint is not None:
        model.load_state_dict(load_checkpoint(checkpoint), strict=True)
    return model


def raft_large(
    *, pretrained: bool = False, checkpoint: Optional[str] = None, device=None, seed: int = 0, **overrides
) -> RAFT:
    """RAFT large (torchvision widths) on ``device``; config overrides as
    keyword arguments (e.g. ``corr_impl='fused'``)."""
    return _make("raft_large", pretrained, checkpoint, device, seed, **overrides)


def raft_small(
    *, pretrained: bool = False, checkpoint: Optional[str] = None, device=None, seed: int = 0, **overrides
) -> RAFT:
    """RAFT small (torchvision widths) on ``device``."""
    return _make("raft_small", pretrained, checkpoint, device, seed, **overrides)


def raft_for_serving(
    serve_config,
    *,
    arch: str = "raft_large",
    pretrained: bool = False,
    checkpoint: Optional[str] = None,
    device=None,
    seed: int = 0,
    **overrides,
) -> RAFT:
    """A model at a serving config's precision (``raft_tpu/models/
    zoo.py:402-430``): the config's ``model_overrides()`` (compute dtype,
    pyramid dtype, corr_impl) become :class:`RAFTConfig` overrides, and
    explicit ``**overrides`` win over them. Precision never changes the
    parameters, so fp32 checkpoints load unchanged::

        cfg = ServeConfig.preset("throughput")
        model = raft_for_serving(cfg, checkpoint="raft_large.msgpack")
    """
    kw = dict(serve_config.model_overrides())
    kw.update(overrides)
    return _make(arch, pretrained, checkpoint, device, seed, **kw)
