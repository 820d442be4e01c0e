"""Serving configuration, the precision part: the named deployment presets.

``PRESETS`` is copied from the JAX package's ``raft_tpu/serve/config.py``
(the port cannot import it: importing ``raft_tpu.serve`` loads jax). Each
preset maps to :class:`~raft_tpu_torch.models.RAFTConfig` precision knobs
that change activation and storage casts only, never the parameters:

  quality     fp32 everywhere, the paper-native reference point.
  throughput  bf16 convs + bf16 correlation storage on the fused kernel,
              the default serving preset.
  edge        int8 correlation storage on the fused kernel with fp32
              convs; inference only (the quantized lookup has no gradient).

:class:`ServeConfig` holds only the three precision fields for now; the
engine's other knobs come with the serving layer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["PRESETS", "ServeConfig"]

PRESETS: Dict[str, Dict[str, Optional[str]]] = {
    "quality": dict(
        compute_dtype="float32", corr_dtype=None, corr_impl=None,
    ),
    "throughput": dict(
        compute_dtype="bfloat16", corr_dtype="bfloat16", corr_impl="fused",
    ),
    "edge": dict(
        compute_dtype="float32", corr_dtype="int8", corr_impl="fused",
    ),
}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The precision knobs of a serving deployment.

    Args:
        compute_dtype: the conv stacks' dtype, ``'float32'`` or
            ``'bfloat16'``.
        corr_dtype: the pyramid's storage dtype; ``None`` follows
            ``compute_dtype``.
        corr_impl: ``None`` keeps the architecture's own.
        precision: the preset's name, or ``None`` for hand-set knobs.
    """

    compute_dtype: str = "float32"
    corr_dtype: Optional[str] = None
    corr_impl: Optional[str] = None
    precision: Optional[str] = None

    @classmethod
    def preset(cls, name: str = "throughput", **overrides) -> "ServeConfig":
        """A named deployment preset (default ``'throughput'``); any field
        can be overridden."""
        if name not in PRESETS:
            raise ValueError(
                f"unknown precision preset {name!r}; choose from {sorted(PRESETS)}"
            )
        kw = dict(PRESETS[name], precision=name)
        kw.update(overrides)
        return cls(**kw)

    def model_overrides(self) -> Dict[str, Optional[str]]:
        """The :class:`~raft_tpu_torch.models.RAFTConfig` overrides this
        config's precision fields imply (only non-default knobs, so it
        composes with any base architecture)."""
        kw: Dict[str, Optional[str]] = {}
        if self.compute_dtype != "float32":
            kw["compute_dtype"] = self.compute_dtype
        if self.corr_dtype is not None:
            kw["corr_dtype"] = self.corr_dtype
        if self.corr_impl is not None:
            kw["corr_impl"] = self.corr_impl
        return kw
