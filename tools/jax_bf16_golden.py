#!/usr/bin/env python3
"""The JAX package's golden-fixture EPE at ``throughput``'s knobs on the CPU,
and where XLA rounds a bf16 conv-norm block: the reference that the port's
bf16 convolutions are held to.

Run from the repository root:

    python3 tools/jax_bf16_golden.py
    XLA_FLAGS=--xla_allow_excess_precision=false python3 tools/jax_bf16_golden.py

It prints the clean-pass EPE of the trained fixture (``tests/fixtures/
epe_golden``, 32 updates) through ``raft_tpu.eval.validate`` at fused +
bf16 pyramid + bf16 convs, its distance from the reference EPE, and the
optimized HLO of the fusion that adds the bias of a bf16 ``BottleneckBlock``'s
last conv and normalizes it (a ``convert`` to bf16 marks each rounding XLA
keeps). With excess precision off, XLA keeps every bf16 rounding the
modules write.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import flax.serialization  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from raft_tpu.data.datasets import Sintel  # noqa: E402
from raft_tpu.eval.validate import validate  # noqa: E402
from raft_tpu.models.layers import BottleneckBlock  # noqa: E402
from raft_tpu.models.zoo import build_raft, init_variables  # noqa: E402
from scripts.make_epe_fixture import fixture_arch  # noqa: E402

FIXTURE = ROOT / "tests" / "fixtures" / "epe_golden"
THROUGHPUT = dict(corr_impl="fused", corr_dtype="bfloat16", compute_dtype="bfloat16")


def golden_epe() -> float:
    tmpl = jax.tree.map(np.zeros_like, jax.device_get(init_variables(build_raft(fixture_arch()))))
    trained = flax.serialization.from_bytes(tmpl, (FIXTURE / "weights.msgpack").read_bytes())
    model = build_raft(fixture_arch().replace(**THROUGHPUT))
    ds = Sintel(str(FIXTURE), split="training", dstype="clean")
    return validate(model, trained, ds, num_flow_updates=32, mode="sintel", fps_pairs=0, progress=False)["epe"]


def block_norm_fusion() -> str:
    """The optimized HLO of the fusion that adds the bias of a bf16
    ``BottleneckBlock``'s last conv and normalizes it."""
    x = jnp.asarray(np.random.default_rng(0).normal(size=(1, 16, 16, 16)).astype(np.float32)).astype(jnp.bfloat16)
    block = BottleneckBlock(16, "instance", 1, dtype=jnp.bfloat16)
    text = jax.jit(block.apply).lower(block.init(jax.random.PRNGKey(0), x), x).compile().as_text()
    body = text[text.index("%fused_computation ("):]
    return "\n".join(line.split(", metadata")[0] for line in body[: body.index("\n}")].splitlines())


def main() -> int:
    ref = json.loads((FIXTURE / "expected.json").read_text())["reference"]["clean"]
    epe = golden_epe()
    print(block_norm_fusion())
    print(json.dumps({"xla_flags": os.environ.get("XLA_FLAGS", ""), "throughput_epe": epe, "reference": ref,
                      "gap": abs(epe - ref)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
