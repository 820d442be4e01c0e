#!/usr/bin/env python3
"""Where the card's bf16 convolutions round, against exact sums, and what
each way of running them costs, at the shapes of the port's models.

Run from the repository root on a machine with a CUDA card:

    python3 tools/bf16_conv_audit.py

A ``compute_dtype='bfloat16'`` convolution takes bf16 operands (input,
weight, bias) and returns bf16. Two semantics round it differently: the
JAX package's modules as written round the product to bf16 and then add
the bias in bf16 (two roundings); XLA, which fuses the bias add into the
convolution, and the port's CPU path (oneDNN) add the bias to the fp32 sum
and round once. For every ``Conv2d`` of a model at ``throughput``'s knobs,
fed the inputs one flow update gives it on the card, each variant below is
held against both, computed in fp64 from the same bf16 operands, and its
convolutions' device time is read from torch.profiler:

  * ``cudnn``: ``F.conv2d`` on bf16 tensors (cuDNN's product, then the bias
    in a separate bf16 add);
  * ``tf32_fused``: ``torch.cudnn_convolution`` on fp32 copies of the bf16
    operands with TF32 allowed (a bf16 value is exact in TF32), the bias
    added in fp32, one rounding;
  * ``bias_channel``: cuDNN's bf16 convolution with the bias folded in as
    one more input channel of ones (padded to 8 channels), weighted by the
    bias at the kernel's centre tap, which always lands inside the image:
    the bias joins the fp32 sum, one rounding.

Per variant: ``product_ulp``, the largest gap of the product alone (no
bias) from the fp64 product rounded once, in bf16 ulps (``cudnn`` only:
whether cuDNN sums in fp32); the largest gap from each semantics' fp64
result in bf16 ulps of the larger value; and the share of elements more
than one ulp away. Models: the golden fixture (``tests/fixtures/epe_golden``,
its first clean pair, 88x128) and raft_large at 440x1024 on seeded
weights and images. Then the fixture's clean-pass EPE at ``throughput``
with every bf16 convolution run by each variant. The last line is a JSON
object of the numbers.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import raft_tpu_torch as rt  # noqa: E402
from raft_tpu_torch.data import Sintel  # noqa: E402
from raft_tpu_torch.eval import validate  # noqa: E402
from raft_tpu_torch.models.layers import Conv2d  # noqa: E402

FIXTURE = ROOT / "tests" / "fixtures" / "epe_golden"
BF16 = torch.bfloat16
KNOBS = rt.ServeConfig.preset("throughput").model_overrides()


def _operands(mod, x):
    w = mod.weight.detach().to(BF16)
    b = None if mod.bias is None else mod.bias.detach().to(BF16)
    return x.to(BF16), w, b


def cudnn(mod, x, w, b):
    return F.conv2d(x, w, b, mod.stride, mod.padding, mod.dilation, mod.groups)


def tf32_fused(mod, x, w, b):
    y = torch.cudnn_convolution(x.float(), w.float(), mod.padding, mod.stride, mod.dilation, mod.groups, False,
                                False, True)
    return (y if b is None else y + b.float().view(1, -1, 1, 1)).to(BF16)


def bias_channel(mod, x, w, b):
    if b is None:
        return cudnn(mod, x, w, None)
    kh, kw = w.shape[-2:]
    assert tuple(mod.padding) == ((kh - 1) // 2, (kw - 1) // 2) and tuple(mod.dilation) == (1, 1)
    ones = torch.zeros(x.shape[0], 8, *x.shape[2:], dtype=x.dtype, device=x.device)
    ones[:, 0] = 1
    w2 = torch.zeros(w.shape[0], w.shape[1] + 8, kh, kw, dtype=w.dtype, device=w.device)
    w2[:, : w.shape[1]] = w
    w2[:, w.shape[1], kh // 2, kw // 2] = b
    return F.conv2d(torch.cat([x, ones], 1), w2, None, mod.stride, mod.padding, mod.dilation, mod.groups)


VARIANTS = {f.__name__: f for f in (cudnn, tf32_fused, bias_channel)}


def _ulps(y, e):
    _, ex = torch.frexp(torch.maximum(y.abs(), e.abs()))
    return (y - e).abs() / torch.ldexp(torch.ones_like(y), ex - 8)


def gaps(mod, x, w, b, y, product=None):
    """Gaps of ``y`` from both semantics (and of ``product`` from the
    product rounded once), in bf16 ulps: (max, share over one ulp)."""
    p64 = F.conv2d(x.double(), w.double(), None, mod.stride, mod.padding, mod.dilation, mod.groups)
    bias = 0.0 if b is None else b.double().view(1, -1, 1, 1)
    refs = {"fused": (p64 + bias).to(BF16).double(),
            "two_roundings": (p64.to(BF16) + (0 if b is None else b.view(1, -1, 1, 1))).double()}
    out = {}
    for name, e in refs.items():
        u = _ulps(y.double(), e)
        out[name] = (u.max().item(), (u > 1).double().mean().item())
    if product is not None:
        u = _ulps(product.double(), p64.to(BF16).double())
        out["product"] = (u.max().item(), (u > 1).double().mean().item())
    return out


def record(m, x1, x2):
    """(name, module, bf16 operands) of every bf16 conv call in one flow update."""
    calls = []
    hooks = [mod.register_forward_hook(
        lambda mod, inp, out, name=name: calls.append((name, mod) + _operands(mod, inp[0].clone())))
        for name, mod in m.named_modules() if isinstance(mod, Conv2d) and mod.compute_dtype == BF16]
    with torch.inference_mode():
        m(x1, x2, num_flow_updates=1, emit_all=False)
    for h in hooks:
        h.remove()
    return calls


def device_ms(fn, calls, reps=5):
    """Device time of one pass over ``calls``, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        for _, mod, x, w, b in calls:
            fn(mod, x, w, b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for _, mod, x, w, b in calls:
                    fn(mod, x, w, b)
            torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps


def audit(label, m, x1, x2):
    calls = record(m, x1, x2)
    enc = [c for c in calls if not c[0].startswith("update_block")]
    upd = [c for c in calls if c[0].startswith("update_block")]
    out = {}
    for name, fn in VARIANTS.items():
        worst = {}
        with torch.inference_mode():
            for layer, mod, x, w, b in calls:
                prod = cudnn(mod, x, w, None) if name == "cudnn" else None
                for k, (u, share) in gaps(mod, x, w, b, fn(mod, x, w, b), prod).items():
                    m_u, m_share, m_layer = worst.get(k, (0.0, 0.0, ""))
                    worst[k] = (max(m_u, u), max(m_share, share), m_layer if m_u >= u else layer)
        enc_ms, upd_ms = device_ms(fn, enc), device_ms(fn, upd)
        out[name] = {f"{k}_max_ulp": v[0] for k, v in worst.items()}
        out[name].update({f"{k}_worst_layer_share_over_1ulp": v[1] for k, v in worst.items()})
        out[name].update({f"{k}_worst_layer": v[2] for k, v in worst.items()})
        out[name].update({"encoders_ms": enc_ms, "update_ms": upd_ms, "request_ms_32_updates": enc_ms + 32 * upd_ms})
        print(f"{label} {name}: {json.dumps(out[name])}", flush=True)
    return out


def fixture_epe(variant):
    fn = VARIANTS[variant]
    forward = Conv2d.forward
    Conv2d.forward = lambda self, x: fn(self, *_operands(self, x)) if self.compute_dtype == BF16 else forward(self, x)
    try:
        m = rt.raft_small(checkpoint=str(FIXTURE / "weights.msgpack"), **chip_smoke.FIXTURE_ARCH, **KNOBS)
        return validate(m, Sintel(str(FIXTURE), dstype="clean"), num_flow_updates=32, fps_pairs=0)["epe"]
    finally:
        Conv2d.forward = forward


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_conv_audit: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    print(f"torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}", flush=True)
    result = {"models": {}, "fixture_epe": {}}
    pair = Sintel(str(FIXTURE), dstype="clean")[0]
    x1, x2 = (torch.from_numpy(pair[k][:88, :128].astype(np.float32) / 127.5 - 1.0).permute(2, 0, 1)[None].cuda()
              for k in ("image1", "image2"))
    fixture = rt.raft_small(checkpoint=str(FIXTURE / "weights.msgpack"), **chip_smoke.FIXTURE_ARCH, **KNOBS)
    result["models"]["fixture"] = audit("fixture", fixture, x1, x2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    large = rt.raft_large(**KNOBS)
    y1, y2 = (torch.rand(1, 3, 440, 1024, generator=gen, device="cuda") * 2 - 1 for _ in range(2))
    result["models"]["raft_large"] = audit("raft_large", large, y1, y2)
    ref = json.loads((FIXTURE / "expected.json").read_text())["reference"]["clean"]
    for name in VARIANTS:
        epe = fixture_epe(name)
        result["fixture_epe"][name] = epe
        print(f"fixture throughput epe, convs by {name}: {epe:.7f}, |epe - reference| {abs(epe - ref):.4e}",
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
