#!/usr/bin/env python3
"""The golden fixture's EPE at each precision configuration, on the card
and on the CPU, and how far the bf16 encoders' outputs of the two devices
lie apart.

Run from the repository root (the card is used when there is one):

    python3 tools/golden_precision.py

For each configuration (fp32 ``quality``, fused + bf16 pyramid,
``throughput``, ``edge``) it prints the clean-pass EPE of the trained
fixture (``tests/fixtures/epe_golden``, 32 updates) and its distance from
the reference EPE, per device. With a card it then prints the relative
distance (max and mean over the largest magnitude / the mean magnitude)
between the card's and the CPU's bf16 feature- and context-encoder
outputs on the first fixture frame, and the same between bf16 and fp32 on
the card: the scale of bf16 rounding noise through the encoders.

Then, layer by layer at ``throughput``'s knobs (one flow update on the
first fixture pair), each conv-norm stage (``ConvNormAct`` with a norm) and
each other convolution is fed the CPU's own input to it, on each device,
and its output is held against the exact result of that input under the
port's semantics, computed in fp64 from the same bf16 operands: the
product rounded to bf16; then, in a conv-norm stage, the bias added and
the sum normalized unrounded, rounded once at the output; elsewhere the
bias added in bf16. A device that sums the product in fp32 stays within
about one ulp of it on every element. For each layer it prints, per
device, the largest gap in ulps of the output dtype (each element's ulp)
and the share of elements more than one ulp away, the card's distance from
the CPU on the same input, and, for the two devices each running the whole
chain, their relative distance at that layer's output. The last line is a
JSON object of the numbers.
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
from raft_tpu_torch.models.layers import Conv2d, ConvNormAct, InstanceNorm  # noqa: E402

FIXTURE = ROOT / "tests" / "fixtures" / "epe_golden"
CONFIGS = {
    "quality": {},
    "fused + bf16 pyramid": dict(corr_impl="fused", corr_dtype="bfloat16"),
    "throughput": rt.ServeConfig.preset("throughput").model_overrides(),
    "edge": rt.ServeConfig.preset("edge").model_overrides(),
}


def model(device, **knobs):
    return rt.raft_small(checkpoint=str(FIXTURE / "weights.msgpack"), device=device, **chip_smoke.FIXTURE_ARCH,
                         **knobs)


def encoders(m, device):
    """Feature- and context-encoder outputs on the first clean frame, fp32 on the host."""
    frame = Sintel(str(FIXTURE), dstype="clean")[0]["image1"][:88, :128]
    x = torch.from_numpy(frame.astype(np.float32) / 127.5 - 1.0).permute(2, 0, 1)[None].to(device)
    with torch.inference_mode():
        return [enc(x).float().cpu() for enc in (m.feature_encoder, m.context_encoder)]


def rel(a, b):
    return {"max": ((a - b).abs().max() / b.abs().max()).item(), "mean": ((a - b).abs().mean() / b.abs().mean()).item()}


def _record(m, x1, x2):
    """Every call of a conv-norm stage or another convolution in one flow
    update: (layer, input, output)."""
    calls = []

    def hook(mod, inp, out, name):
        calls.append((name, inp[0].detach().clone(), out.detach().clone()))

    # a conv-norm stage runs its conv's product directly, so the hook of a
    # Conv2d fires only for the convolutions outside such stages
    hooks = [mod.register_forward_hook(lambda mod, inp, out, name=name: hook(mod, inp, out, name))
             for name, mod in m.named_modules()
             if isinstance(mod, Conv2d) or (isinstance(mod, ConvNormAct) and mod.has_norm)]
    with torch.inference_mode():
        m(x1, x2, num_flow_updates=1, emit_all=False)
    for h in hooks:
        h.remove()
    return calls


def _exact(mod, x):
    """The layer's result on ``x``'s operands under the port's semantics,
    computed in fp64 and rounded where the semantics rounds."""
    conv = mod[0] if isinstance(mod, ConvNormAct) else mod
    dt = conv.compute_dtype or torch.float32
    with torch.inference_mode():
        p = F.conv2d(x.to(dt).double(), conv.weight.detach().to(dt).double(), None, conv.stride, conv.padding,
                     conv.dilation, conv.groups).to(dt)
        b = None if conv.bias is None else conv.bias.detach().to(dt).view(1, -1, 1, 1)
        if conv is mod:
            return p if b is None else p + b
        y = p.double() if b is None else p.double() + b.double()
        norm = mod[1]
        if isinstance(norm, InstanceNorm):
            mu = y.mean(dim=(2, 3), keepdim=True)
            y = (y - mu) / torch.sqrt(((y - mu) ** 2).mean(dim=(2, 3), keepdim=True) + 1e-5)
            out_dt = dt
        else:
            shape = (1, -1, 1, 1)
            y = (y - norm.running_mean.double().view(shape)) / torch.sqrt(
                norm.running_var.double().view(shape) + norm.eps)
            y = y * norm.weight.double().view(shape) + norm.bias.double().view(shape)
            out_dt = torch.float32
        return (torch.relu(y) if len(mod) > 2 else y).to(out_dt)


def _ulps(a, b):
    """|a - b| per element in ulps of ``a``'s dtype at the larger magnitude."""
    mant = {torch.bfloat16: 8, torch.float16: 11}.get(a.dtype, 24)
    a, b = a.double(), b.double()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return (a - b).abs() / torch.ldexp(torch.ones_like(a), e - mant)


def layer_gaps(devices):
    """Per conv-norm stage and convolution at ``throughput``'s knobs: each device against the
    exact result of the CPU's input, the card against the CPU on that input,
    and the two devices' whole chains against each other."""
    knobs = rt.ServeConfig.preset("throughput").model_overrides()
    pair = Sintel(str(FIXTURE), dstype="clean")[0]
    x1, x2 = (torch.from_numpy(pair[k][:88, :128].astype(np.float32) / 127.5 - 1.0).permute(2, 0, 1)[None]
              for k in ("image1", "image2"))
    models = {dev: model(dev, **knobs) for dev in devices}
    chains = {dev: _record(models[dev], x1.to(dev), x2.to(dev)) for dev in devices}
    rows = []
    for i, (name, inp, out) in enumerate(chains["cpu"]):
        want = _exact(dict(models["cpu"].named_modules())[name], inp)
        row = {"layer": name, "op": type(dict(models["cpu"].named_modules())[name]).__name__,
               "shape": list(out.shape), "dtype": str(out.dtype).replace("torch.", "")}
        for dev in devices:
            with torch.inference_mode():
                got = out if dev == "cpu" else dict(models[dev].named_modules())[name](inp.to(dev)).cpu()
            u = _ulps(got, want)
            row[f"{dev}_vs_exact"] = {"max_ulp": u.max().item(), "over_1ulp": (u > 1).double().mean().item()}
            if dev != "cpu":
                u = _ulps(got, out)
                row[f"{dev}_vs_cpu"] = {"max_ulp": u.max().item(), "unequal": (u > 0).double().mean().item()}
                other = chains[dev][i]
                assert other[0] == name
                a, b = other[2].float().cpu(), out.float()
                row["chain_rel_max"] = ((a - b).abs().max() / b.abs().max()).item()
        rows.append(row)
        print(f"layer {json.dumps(row)}", flush=True)
    return rows


def main() -> int:
    ref = json.loads((FIXTURE / "expected.json").read_text())["reference"]["clean"]
    devices = (["cuda"] if torch.cuda.is_available() else []) + ["cpu"]
    if devices[0] == "cuda":
        print(chip_smoke.card_line(), flush=True)
    result = {"reference": ref, "epe": {}}
    for dev in devices:
        for name, knobs in CONFIGS.items():
            epe = validate(model(dev, **knobs), Sintel(str(FIXTURE), dstype="clean"), num_flow_updates=32,
                           fps_pairs=0)["epe"]
            result["epe"][f"{dev}/{name}"] = epe
            print(f"{dev} {name}: epe {epe:.7f}, |epe - reference| {abs(epe - ref):.4e}", flush=True)
    if "cuda" in devices:
        bf16 = dict(compute_dtype="bfloat16")
        card, cpu = encoders(model("cuda", **bf16), "cuda"), encoders(model("cpu", **bf16), "cpu")
        card32 = encoders(model("cuda"), "cuda")
        for i, name in enumerate(("feature_encoder", "context_encoder")):
            result[f"{name} bf16 card vs cpu"] = rel(card[i], cpu[i])
            result[f"{name} card bf16 vs fp32"] = rel(card[i], card32[i])
            print(f"{name}: bf16 card vs CPU {result[f'{name} bf16 card vs cpu']}, card bf16 vs fp32 "
                  f"{result[f'{name} card bf16 vs fp32']}", flush=True)
    result["layers"] = layer_gaps(devices)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
