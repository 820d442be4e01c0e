"""Sintel validation loop: the reference acceptance protocol on the port.

Ported from the JAX package's ``raft_tpu/eval/validate.py``: normalize to
[-1, 1], replicate-pad to %8, ``num_flow_updates`` refinement steps (32 is
the published protocol), EPE of the final prediction, per-pixel
concatenated over all pairs. Host I/O runs on a prefetch thread while the
card computes. Throughput comes from :func:`chained_pairs_per_s`: N
same-shape pairs back to back as CUDA-graph replays after a warm-up pair,
one ``torch.cuda.synchronize()`` at the end.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from raft_tpu_torch.data.datasets import FlowDataset, Sintel
from raft_tpu_torch.eval.padder import InputPadder
from raft_tpu_torch.utils.prefetch import prefetch

__all__ = ["validate", "validate_sintel", "chained_pairs_per_s"]


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _nchw(images: np.ndarray, device) -> torch.Tensor:
    """(B, H, W, 3) numpy -> (B, 3, H, W) on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(images)).to(device).permute(0, 3, 1, 2)


def chained_pairs_per_s(
    model, images1: Sequence[np.ndarray], images2: Sequence[np.ndarray], *, num_flow_updates: int = 32
) -> float:
    """Pairs per second over N same-shape pairs run back to back.

    ``images1``/``images2``: N normalized, padded ``(H, W, 3)`` float32
    frames. The inputs are copied to the model's device first. The model's
    call is captured once as a CUDA graph (``inference.flow_program``; eager
    on the CPU) on the first pair, which is the warm-up; each timed pair is
    two device-to-device copies into the graph's static buffers and one
    replay, and the clock stops after one
    ``torch.cuda.synchronize()`` that follows the last pair (on the CPU the
    host clock alone)."""
    # imported here: the inference module imports this package
    from raft_tpu_torch.inference import flow_program, run_flow

    device = _device(model)
    x1 = _nchw(np.stack(images1), device)
    x2 = _nchw(np.stack(images2), device)
    cuda = device.type == "cuda"
    with torch.inference_mode():
        prog = flow_program(model, x1[:1].clone(), x2[:1].clone(), num_flow_updates=num_flow_updates,
                            name="chained pairs")
        prog()
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for i in range(x1.shape[0]):
            run_flow(prog, x1[i : i + 1], x2[i : i + 1])
        if cuda:
            torch.cuda.synchronize(device)
    return x1.shape[0] / (time.perf_counter() - t0)


def _prepare(sample, mode: str):
    im1 = sample["image1"].astype(np.float32) / 255.0 * 2.0 - 1.0
    im2 = sample["image2"].astype(np.float32) / 255.0 * 2.0 - 1.0
    padder = InputPadder(im1.shape, mode=mode)
    im1, im2 = padder.pad(im1, im2)
    return {"image1": im1, "image2": im2, "flow": sample.get("flow"), "valid": sample.get("valid")}, padder


def validate(
    model,
    dataset: FlowDataset,
    *,
    num_flow_updates: int = 32,
    mode: str = "sintel",
    use_valid_mask: Optional[bool] = None,
    fps_pairs: int = 64,
) -> Dict[str, float]:
    """Run the reference validation protocol over ``dataset``.

    ``model`` is the port's :class:`~raft_tpu_torch.models.RAFT`, already
    on its device; it runs under ``torch.inference_mode()``. Returns
    ``{"epe", "1px", "3px", "5px", "f1", "fps"}``, pixel-weighted like the
    reference (the EPE list is concatenated per pixel over all pairs).

    ``use_valid_mask`` defaults to ``mode != "sintel"``: the protocol
    averages over all pixels of Sintel's dense ground truth. Without any
    ground truth every accuracy metric is NaN, never a fabricated score.
    ``fps_pairs``: how many same-shape pairs :func:`chained_pairs_per_s`
    times after the loop (0 disables; fps is NaN below 2 pairs).
    """
    if use_valid_mask is None:
        use_valid_mask = mode != "sintel"
    device = _device(model)
    model.eval()
    epes, mags, fps_batch = [], [], []
    stream = prefetch((_prepare(dataset[i], mode) for i in range(len(dataset))), depth=2)
    for batch, padder in stream:
        with torch.inference_mode():
            flow = model(
                _nchw(batch["image1"][None], device),
                _nchw(batch["image2"][None], device),
                num_flow_updates=num_flow_updates,
                emit_all=False,
            )
            flow = flow.permute(0, 2, 3, 1).float().cpu().numpy()
        if len(fps_batch) < fps_pairs and (
            not fps_batch or batch["image1"].shape == fps_batch[0][0].shape
        ):
            fps_batch.append((batch["image1"], batch["image2"]))
        flow = padder.unpad(flow)[0]
        gt = batch["flow"]
        if gt is None:
            continue
        epe = np.linalg.norm(flow - gt, axis=-1)
        mag = np.linalg.norm(gt, axis=-1)
        valid = batch["valid"]
        if use_valid_mask and valid is not None:
            epe, mag = epe[valid], mag[valid]
        epes.append(epe.reshape(-1))
        mags.append(mag.reshape(-1))

    epe_all = np.concatenate(epes) if epes else np.full(1, np.nan)
    mag_all = np.concatenate(mags) if mags else np.full(1, np.nan)
    fps = float("nan")
    if len(fps_batch) >= 2:
        fps = chained_pairs_per_s(
            model, [p[0] for p in fps_batch], [p[1] for p in fps_batch], num_flow_updates=num_flow_updates
        )
    # KITTI Fl-all: share of pixels with EPE > 3 px and > 5% of |gt|
    f1 = np.mean((epe_all > 3.0) & (epe_all > 0.05 * mag_all)) if epes else float("nan")
    return {
        "epe": float(np.mean(epe_all)),
        "1px": float(np.mean(epe_all < 1.0)) if epes else float("nan"),
        "3px": float(np.mean(epe_all < 3.0)) if epes else float("nan"),
        "5px": float(np.mean(epe_all < 5.0)) if epes else float("nan"),
        "f1": float(f1),
        "fps": float(fps),
    }


def validate_sintel(
    model, root: str, *, num_flow_updates: int = 32, dstypes=("clean", "final"), fps_pairs: int = 64
) -> Dict[str, Dict[str, float]]:
    """Full Sintel-train validation (both passes), reference protocol."""
    return {
        dstype: validate(
            model,
            Sintel(root, split="training", dstype=dstype),
            num_flow_updates=num_flow_updates,
            mode="sintel",
            fps_pairs=fps_pairs,
        )
        for dstype in dstypes
    }
