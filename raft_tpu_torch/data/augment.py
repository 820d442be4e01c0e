"""RAFT training augmentation (host-side numpy, deterministic by seed).

Ported from the JAX package's ``raft_tpu/data/augment.py``, rng draw for
rng draw (the same seed gives the same crops, flips, scales, eraser boxes
and jitter factors, in the same order): photometric jitter (brightness,
contrast, saturation, hue, in a permuted order; asymmetric across the two
frames with probability ``asymmetric_prob``), an occlusion eraser on frame
2, a random log-uniform scale with independent x/y stretch (forced when
the frame is smaller than the crop), flips and a random crop. ``sparse``
mode (KITTI, HD1K) scatters valid flow points into the rescaled grid.

The JAX augmentor calls OpenCV for two things, done here in numpy:
:func:`resize_linear` is ``cv2.resize(..., interpolation=INTER_LINEAR)``
on float32 (output size ``round(w * fx)``, sample position ``(x + 0.5) /
fx - 0.5``; columns clamped to the edge with their weight, rows clamped
with theirs kept, as OpenCV does), and :func:`rgb_to_hsv` /
:func:`hsv_to_rgb` are ``cvtColor``'s float32 RGB<->HSV (H in degrees).
Both follow OpenCV's formulas in float32; they differ from it by float
rounding only (OpenCV's vectorized loops may fuse or reorder).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

__all__ = ["AugmentConfig", "FlowAugmentor", "resize_linear", "rgb_to_hsv", "hsv_to_rgb"]

Sample = Dict[str, np.ndarray]
_EPS = np.float32(np.finfo(np.float32).eps)


def _taps(n_src: int, n_dst: int, inv_scale: float):
    """First source index and the fp32 weight of the second, per output
    position: ``float32((d + 0.5) * inv_scale - 0.5)`` split at its floor."""
    pos = ((np.arange(n_dst) + 0.5) * inv_scale - 0.5).astype(np.float32)
    first = np.floor(pos).astype(np.int64)
    return first, (pos - first.astype(np.float32)).astype(np.float32)


def resize_linear(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """Bilinear resize of a float32 ``(H, W[, C])`` array by ``(fx, fy)``
    to ``(round(H * fy), round(W * fx))``: columns first, then rows."""
    h, w = img.shape[:2]
    nw, nh = int(round(w * fx)), int(round(h * fy))
    x0, ax = _taps(w, nw, 1.0 / fx)
    left, right = x0 < 0, x0 >= w - 1
    ax[left | right] = 0.0
    x0 = np.clip(x0, 0, w - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    shape = (-1,) + (1,) * (img.ndim - 2)
    cols = img[:, x0] * (np.float32(1.0) - ax).reshape(shape) + img[:, x1] * ax.reshape(shape)
    y0, ay = _taps(h, nh, 1.0 / fy)
    r0, r1 = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
    shape = (-1,) + (1,) * (img.ndim - 1)
    return (cols[r0] * (np.float32(1.0) - ay).reshape(shape) + cols[r1] * ay.reshape(shape)).astype(np.float32)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """float32 RGB in [0, 1] -> HSV with H in degrees [0, 360), S and V
    in [0, 1] (OpenCV's float formula)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _EPS)
    k = (60.0 / (diff + _EPS).astype(np.float64)).astype(np.float32)
    h = np.where(v == r, (g - b) * k, np.where(v == g, (b - r) * k + np.float32(120.0),
                                                (r - g) * k + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


# OpenCV's sector table: for each sixth of the hue circle, which of
# (v, v(1-s), v(1-sf), v(1-s(1-f))) is blue, green and red
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """The inverse of :func:`rgb_to_hsv` (OpenCV's float formula)."""
    h, s, v = hsv[..., 0] * np.float32(6.0 / 360.0), hsv[..., 1], hsv[..., 2]
    h = np.where(h < 0, h + np.float32(6.0) * np.ceil(-h / np.float32(6.0)), h)
    while (h >= 6).any():
        h = np.where(h >= 6, h - np.float32(6.0), h)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(np.float32)
    bad = (sector < 0) | (sector >= 6)
    sector, h = np.where(bad, 0, sector), np.where(bad, np.float32(0.0), h)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))], axis=-1)
    idx = _SECTORS[sector]  # (..., 3): blue, green, red
    bgr = np.take_along_axis(tab, idx, axis=-1)
    rgb = bgr[..., ::-1]
    return np.where((s == 0)[..., None], v[..., None], rgb).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    crop_size: Tuple[int, int] = (368, 496)  # (H, W)
    # photometric
    brightness: float = 0.4
    contrast: float = 0.4
    saturation: float = 0.4
    hue: float = 0.5 / 3.14
    asymmetric_prob: float = 0.2
    # eraser
    eraser_prob: float = 0.5
    eraser_max_boxes: int = 3
    # spatial
    min_scale: float = -0.2  # log2
    max_scale: float = 0.5
    max_stretch: float = 0.2
    stretch_prob: float = 0.8
    spatial_prob: float = 0.8
    h_flip_prob: float = 0.5
    v_flip_prob: float = 0.1
    sparse: bool = False


def _adjust_brightness(img, f):
    return img * f


def _adjust_contrast(img, f):
    mean = img.mean(axis=(0, 1), keepdims=True).mean()
    return (img - mean) * f + mean


def _adjust_saturation(img, f):
    gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
    return (img - gray[..., None]) * f + gray[..., None]


def _adjust_hue(img, shift):
    """Rotate hue by ``shift`` (fraction of a full turn) via HSV."""
    hsv = rgb_to_hsv(img.clip(0, 1))
    hsv[..., 0] = (hsv[..., 0] + shift * 360.0) % 360.0
    return hsv_to_rgb(hsv)


class FlowAugmentor:
    """Callable ``(rng, sample) -> sample`` with images uint8 -> float32 [0,255]
    passthrough (outputs stay uint8-range float32; normalization to [-1,1]
    belongs to the batching layer)."""

    def __init__(self, config: AugmentConfig = AugmentConfig()):
        self.cfg = config

    # -- photometric ---------------------------------------------------------

    def _color_jitter_one(self, rng, img):
        cfg = self.cfg
        img = img.astype(np.float32) / 255.0
        # torchvision ColorJitter: random order, each factor uniform.
        ops = [
            lambda x: _adjust_brightness(
                x, rng.uniform(1 - cfg.brightness, 1 + cfg.brightness)
            ),
            lambda x: _adjust_contrast(
                x, rng.uniform(1 - cfg.contrast, 1 + cfg.contrast)
            ),
            lambda x: _adjust_saturation(
                x, rng.uniform(1 - cfg.saturation, 1 + cfg.saturation)
            ),
            lambda x: _adjust_hue(x, rng.uniform(-cfg.hue, cfg.hue)),
        ]
        for i in rng.permutation(len(ops)):
            img = ops[i](img)
        return np.clip(img * 255.0, 0, 255).astype(np.float32)

    def _photometric(self, rng, img1, img2):
        if rng.random() < self.cfg.asymmetric_prob:
            return self._color_jitter_one(rng, img1), self._color_jitter_one(
                rng, img2
            )
        # symmetric: same params -> jitter the stacked pair
        stacked = np.concatenate([img1, img2], axis=0)
        out = self._color_jitter_one(rng, stacked)
        return out[: img1.shape[0]], out[img1.shape[0] :]

    def _eraser(self, rng, img2):
        cfg = self.cfg
        if rng.random() >= cfg.eraser_prob:
            return img2
        h, w = img2.shape[:2]
        img2 = img2.copy()
        mean = img2.reshape(-1, 3).mean(axis=0)
        for _ in range(rng.integers(1, cfg.eraser_max_boxes + 1)):
            x0 = int(rng.integers(0, w))
            y0 = int(rng.integers(0, h))
            dx = int(rng.integers(50, 100))
            dy = int(rng.integers(50, 100))
            img2[y0 : y0 + dy, x0 : x0 + dx] = mean
        return img2

    # -- spatial -------------------------------------------------------------

    def _resize_dense(self, img1, img2, flow, fx, fy):
        img1 = resize_linear(img1, fx, fy)
        img2 = resize_linear(img2, fx, fy)
        flow = resize_linear(flow, fx, fy)
        flow = flow * [fx, fy]
        return img1, img2, flow.astype(np.float32)

    def _resize_sparse(self, flow, valid, fx, fy, new_hw):
        """Scatter valid flow points into the rescaled grid."""
        h, w = flow.shape[:2]
        nh, nw = new_hw
        ys, xs = np.nonzero(valid)
        fl = flow[ys, xs] * [fx, fy]
        nx = np.round(xs * fx).astype(np.int64)
        ny = np.round(ys * fy).astype(np.int64)
        keep = (nx >= 0) & (nx < nw) & (ny >= 0) & (ny < nh)
        out_flow = np.zeros((nh, nw, 2), np.float32)
        out_valid = np.zeros((nh, nw), bool)
        out_flow[ny[keep], nx[keep]] = fl[keep]
        out_valid[ny[keep], nx[keep]] = True
        return out_flow, out_valid

    def _spatial(self, rng, img1, img2, flow, valid, sparse):
        cfg = self.cfg
        h, w = img1.shape[:2]
        ch, cw = cfg.crop_size
        # minimum zoom that still covers the crop (+8px of slack)
        min_scale = max((ch + 8) / h, (cw + 8) / w)

        scale = 2.0 ** rng.uniform(cfg.min_scale, cfg.max_scale)
        fx = fy = scale
        if rng.random() < cfg.stretch_prob:
            fx *= 2.0 ** rng.uniform(-cfg.max_stretch, cfg.max_stretch)
            fy *= 2.0 ** rng.uniform(-cfg.max_stretch, cfg.max_stretch)
        fx, fy = max(fx, min_scale), max(fy, min_scale)

        # The resize is forced (regardless of spatial_prob) whenever the source
        # frame is smaller than the crop: otherwise the crop below would draw
        # from a negative range. min_scale above guarantees the resized frame
        # covers crop_size (+8 px slack).
        if h < ch or w < cw or rng.random() < cfg.spatial_prob:
            if sparse:
                img1 = resize_linear(img1, fx, fy)
                img2 = resize_linear(img2, fx, fy)
                flow, valid = self._resize_sparse(
                    flow, valid, fx, fy, img1.shape[:2]
                )
            else:
                img1, img2, flow = self._resize_dense(img1, img2, flow, fx, fy)
                valid = np.ones(img1.shape[:2], bool)

        if rng.random() < cfg.h_flip_prob:
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]
        if not sparse and rng.random() < cfg.v_flip_prob:
            img1, img2 = img1[::-1], img2[::-1]
            flow = flow[::-1] * [1.0, -1.0]
            valid = valid[::-1]

        h, w = img1.shape[:2]
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        sl = np.s_[y0 : y0 + ch, x0 : x0 + cw]
        return (
            np.ascontiguousarray(img1[sl]),
            np.ascontiguousarray(img2[sl]),
            np.ascontiguousarray(flow[sl]).astype(np.float32),
            np.ascontiguousarray(valid[sl]),
        )

    # -- entry ---------------------------------------------------------------

    def __call__(self, rng: np.random.Generator, sample: Sample) -> Sample:
        img1 = sample["image1"].astype(np.float32)
        img2 = sample["image2"].astype(np.float32)
        flow = sample["flow"].astype(np.float32)
        valid = sample.get("valid")
        valid = (
            np.ones(img1.shape[:2], bool) if valid is None else valid.astype(bool)
        )
        # Mixed-stage (S/K/H) batches blend dense and sparse-GT datasets, so
        # the sample itself can carry the sparse marker (set by Kitti/HD1K,
        # see datasets.FlowDataset.sparse); the config value is the fallback
        # for single-dataset stages.
        sparse = bool(sample.get("sparse", self.cfg.sparse))

        img1, img2 = self._photometric(rng, img1, img2)
        img2 = self._eraser(rng, img2)
        img1, img2, flow, valid = self._spatial(rng, img1, img2, flow, valid, sparse)
        return {"image1": img1, "image2": img2, "flow": flow, "valid": valid}
