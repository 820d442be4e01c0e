"""Flow-format and image I/O: Middlebury ``.flo``, ``.pfm``, 8-bit PNG.

Ported from the JAX package's ``raft_tpu/data/io.py``; readers return
numpy arrays. :func:`read_image` decodes PNG itself with ``zlib`` and
numpy (IHDR, the concatenated IDAT stream and the five row filters), so
the port needs no image library. KITTI's 16-bit flow PNGs wait until that
dataset is ported.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "decode_png",
    "read_flo",
    "write_flo",
    "read_pfm",
    "write_pfm",
    "read_image",
    "read_flow",
]

_FLO_MAGIC = 202021.25
# Reject .flo headers claiming more pixels than any real flow map: a
# corrupt (w, h) would otherwise demand a multi-GB read before the
# truncation check can fire. 64MP is ~8x the largest dataset frame.
_FLO_MAX_PIXELS = 64 * 1024 * 1024


def read_flo(path: str) -> np.ndarray:
    """Middlebury ``.flo`` -> ``(H, W, 2)`` float32 (little-endian)."""
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) < 12:
            raise ValueError(f"{path}: truncated .flo header")
        magic = np.frombuffer(header, "<f4", count=1)[0]
        if magic != _FLO_MAGIC:
            raise ValueError(f"{path}: bad .flo magic {magic!r}")
        w, h = struct.unpack("<ii", header[4:12])
        if w <= 0 or h <= 0 or w * h > _FLO_MAX_PIXELS:
            raise ValueError(f"{path}: implausible .flo dimensions {w}x{h} (corrupt header)")
        data = np.frombuffer(f.read(h * w * 2 * 4), "<f4")
        if data.size != h * w * 2:
            raise ValueError(f"{path}: truncated .flo ({data.size} values)")
    return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    flow = np.asarray(flow, "<f4")
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError("flow must be (H, W, 2)")
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        f.write(np.float32(_FLO_MAGIC).tobytes())
        f.write(struct.pack("<ii", w, h))
        f.write(flow.tobytes())


def read_pfm(path: str) -> np.ndarray:
    """PFM (FlyingThings3D disparity/flow container) -> float32 array."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        color = header == b"PF"
        dims = f.readline()
        while dims.startswith(b"#"):
            dims = f.readline()
        m = re.match(rb"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dims")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
        shape = (h, w, 3) if color else (h, w)
        data = data[: int(np.prod(shape))].reshape(shape)
    return np.flipud(data).astype(np.float32).copy()  # PFM rows are bottom-up


def write_pfm(path: str, data: np.ndarray) -> None:
    """float32 array -> PFM (``PF`` for 3-channel color, ``Pf`` for 2-D);
    2-channel flow gets a zero third channel, rows bottom-up with a
    negative (little-endian) scale, mirroring :func:`read_pfm`."""
    data = np.asarray(data, np.float32)
    if data.ndim == 3 and data.shape[2] == 1:
        data = data[:, :, 0]
    color = data.ndim == 3
    if color and data.shape[2] == 2:
        data = np.concatenate([data, np.zeros_like(data[:, :, :1])], axis=2)
    if color and data.shape[2] != 3:
        raise ValueError(f"PFM supports 1/2/3 channels, got {data.shape}")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.flipud(data).astype("<f4").tobytes())


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel (8-bit)


def _unfilter_row(ftype: int, raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's filter undone (PNG spec section 9), uint8 arithmetic
    modulo 256; ``prev`` is the previous unfiltered row (zeros for the
    first)."""
    if ftype == 0:
        return raw
    if ftype == 2:  # Up
        return raw + prev
    if ftype == 1:  # Sub: a running sum per channel
        return np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if ftype not in (3, 4):
        raise ValueError(f"png: unknown row filter {ftype}")
    # Average and Paeth depend on the byte bpp to the left: sequential
    out = bytearray(raw.tobytes())
    up = prev.tobytes()
    if ftype == 3:
        for i in range(len(out)):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    else:
        for i in range(len(out)):
            if i >= bpp:
                a, c = out[i - bpp], up[i - bpp]
            else:
                a = c = 0
            b = up[i]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced grayscale, RGB or RGBA PNG ->
    ``(H, W, channels)`` uint8. Palette, gray+alpha, 16-bit and interlaced
    files raise."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("png: bad signature")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError("png: truncated chunk")
        pos += 12 + length  # length, type, body, CRC
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("png: missing IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("png: interlaced files are not supported")
    if ctype == 3:
        raise ValueError("png: palette files are not supported")
    if depth != 8 or ctype not in _PNG_CHANNELS:
        raise ValueError(f"png: only 8-bit gray, RGB and RGBA are supported (depth {depth}, colour type {ctype})")
    bpp = _PNG_CHANNELS[ctype]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError("png: truncated image data")
    rows = raw[: height * (stride + 1)].reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    return out.reshape(height, width, bpp)


def read_image(path: str) -> np.ndarray:
    """Image file -> ``(H, W, 3)`` uint8: grayscale broadcast to 3
    channels, alpha dropped (the JAX package's contract)."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def read_flow(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Dispatch by extension -> (flow, valid-or-None)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flo":
        return read_flo(path), None
    if ext == ".pfm":
        pfm = read_pfm(path)
        return (pfm[:, :, :2].copy() if pfm.ndim == 3 else pfm), None
    if ext == ".png":
        raise NotImplementedError(
            f"{path}: 16-bit KITTI flow PNGs wait until the KITTI dataset is ported"
        )
    raise ValueError(f"unsupported flow format: {path}")
