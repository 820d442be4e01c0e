"""Flow-format and image I/O: Middlebury ``.flo``, KITTI 16-bit ``.png``,
``.pfm``, 8-bit PNG and PPM images.

Ported from the JAX package's ``raft_tpu/data/io.py``; readers return
numpy arrays. PNG is decoded here with ``zlib`` and numpy (IHDR, the
concatenated IDAT stream and the five row filters; 8- and 16-bit samples)
and KITTI flow PNGs are written the same way (filter 0), and PPM/PGM
(FlyingChairs' images) are read from their header, so the port needs
neither cv2 nor PIL.
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
    "encode_png",
    "read_flo",
    "write_flo",
    "read_flow_png",
    "write_flow_png",
    "read_ppm",
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
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


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
    """An 8- or 16-bit, non-interlaced grayscale, RGB or RGBA PNG ->
    ``(H, W, channels)`` uint8 or uint16 (16-bit samples are big-endian in
    the file). Palette, gray+alpha, other depths and interlaced files
    raise ``ValueError``, as does a corrupt stream."""
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
    if depth not in (8, 16) or ctype not in _PNG_CHANNELS:
        raise ValueError(
            f"png: only 8- and 16-bit gray, RGB and RGBA are supported (depth {depth}, colour type {ctype})"
        )
    channels = _PNG_CHANNELS[ctype]
    bpp = channels * depth // 8  # bytes per pixel, the filters' stride
    stride = width * bpp
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"png: corrupt image data ({e})") from e
    if raw.size < height * (stride + 1):
        raise ValueError("png: truncated image data")
    rows = raw[: height * (stride + 1)].reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(height, width, channels)
    return out.reshape(height, width, channels)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(img: np.ndarray) -> bytes:
    """``(H, W, 3)`` uint8 or uint16 -> an RGB PNG of that depth, every row
    with filter 0 (None), one IDAT chunk."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"png: expected (H, W, 3) uint8 or uint16, got {img.shape} {img.dtype}")
    h, w, _ = img.shape
    depth = 8 * img.dtype.itemsize
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes())) + _png_chunk(b"IEND", b""))


def read_flow_png(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI flow png -> (``(H, W, 2)`` float32 flow, ``(H, W)`` bool valid
    mask). Encoding: 16-bit RGB, flow = (u16 - 2^15) / 64, the third
    channel > 0 marks valid pixels. A missing file raises
    ``FileNotFoundError``, a corrupt one ``ValueError``."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.dtype != np.uint16 or img.shape[2] < 3:
        raise ValueError(f"{path}: a flow png is 16-bit RGB, got {img.dtype} with {img.shape[2]} channels")
    img = img[:, :, :3].astype(np.float32)
    return (img[:, :, :2] - 2**15) / 64.0, img[:, :, 2] > 0


def write_flow_png(path: str, flow: np.ndarray, valid: Optional[np.ndarray] = None) -> None:
    """The inverse of :func:`read_flow_png`; ``valid`` None marks every
    pixel valid."""
    h, w, _ = flow.shape
    rgb = np.zeros((h, w, 3), np.uint16)
    rgb[:, :, 0] = np.clip(flow[:, :, 0] * 64.0 + 2**15, 0, 65535)
    rgb[:, :, 1] = np.clip(flow[:, :, 1] * 64.0 + 2**15, 0, 65535)
    rgb[:, :, 2] = (np.ones((h, w)) if valid is None else valid).astype(np.uint16)
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def read_ppm(data: bytes) -> np.ndarray:
    """A binary PPM (``P6``) or PGM (``P5``) with 8-bit samples ->
    ``(H, W, 3)`` or ``(H, W, 1)`` uint8. Header comments are skipped."""
    magic = data[:2]
    if magic not in (b"P6", b"P5"):
        raise ValueError("ppm: not a binary PPM/PGM file")
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos : pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("ppm: truncated header")
        fields.append(int(data[start:pos]))
    width, height, maxval = fields
    if not 0 < maxval < 256:
        raise ValueError(f"ppm: only 8-bit samples are supported (maxval {maxval})")
    channels = 3 if magic == b"P6" else 1
    count = height * width * channels
    if len(data) < pos + 1 + count:  # one whitespace byte ends the header
        raise ValueError("ppm: truncated image data")
    return np.frombuffer(data, np.uint8, count=count, offset=pos + 1).reshape(height, width, channels)


def read_image(path: str) -> np.ndarray:
    """Image file (PNG, or PPM/PGM as FlyingChairs ships) -> ``(H, W, 3)``
    uint8: grayscale broadcast to 3 channels, alpha dropped (the JAX
    package's contract)."""
    with open(path, "rb") as f:
        data = f.read()
    img = read_ppm(data) if data[:2] in (b"P6", b"P5") else decode_png(data)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: images are read as 8-bit, got {img.dtype}")
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
        return read_flow_png(path)
    raise ValueError(f"unsupported flow format: {path}")
