"""File I/O: Mitsuba ``.vol`` volumes, PNG images, run metadata.

Counterpart of the JAX package's ``utils/io.py`` (numpy only, so the port
keeps its own copy): the ``.vol`` binary format (header ``VOL`` v3, float32
grid, x-fastest layout), so that checkpoints of the two packages are
interchangeable, a minimal PNG codec, and the ``metadata.json`` dump.  The
EXR codec is not ported.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

__all__ = ["read_vol", "write_vol", "write_png", "read_png", "dump_metadata", "tonemap"]


def read_vol(path: str) -> np.ndarray:
    """Read a Mitsuba .vol file → (Z, Y, X, C) float32 array."""
    with open(path, "rb") as f:
        magic = f.read(3)
        if magic != b"VOL":
            raise ValueError(f"{path}: not a .vol file")
        version = f.read(1)[0]
        if version != 3:
            raise ValueError(f"{path}: unsupported .vol version {version}")
        (dtype,) = struct.unpack("<i", f.read(4))
        if dtype != 1:
            raise ValueError(f"{path}: only float32 volumes supported (type {dtype})")
        xres, yres, zres = struct.unpack("<3i", f.read(12))
        (channels,) = struct.unpack("<i", f.read(4))
        _bbox = struct.unpack("<6f", f.read(24))
        data = np.frombuffer(f.read(4 * xres * yres * zres * channels), np.float32)
    return data.reshape(zres, yres, xres, channels).copy()


def write_vol(path: str, data, bbox_min=(0.0, 0.0, 0.0), bbox_max=(1.0, 1.0, 1.0)):
    """Write a (Z, Y, X[, C]) array as a Mitsuba .vol (v3, float32)."""
    data = np.asarray(data, np.float32)
    if data.ndim == 3:
        data = data[..., None]
    zres, yres, xres, channels = data.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"VOL")
        f.write(bytes([3]))
        f.write(struct.pack("<i", 1))
        f.write(struct.pack("<3i", xres, yres, zres))
        f.write(struct.pack("<i", channels))
        f.write(struct.pack("<6f", *bbox_min, *bbox_max))
        f.write(data.tobytes())


def tonemap(img: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """HDR → LDR uint8 (simple gamma; the reference uses sRGB via mi.Bitmap)."""
    img = np.asarray(img, np.float32)
    img = np.clip(img, 0.0, 1.0) ** (1.0 / gamma)
    return (img * 255.0 + 0.5).astype(np.uint8)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    import zlib

    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, img: np.ndarray):
    """Minimal RGB(A) PNG writer (no external imaging deps are guaranteed).

    ``img``: (H, W, 3|4) uint8 or float (floats are tonemapped)."""
    import zlib

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = tonemap(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w, c = img.shape
    if c not in (3, 4):
        raise ValueError(f"{path}: a PNG takes 3 or 4 channels, got {c}")
    color_type = 2 if c == 3 else 6
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for files written by :func:`write_png` (8-bit,
    non-interlaced, filter 0/1/2/3/4)."""
    import zlib

    with open(path, "rb") as f:
        sig = f.read(8)
        if sig != b"\x89PNG\r\n\x1a\n":
            raise ValueError(f"{path}: not a PNG file")
        chunks = {}
        idat = b""
        while True:
            (ln,) = struct.unpack(">I", f.read(4))
            tag = f.read(4)
            payload = f.read(ln)
            f.read(4)
            if tag == b"IHDR":
                chunks["ihdr"] = struct.unpack(">IIBBBBB", payload)
            elif tag == b"IDAT":
                idat += payload
            elif tag == b"IEND":
                break
    w, h, depth, color_type, _, _, interlace = chunks["ihdr"]
    if depth != 8 or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNGs are read")
    c = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for row in range(h):
        ft = raw[pos]
        line = np.frombuffer(raw[pos + 1 : pos + 1 + stride], np.uint8).astype(np.int32)
        pos += 1 + stride
        cur = np.zeros(stride, np.int32)
        if ft == 0:
            cur = line
        elif ft == 1:
            for i in range(stride):
                cur[i] = (line[i] + (cur[i - c] if i >= c else 0)) & 0xFF
        elif ft == 2:
            cur = (line + prev) & 0xFF
        elif ft == 3:
            for i in range(stride):
                left = cur[i - c] if i >= c else 0
                cur[i] = (line[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:
            for i in range(stride):
                a = cur[i - c] if i >= c else 0
                b = prev[i]
                cc = prev[i - c] if i >= c else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[i] = (line[i] + pr) & 0xFF
        out[row] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, c)


def dump_metadata(config, opt_config, extra=None, fn="metadata.json"):
    """Config + timing dump (reference util.py:152-186)."""
    import dataclasses
    import sys

    def conv(o):
        if dataclasses.is_dataclass(o):
            return {k: conv(v) for k, v in dataclasses.asdict(o).items()}
        if isinstance(o, (np.ndarray,)):
            return o.tolist()
        if isinstance(o, (tuple, list)):
            return [conv(x) for x in o]
        if callable(o):
            return getattr(o, "__name__", str(o))
        return o

    d = {"config": conv(config), "opt_config": conv(opt_config), "cmd": " ".join(sys.argv)}
    if extra:
        d.update(extra)
    os.makedirs(os.path.dirname(os.path.abspath(fn)), exist_ok=True)
    with open(fn, "wt") as f:
        json.dump(d, f, indent=4, default=str)
