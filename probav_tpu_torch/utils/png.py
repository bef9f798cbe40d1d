"""Grayscale PNG codec in the standard library (zlib + struct).

Replaces ``probav_tpu/utils/io.py``'s imageio-based ``write_png`` for the
submission format (uint16 grayscale), and reads that format back.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data +
            struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a 2D array as a uint16 grayscale PNG, clipped to [0, 65535]
    first (the resolver clips to 2**16, which would wrap to 0)."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError(f"expected a 2D image, got shape {img.shape}")
    a = np.clip(img, 0, 65535).astype(">u2")
    h, w = a.shape
    raw = np.empty((h, 1 + 2 * w), np.uint8)
    raw[:, 0] = 0                                 # filter type None
    raw[:, 1:] = a.view(np.uint8).reshape(h, 2 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr) +
                _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) +
                _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read back what ``write_png`` writes: a 16-bit grayscale,
    non-interlaced PNG whose scanlines are all unfiltered (type 0)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    if color != 0 or depth != 16 or interlace != 0:
        raise ValueError(f"{path}: only non-interlaced 16-bit grayscale is "
                         f"supported (depth {depth}, color type {color})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + 2 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered scanlines (type "
                         f"{int(rows[:, 0].max())}) are not supported")
    return rows[:, 1:].copy().view(">u2").astype(np.uint16)
