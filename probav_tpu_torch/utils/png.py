"""Grayscale PNG codec in the standard library (zlib + struct).

Replaces ``probav_tpu/utils/io.py``'s imageio-based ``write_png`` for the
submission format (uint16 grayscale), and reads that format back from any
PNG writer: ``read_png`` undoes the five scanline filters of the PNG
specification (imageio, which the JAX package writes with, picks one per
row, Paeth for most rows of a smooth scene).
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


# Bytes per complete pixel of 16-bit grayscale: the filters' left offset.
_BPP = 2


def _unfilter_rows(kinds, raw):
    """Rows of filter types 0-2 one at a time, each a few whole-row numpy
    operations: None, Sub (a running sum mod 256 along each byte column)
    and Up (the reconstructed row above)."""
    out = np.empty_like(raw)
    prev = np.zeros(raw.shape[1], np.uint8)
    for y, (kind, line) in enumerate(zip(kinds.tolist(), raw)):
        if kind == 0:
            out[y] = line
        elif kind == 1:
            out[y] = np.add.accumulate(line.reshape(-1, _BPP), axis=0,
                                       dtype=np.uint8).reshape(-1)
        else:
            out[y] = line + prev
        prev = out[y]
    return out


def _unfilter_wavefront(kinds, raw):
    """Rows of any filter types 0-4, by anti-diagonals of pixels.

    Average and Paeth predict a byte from its reconstructed left neighbour
    a, the byte above b and the upper left c, so neither a row nor a
    column can be decoded at once.  But pixel (y, x) needs only pixels of
    the diagonals y + x - 1 and y + x - 2, so each diagonal is one set of
    vector operations: H + W - 1 steps instead of H * W.  The pixels are
    stored skewed, ``s[y + x + 2, y + 1] = out[y, x]``, so that every
    diagonal is contiguous; ``s[0]``, ``s[1]`` and ``s[:, 0]``, like the
    entries no pixel maps to, stay zero, which is what the specification
    takes for neighbours outside the image."""
    h, w = raw.shape[0], raw.shape[1] // _BPP
    yy, xx = np.mgrid[0:h, 0:w]
    filt = np.zeros((h + w - 1, h, _BPP), np.int16)
    filt[yy + xx, yy] = raw.reshape(h, w, _BPP)
    s = np.zeros((h + w + 1, h + 1, _BPP), np.int16)
    rows = {t: np.broadcast_to((kinds == t)[:, None], (h, _BPP))
            for t in range(4) if (kinds == t).any()}
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h, d + 1)
        a, b, c = s[d + 1, lo + 1:hi + 1], s[d + 1, lo:hi], s[d, lo:hi]
        pa, pb = np.abs(b - c), np.abs(a - c)              # |p - a|, |p - b|
        pc = np.abs(a + b - 2 * c)                         # |p - c|
        pred = np.where(pb <= pc, b, c)                    # 4 Paeth
        np.copyto(pred, a, where=(pa <= pb) & (pa <= pc))
        avg = (a + b) >> 1 if 3 in rows else None
        for t, rows_t in rows.items():                 # None, Sub, Up, Average
            np.copyto(pred, (0, a, b, avg)[t], where=rows_t[lo:hi])
        np.bitwise_and(filt[d, lo:hi] + pred, 0xFF,
                       out=s[d + 2, lo + 1:hi + 1])
    return s[yy + xx + 2, yy + 1].astype(np.uint8).reshape(h, -1)


def _unfilter(rows):
    """[h, 1 + stride] filtered scanlines -> [h, stride] raw bytes.  The
    row above the first is zeros; the sums wrap mod 256, as the
    specification's do."""
    kinds, raw = rows[:, 0], rows[:, 1:]
    bad = np.flatnonzero(kinds > 4)
    if bad.size:
        raise ValueError(f"scanline {bad[0]}: filter type {kinds[bad[0]]} "
                         f"is not supported (the PNG filters are 0-4)")
    if (kinds >= 3).any():
        return _unfilter_wavefront(kinds, raw)
    return _unfilter_rows(kinds, raw)


def read_png(path: str) -> np.ndarray:
    """Read a 16-bit grayscale, non-interlaced PNG as uint16 [H, W],
    whatever filter each scanline was written with."""
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
                         f"supported (depth {depth}, color type {color}, "
                         f"interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + _BPP * w):
        raise ValueError(f"{path}: {raw.size} bytes of scanlines for "
                         f"{h} rows of {w} pixels")
    rows = _unfilter(raw.reshape(h, 1 + _BPP * w))
    return rows.view(">u2").astype(np.uint16)
