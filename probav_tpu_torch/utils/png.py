"""Grayscale PNG codec in the standard library (zlib + struct).

Replaces ``probav_tpu/utils/io.py``'s imageio-based PNG codec.
``write_png`` writes the submission format (uint16 grayscale).
``read_png`` reads every non-interlaced grayscale PNG, at bit depths 1, 2,
4, 8 and 16, from any PNG writer, with the values and dtype that imageio
gives: the preprocessing stage reads the dataset's frames and masks with
it, the scorer the submissions.  It undoes the five scanline filters of
the PNG specification (imageio, which the JAX package writes with, picks
one per row, Paeth for most rows of a smooth scene).
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


# The grayscale bit depths of the specification.  Below 8, imageio (through
# Pillow) gives depth 1 as bool and scales depths 2 and 4 to 0-255.
DEPTHS = (1, 2, 4, 8, 16)


def _unfilter_rows(kinds, raw, bpp):
    """Rows of filter types 0-2 one at a time, each a few whole-row numpy
    operations: None, Sub (a running sum mod 256 along each byte column)
    and Up (the reconstructed row above)."""
    out = np.empty_like(raw)
    prev = np.zeros(raw.shape[1], np.uint8)
    for y, (kind, line) in enumerate(zip(kinds.tolist(), raw)):
        if kind == 0:
            out[y] = line
        elif kind == 1:
            out[y] = np.add.accumulate(line.reshape(-1, bpp), axis=0,
                                       dtype=np.uint8).reshape(-1)
        else:
            out[y] = line + prev
        prev = out[y]
    return out


def _unfilter_wavefront(kinds, raw, bpp):
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
    h, w = raw.shape[0], raw.shape[1] // bpp
    yy, xx = np.mgrid[0:h, 0:w]
    filt = np.zeros((h + w - 1, h, bpp), np.int16)
    filt[yy + xx, yy] = raw.reshape(h, w, bpp)
    s = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    rows = {t: np.broadcast_to((kinds == t)[:, None], (h, bpp))
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


def _unfilter(rows, bpp):
    """[h, 1 + stride] filtered scanlines -> [h, stride] raw bytes, where
    the filters' left neighbour lies bpp bytes back (one byte below 16
    bits).  The row above the first is zeros; the sums wrap mod 256, as
    the specification's do."""
    kinds, raw = rows[:, 0], rows[:, 1:]
    bad = np.flatnonzero(kinds > 4)
    if bad.size:
        raise ValueError(f"scanline {bad[0]}: filter type {kinds[bad[0]]} "
                         f"is not supported (the PNG filters are 0-4)")
    if (kinds >= 3).any():
        return _unfilter_wavefront(kinds, raw, bpp)
    return _unfilter_rows(kinds, raw, bpp)


def read_png(path: str) -> np.ndarray:
    """Read a non-interlaced grayscale PNG as [H, W], whatever filter each
    scanline was written with: uint16 at 16 bits, uint8 at 8, uint8 scaled
    to 0-255 at 4 and 2 (times 17 and 85), bool at 1, as imageio reads
    them."""
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
        elif kind == b"tRNS":
            raise ValueError(f"{path}: a transparent colour (tRNS) is not "
                             f"supported")
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    if color != 0 or depth not in DEPTHS or interlace != 0:
        raise ValueError(f"{path}: only non-interlaced grayscale at depths "
                         f"{DEPTHS} is supported (depth {depth}, color type "
                         f"{color}, interlace {interlace})")
    stride = (w * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + stride):
        raise ValueError(f"{path}: {raw.size} bytes of scanlines for "
                         f"{h} rows of {w} pixels at {depth} bits")
    rows = _unfilter(raw.reshape(h, 1 + stride), max(1, depth // 8))
    if depth == 16:
        return rows.view(">u2").astype(np.uint16)
    if depth == 8:
        return rows
    bits = np.unpackbits(rows, axis=1, count=w * depth)
    if depth == 1:
        return bits.astype(bool)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    levels = bits.reshape(h, w, depth) @ weights
    return levels.astype(np.uint8) * np.uint8(255 // (2 ** depth - 1))
