"""Pixel shuffle and full-scene reconstruction (port of
``probav_tpu/ops/patches.py``)."""

from __future__ import annotations

import torch


def depth_to_space(x: torch.Tensor, scale: int) -> torch.Tensor:
    """tf.nn.depth_to_space for NHWC: [B,H,W,r*r*C] -> [B,H*r,W*r,C].

    TF channel order (channel = (i*r + j)*C + c).  ``F.pixel_shuffle``
    orders channels as c*r*r + i*r + j, so it agrees only when C == 1.
    """
    b, h, w, c = x.shape
    r = scale
    cout = c // (r * r)
    x = x.reshape(b, h, w, r, r, cout).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * r, w * r, cout)


def reconstruct_from_patches(patches: torch.Tensor, out_size: int):
    """[..., nPatches, p, p, C] -> [..., out_size, out_size, C], row-major
    paste; leading dimensions (e.g. a group of scenes) are kept."""
    *lead, n, p, _, c = patches.shape
    grid = out_size // p
    if grid * grid != n or grid * p != out_size:
        raise ValueError(f"{n} patches of {p} px do not tile {out_size}")
    k = len(lead)
    x = patches.reshape(*lead, grid, grid, p, p, c)
    x = x.permute(*range(k), k, k + 2, k + 1, k + 3, k + 4)
    return x.reshape(*lead, out_size, out_size, c)
