"""Patch extraction, pixel shuffle and full-scene reconstruction (port
of ``probav_tpu/ops/patches.py``).

``extract_patches_np`` is the host preprocessing pipeline's patcher
(stage 3): a numpy stride-trick view that emits patches in the row-major
(rows, then columns) order of ``torch.Tensor.unfold``, which the
submission reconstruction depends on.
"""

from __future__ import annotations

import numpy as np
import torch


def _num_windows(size: int, patch: int, stride: int) -> int:
    return (size - patch) // stride + 1


def extract_patches_np(images: np.ndarray, patch: int,
                       stride: int) -> np.ndarray:
    """[..., H, W] -> [..., nH*nW, patch, patch], row-major window order.

    Pure view-based (sliding_window_view + reshape copy at the end).
    """
    nh = _num_windows(images.shape[-2], patch, stride)
    nw = _num_windows(images.shape[-1], patch, stride)
    win = np.lib.stride_tricks.sliding_window_view(images, (patch, patch),
                                                   axis=(-2, -1))
    win = win[..., ::stride, ::stride, :, :]           # [..., nH, nW, p, p]
    lead = images.shape[:-2]
    return win.reshape(lead + (nh * nw, patch, patch))


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
