"""Sobel edge maps with tf.image.sobel_edges semantics (port of
``probav_tpu/ops/sobel.py``).

Per channel, the 3x3 kernels ``[[-1,-2,-1],[0,0,0],[1,2,1]]`` (dy) and its
transpose (dx) are applied as a cross-correlation after REFLECT padding of
H and W by 1.  The maps are written as shifted slices of the padded tensor
with integer weights, not as a convolution: the JAX package runs its conv
at ``Precision.HIGHEST``, and a cuDNN conv would round its operands to
TF32 wherever cuDNN's TF32 is on (the ``--bf16`` runs leave it on).  The
adds round as float32 adds at any TF32 setting.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sobel_edges(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, C, 2] float32 with (dy, dx) edge maps."""
    h, w = images.shape[1:3]
    x = F.pad(images.float().movedim(-1, 1), (1, 1, 1, 1), mode="reflect")

    def tap(i, j):        # x[i + a, j + b] over the output grid, [B,C,H,W]
        return x[:, :, i:i + h, j:j + w]

    dy = (tap(2, 0) + 2.0 * tap(2, 1) + tap(2, 2)) \
        - (tap(0, 0) + 2.0 * tap(0, 1) + tap(0, 2))
    dx = (tap(0, 2) + 2.0 * tap(1, 2) + tap(2, 2)) \
        - (tap(0, 0) + 2.0 * tap(1, 0) + tap(2, 0))
    return torch.stack([dy, dx], dim=-1).movedim(1, 3)
