"""Weight-normalized convolutions (port of ``probav_tpu/models/layers.py``).

Activations are channels-last, as in the JAX package: ``[B, H, W, T, C]``
for 3D convs and ``[B, H, W, C]`` for 2D ones.  ``WNConv`` keeps the JAX
parameter layout (``kernel_v [kh, kw, (kt,) I, O]``, ``wn_g [O]``, ``bias
[O]``) so that converted parameters load by name; the kernel is transposed
to PyTorch's ``[O, I, kh, kw, (kt)]`` only where the conv runs, with the
JAX spatial axes (H, W, T) as PyTorch's (D, H, W).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

_ACTS = {None: lambda x: x, "relu": torch.relu}


def reflect_pad(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """Reflect-pad the spatial axes of a channels-last [B, *S, C] tensor by
    ``pads`` per side (jnp.pad mode="reflect")."""
    nd = x.dim() - 2
    if len(pads) != nd:
        raise ValueError(f"{len(pads)} pads for {nd} spatial axes")
    torch_pad = []
    for p in reversed(pads):             # F.pad lists the last axis first
        torch_pad += [p, p]
    xc = x.movedim(-1, 1)                # [B, C, *S]
    return F.pad(xc, torch_pad, mode="reflect").movedim(1, -1)


class WNConv(nn.Module):
    """Weight-normalized N-D convolution, N = len(kernel_size) in {2, 3}.

    The effective kernel is ``g * v / ||v||`` with the norm over every axis
    but the output one, computed in float32 and cast to the compute dtype.
    """

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, ...], padding: str = "SAME",
                 activation: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}")
        if padding == "SAME" and any(k % 2 == 0 for k in kernel_size):
            raise ValueError("SAME padding needs odd kernel sizes")
        self.kernel_size = tuple(kernel_size)
        self.padding = padding
        self.activation = activation
        self.dtype = dtype
        shape = self.kernel_size + (in_features, features)
        kw = dict(dtype=torch.float32, device=device)
        self.kernel_v = nn.Parameter(torch.empty(shape, **kw))
        self.wn_g = nn.Parameter(torch.empty(features, **kw))
        self.bias = nn.Parameter(torch.empty(features, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Glorot-uniform v, g = ||v|| (so the initial kernel is v), zero
        bias, as flax initializes the JAX layer.  Values are drawn on the
        CPU so that a seed gives the same weights on every device."""
        shape = self.kernel_v.shape
        receptive = math.prod(shape[:-2])
        limit = math.sqrt(6.0 / (receptive * (shape[-2] + shape[-1])))
        v = (torch.rand(shape, generator=generator, dtype=torch.float64)
             * 2.0 - 1.0) * limit
        self.kernel_v.copy_(v.float())
        self.wn_g.copy_(self._norm(self.kernel_v))
        self.bias.zero_()

    @staticmethod
    def _norm(v: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.sum(torch.square(v),
                                    dim=tuple(range(v.dim() - 1))))

    def effective_kernel(self):
        """(kernel [*k, I, O], bias [O]) in float32, weight norm applied."""
        v = self.kernel_v.float()
        return v * (self.wn_g.float() / self._norm(v)), self.bias.float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nd = len(self.kernel_size)
        kernel, bias = self.effective_kernel()
        w = kernel.to(self.dtype).permute(nd + 1, nd, *range(nd))
        pad = [k // 2 for k in self.kernel_size] \
            if self.padding == "SAME" else 0
        conv = F.conv3d if nd == 3 else F.conv2d
        y = conv(x.to(self.dtype).movedim(-1, 1), w, padding=pad)
        y = y.movedim(1, -1) + bias.to(self.dtype)
        return _ACTS[self.activation](y)
