"""Convolutions, instance norm and activations (port of
``probav_tpu/models/layers.py``).

Activations are channels-last, as in the JAX package: ``[B, H, W, T, C]``
for 3D convs and ``[B, H, W, C]`` for 2D ones.  The layers keep the JAX
parameter layouts so that converted parameters load by name:

- ``WNConv``, the weight-normalized conv: ``kernel_v [kh, kw, (kt,) I,
  O]``, ``wn_g [O]``, ``bias [O]``;
- ``Conv``, flax ``nn.Conv``'s plain 2D conv (FuseNet): ``kernel [kh, kw,
  I, O]``, ``bias [O]``, with strides and XLA's SAME padding;
- ``InstanceNorm`` (tfa InstanceNormalization): ``gamma [C]``, ``beta
  [C]``.

A kernel is transposed to PyTorch's ``[O, I, kh, kw, (kt)]`` only where
the conv runs, with the JAX spatial axes (H, W, T) as PyTorch's (D, H, W).
Activations: ``relu``, ``mish`` (x * tanh(softplus(x))) and ``leakyrelu``
(slope 0.3).

A ``WNConv`` may hold one part of its channels on a mesh's model axis
(``split``, set by ``WDSRBlock.shard_``): ``"out"``, a part of its output
channels, whose weight norm is its own, or ``"in"``, a part of its input
channels, whose product and weight norm are partial sums that the model
group adds (``parallel.mesh``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from probav_tpu_torch.parallel.mesh import copy_to_model, reduce_from_model


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) as one op, which saves only its input for the
    backward (the JAX package's x * tanh(log1p(exp(x))) would save four
    tensors of a wide layer); within 1e-6 of it at |x| <= 30."""
    return F.mish(x)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.3)


_ACTS = {None: lambda x: x, "relu": torch.relu, "mish": mish,
         "leakyrelu": leaky_relu}


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: (lo, hi) with out = ceil(size /
    stride) and lo = total // 2."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


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

    ``split`` (None, ``"out"`` or ``"in"``) and ``mesh``: the channels
    this layer holds a part of on ``mesh``'s model group.  ``"out"``: the
    input is replicated and its gradient is the group's sum
    (``copy_to_model``).  ``"in"``: the conv's output is the group's sum
    of the ranks' partial products (``reduce_from_model``, in float32),
    and the bias is added once, after the sum.
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
        self.split, self.mesh = None, None
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
        """(kernel [*k, I, O], bias [O]) in float32, weight norm applied.
        With ``split == "in"`` the norm is over the whole group's input
        channels: the ranks' sums of squares are added
        (``reduce_from_model``), and the scale g / norm, replicated but
        applied to this rank's part alone, passes ``copy_to_model``, so
        that the gradients of g and of the norm are the group's sums."""
        v = self.kernel_v.float()
        g = self.wn_g.float()
        if self.split != "in":
            return v * (g / self._norm(v)), self.bias.float()
        squares = torch.sum(torch.square(v), dim=tuple(range(v.dim() - 1)))
        norm = torch.sqrt(reduce_from_model(squares, self.mesh))
        return v * copy_to_model(g / norm, self.mesh), self.bias.float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nd = len(self.kernel_size)
        kernel, bias = self.effective_kernel()
        w = kernel.to(self.dtype).permute(nd + 1, nd, *range(nd))
        pad = [k // 2 for k in self.kernel_size] \
            if self.padding == "SAME" else 0
        conv = F.conv3d if nd == 3 else F.conv2d
        if self.split == "out":
            x = copy_to_model(x, self.mesh)
        y = conv(x.to(self.dtype).movedim(-1, 1), w, padding=pad)
        y = y.movedim(1, -1)
        if self.split == "in":
            y = reduce_from_model(y, self.mesh)
        return _ACTS[self.activation](y + bias.to(self.dtype))


class Conv(nn.Module):
    """flax ``nn.Conv`` in 2D, float32: ``kernel [kh, kw, I, O]``
    (lecun-normal init), ``bias [O]`` (zeros), ``strides``, and XLA's SAME
    padding, any kernel size (FuseNet v3's is 48x48 and pads 23, 24)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        kw = dict(dtype=torch.float32, device=device)
        self.kernel = nn.Parameter(torch.empty(
            self.kernel_size + (in_features, features), **kw))
        self.bias = nn.Parameter(torch.empty(features, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's lecun_normal: a normal of variance 1 / fan_in truncated
        to two standard deviations (std rescaled by the truncation), drawn
        on the CPU; zero bias."""
        shape = self.kernel.shape
        std = math.sqrt(1.0 / math.prod(shape[:-1])) / .87962566103423978
        v = torch.empty(shape, dtype=torch.float64)
        nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=generator)
        self.kernel.copy_((v * std).float())
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.movedim(-1, 1)                                 # [B, C, H, W]
        (th, bh), (lw, rw) = (
            same_pads(n, k, s) for n, k, s in
            zip(xc.shape[2:], self.kernel_size, self.strides))
        if th or bh or lw or rw:
            xc = F.pad(xc, (lw, rw, th, bh))
        if xc.shape[1] == 1:
            # With one channel the view above reads as channels-last too,
            # and on that layout oneDNN's weight gradient of FuseNet's
            # 48x48 kernel takes minutes instead of a second, and cuDNN's
            # FuseNet v3 step is 9% slower.  Wider inputs are not copied.
            xc = xc.clone(memory_format=torch.contiguous_format)
        w = self.kernel.permute(3, 2, 0, 1)
        y = F.conv2d(xc, w, self.bias, stride=self.strides)
        return y.movedim(1, -1)


class InstanceNorm(nn.Module):
    """tfa InstanceNormalization: each sample's channels normalised over
    every spatial axis (H, W, and T in 3D) with the biased variance and
    eps 1e-3, then ``gamma`` and ``beta`` (drawn U(-0.05, 0.05), keras's
    'random_uniform'), cast to the input's dtype as JAX casts them.  It
    runs as ``F.instance_norm``, which takes the statistics in float32 for
    bf16 input too and saves one copy of its input for the backward."""

    def __init__(self, features: int, epsilon: float = 1e-3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.epsilon = epsilon
        kw = dict(dtype=torch.float32, device=device)
        self.gamma = nn.Parameter(torch.empty(features, **kw))
        self.beta = nn.Parameter(torch.empty(features, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for p in (self.gamma, self.beta):
            u = torch.rand(p.shape, generator=generator, dtype=torch.float64)
            p.copy_((u * 0.1 - 0.05).float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.instance_norm(x.movedim(-1, 1), weight=self.gamma.to(x.dtype),
                            bias=self.beta.to(x.dtype), eps=self.epsilon)
        return y.movedim(1, -1)
