"""The WDSR model family (port of ``probav_tpu/models/wdsr.py``): the
flagship WDSR-B multi-frame net ``WDSRConv3D``, its instance-norm + mish
variant ``IWDSRConv3D``, and the full-scene fusion net ``FuseNetConv2D``.

Input is a channels-last batch ``[B, H, W, T, C]`` with H = W = patch +
max_shift.  The main path runs a weight-normalized Conv3D stem,
``num_res_blocks`` WDSR-B residual blocks, a temporal reduction ladder that
collapses T to 1 while trimming H, W to the patch size, a conv to scale^2
channels and a depth-to-space shuffle; the residual path averages the
frames and runs ``scale`` VALID 2D convs and a shuffle.

Submodule names equal the flax ones (``mainConv1``, ``resBlock_<i>``,
``convReducer_<k>``, ``upscaleConv1``, ``residConv<k>``), so a converted
flax parameter tree loads by name (``probav_tpu_torch.convert``).

The block stack has three tiers, ``fused_stack``:

- ``"t"`` (the default, the production tier): the blocks run through the
  hand-written kernels of ``ops/tstack.py``, forward and backward;
- ``"flat"``: one autograd node around the stack (``ops/block_stack.py``),
  a plain forward and the ``wide_bwd`` kernel in each block's backward;
- ``"off"``: ``WDSRBlock`` modules, whose 1x1x1 convs are ordinary
  convolutions, or with ``fused_block`` the expand -> relu -> decay of each
  block as ``ops/wide_block.fused_expand_decay`` (``wide_bwd`` backward).

The stack kernels take any width from 1 to 128 channels (and decay
channels), forward and backward; a ``"t"`` model beyond that, which they
refuse (``ops.tstack.t_tier_refusal``), raises when it is built: such a
model is built with ``fused_stack="off"``.

On the CPU every kernel is replaced by its plain version.  The parameter
tree is the same in every tier.  A bool is accepted for the tier with the
meaning it had in this package before tiers existed: ``True`` is ``"t"``
and ``False`` is ``"off"``.  This differs from the JAX package, where
``fused_stack=True`` means the flat stack; ``stack_tier`` normalises.  The
convs outside the stack are plain ``F.conv3d``/``F.conv2d``, as the JAX
package leaves them to XLA.

``remat`` (the JAX model's ``nn.remat``) runs each block of the ``"off"``
tier under ``torch.utils.checkpoint``: a block keeps only its input for
the backward, which recomputes its forward (with ``fused_block`` the
forward of ``fused_expand_decay``, so ``wide_bwd`` still runs once a
block).  The ``"t"`` and ``"flat"`` tiers ignore it, as the JAX model
does: their stacks save only narrow residuals already.

``IWDSRConv3D`` and ``FuseNetConv2D`` have no kernel tier: the JAX package
runs them as plain XLA, and the port as plain PyTorch (cuDNN's convs,
``F.instance_norm``) on any device.

``WDSRConv3D.shard_(mesh)`` puts the model on a mesh's model axis (tensor
parallelism, ``parallel/mesh.py``): each block keeps its rank's part of
the expand's output channels and of the decay's input channels, cut from
the full parameters, so a seed gives the one-process model.  A block then
adds the group's partial decay products, and its decay bias once after
them, in every tier that takes the axis: ``"off"`` (with ``fused_block``
and ``remat`` too) and ``"flat"``.  The ``"t"`` tier refuses it, as the
JAX trainer does.  ``IWDSRConv3D`` (its ``expConv_<i>`` / ``decConv_<i>``
fall outside JAX's name rule) and ``FuseNetConv2D`` stay replicated.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from probav_tpu_torch.models.layers import (_ACTS, Conv, InstanceNorm,
                                            WNConv, leaky_relu, reflect_pad)
from probav_tpu_torch.ops.block_stack import fused_block_stack
from probav_tpu_torch.ops.patches import depth_to_space
from probav_tpu_torch.ops.tstack import stack_apply_5d, t_tier_refusal
from probav_tpu_torch.ops.wide_block import fused_expand_decay
from probav_tpu_torch.parallel.mesh import (MODEL_AXIS_T_REFUSAL, shard_dim,
                                            shard_state)

STACK_TIERS = ("off", "flat", "t")


def stack_tier(fused_stack: Union[bool, str]) -> str:
    """The stack tier of a ``fused_stack`` argument: "off", "flat" or "t";
    True is "t" and False "off" (not the JAX package's True = flat)."""
    if isinstance(fused_stack, bool):
        return "t" if fused_stack else "off"
    if fused_stack not in STACK_TIERS:
        raise ValueError(f"fused_stack {fused_stack!r}: one of "
                         f"{STACK_TIERS} or a bool")
    return fused_stack


def reduction_schedule(num_img: int, kernel_t: int) -> Sequence[dict]:
    """Temporal-reduction ladder: the conv steps before the upscale conv.

    Each step: {'pad': (ph, pw, pt), 'kernel': (kh, kw, kt)}.  The closed
    form covers T in {7, 9, 13}; T = 19 keeps the reference's bespoke
    schedule.  (Same function as the JAX package's, which imports flax.)
    """
    if num_img == 19 and kernel_t == 3:
        k3 = (3, 3, 3)
        return [
            {"pad": (2, 2, 2), "kernel": (5, 5, 5)},
            {"pad": (2, 2, 1), "kernel": k3},
            {"pad": (2, 2, 0), "kernel": k3},
            {"pad": (2, 2, 0), "kernel": k3},
            {"pad": (1, 1, 0), "kernel": k3},
        ] + [{"pad": (0, 0, 0), "kernel": k3}] * 5
    n_convs = (num_img - kernel_t) // (kernel_t - 1)
    if n_convs * (kernel_t - 1) + kernel_t != num_img:
        raise ValueError(
            f"num_low_res_imgs={num_img} incompatible with temporal kernel "
            f"{kernel_t}: need T = n*(kt-1) + kt for integer n")
    n_padded = max(0, n_convs - 2)
    k = (kernel_t,) * 3
    return ([{"pad": (1, 1, 0), "kernel": k}] * n_padded +
            [{"pad": (0, 0, 0), "kernel": k}] * (n_convs - n_padded))


class WDSRBlock(nn.Module):
    """WDSR-B residual block: 1x1x1 expand (relu) -> 1x1x1 decay -> k^3
    conv -> add the input.  ``fused`` runs expand -> relu -> decay as
    ``fused_expand_decay`` (backward on the ``wide_bwd`` kernel).  After
    ``shard_(mesh)`` the expand and decay hold this rank's channels of the
    mesh's model axis."""

    def __init__(self, num_filters: int, exp_rate: int, decay_rate: float,
                 kernel_size: Tuple[int, int, int],
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None,
                 fused: bool = False):
        super().__init__()
        self.fused = fused
        f = num_filters
        c_mid, c_dec = f * exp_rate, int(f * decay_rate)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.expand = WNConv(f, c_mid, (1, 1, 1), "SAME", "relu", **kw)
        self.decay = WNConv(c_mid, c_dec, (1, 1, 1), "SAME", None, **kw)
        self.conv = WNConv(c_dec, f, kernel_size, "SAME", None, **kw)
        self.dtype = dtype
        self.mesh = None

    @torch.no_grad()
    def shard_(self, mesh) -> None:
        """Keep this rank's part of the expand's output channels and of the
        decay's input channels (``parallel.mesh.shard_dim``) of the full
        parameters; ValueError where C_mid does not divide by the model
        size."""
        for name, p in self.named_parameters():
            if shard_dim(name, p.dim()) is not None:
                p.data = shard_state({name: p.data}, mesh)[name]
        self.expand.split, self.decay.split = "out", "in"
        self.expand.mesh = self.decay.mesh = self.mesh = mesh

    def effective_params(self):
        """(w1 [C, C_mid], b1, w2 [C_mid, C_dec], b2, wc [3,3,3,C_dec,C],
        bc), weight norm applied, cast to the compute dtype (the stack
        kernels widen the biases back to float32)."""
        k1, b1 = self.expand.effective_kernel()
        k2, b2 = self.decay.effective_kernel()
        kc, bc = self.conv.effective_kernel()
        d = self.dtype
        return (k1.reshape(k1.shape[-2], k1.shape[-1]).to(d), b1.to(d),
                k2.reshape(k2.shape[-2], k2.shape[-1]).to(d), b2.to(d),
                kc.to(d), bc.to(d))

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        if self.fused:
            w1, b1, w2, b2 = self.effective_params()[:4]
            c = x_in.shape[-1]
            y = fused_expand_decay(x_in.reshape(-1, c).to(self.dtype), w1, b1,
                                   w2, b2, mesh=self.mesh)
            x = y.reshape(x_in.shape[:-1] + (w2.shape[1],))
        else:
            x = self.decay(self.expand(x_in))
        return self.conv(x) + x_in


class WDSRConv3D(nn.Module):
    """Flagship WDSR-B 3D fusion net.  Call with [B, H, W, T, C] and an
    optional ``norm = [mean, std]`` tensor (the band statistics as data).
    ``fused_stack``: the stack tier (module docstring); ``fused_block``
    and ``remat`` apply in the "off" tier only; ``shard_`` puts the
    blocks on a mesh's model axis."""

    def __init__(self, scale: int = 3, num_filters: int = 32,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3),
                 num_res_blocks: int = 12, exp_rate: int = 8,
                 decay_rate: float = 0.8, num_img_lr: int = 9,
                 patch_size_lr: int = 16, mean: float = 0.0, std: float = 1.0,
                 dtype: torch.dtype = torch.float32,
                 fused_stack: Union[bool, str] = "t", in_channels: int = 1,
                 device=None, generator: Optional[torch.Generator] = None,
                 fused_block: bool = False, remat: bool = False):
        super().__init__()
        self.scale, self.num_img_lr = scale, num_img_lr
        self.patch_size_lr = patch_size_lr
        self.mean, self.std = mean, std
        self.dtype, self.fused_stack = dtype, stack_tier(fused_stack)
        self.remat = remat
        self.mesh = None
        f, k = num_filters, tuple(kernel_size)
        why = t_tier_refusal(f, int(f * decay_rate))
        if self.fused_stack == "t" and why:
            raise ValueError(f"fused_stack='t': the stack kernels take "
                             f"{why}; build this width with fused_stack="
                             f"'off'")
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.mainConv1 = WNConv(in_channels, f, k, "SAME", "relu", **kw)
        self.block_names = [f"resBlock_{i}" for i in range(num_res_blocks)]
        for name in self.block_names:
            setattr(self, name, WDSRBlock(f, exp_rate, decay_rate, k, **kw,
                                          fused=fused_block))
        self.schedule = reduction_schedule(num_img_lr, k[2])
        for s, step in enumerate(self.schedule):
            setattr(self, f"convReducer_{s + 1}",
                    WNConv(f, f, step["kernel"], "VALID", "relu", **kw))
        self.upscaleConv1 = WNConv(f, scale ** 2, k, "VALID", None, **kw)
        for i in range(scale):
            setattr(self, f"residConv{i + 1}",
                    WNConv(in_channels if i == 0 else scale ** 2, scale ** 2,
                           k[:2], "VALID", "relu" if i == 0 else None, **kw))

    def shard_(self, mesh) -> None:
        """Split every block's expand / decay pair over ``mesh``'s model
        group (``WDSRBlock.shard_``).  The "t" tier raises the JAX
        trainer's ValueError; so does a model sharded already."""
        if self.fused_stack == "t":
            raise ValueError(MODEL_AXIS_T_REFUSAL)
        if self.mesh is not None:
            raise ValueError("WDSRConv3D.shard_: sharded already")
        for name in self.block_names:
            getattr(self, name).shard_(mesh)
        self.mesh = mesh

    def forward(self, x: torch.Tensor, norm=None) -> torch.Tensor:
        if x.dim() != 5 or x.shape[3] != self.num_img_lr:
            raise ValueError(
                f"WDSRConv3D expects [B, H, W, T={self.num_img_lr}, C] "
                f"input, got {tuple(x.shape)}")
        mean, std = ((self.mean, self.std) if norm is None
                     else (norm[0], norm[1]))
        x = x.float()
        mean_lr = x.mean(dim=3)                           # [B, H, W, C]
        xn = ((x - mean) / std).to(self.dtype)
        mn = ((mean_lr - mean) / std).to(self.dtype)
        out = self._main_path(xn) + self._residual_path(mn)
        return out.float() * std + mean

    def _main_path(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mainConv1(x)
        blocks = [getattr(self, n) for n in self.block_names]
        if self.fused_stack == "t":
            x = stack_apply_5d(x, [b.effective_params() for b in blocks])
        elif self.fused_stack == "flat":
            x = fused_block_stack(x, [b.effective_params() for b in blocks],
                                  mesh=self.mesh)
        elif self.remat and torch.is_grad_enabled():
            for b in blocks:
                x = checkpoint(b, x, use_reentrant=False)
        else:
            for b in blocks:
                x = b(x)
        for s, step in enumerate(self.schedule):
            if any(step["pad"]):
                x = reflect_pad(x, step["pad"])
            x = getattr(self, f"convReducer_{s + 1}")(x)
        x = self.upscaleConv1(x)                          # [B, p, p, 1, s^2]
        b, h, w = x.shape[:3]
        return depth_to_space(x.reshape(b, h, w, self.scale ** 2),
                              self.scale)

    def _residual_path(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.scale):
            x = getattr(self, f"residConv{i + 1}")(x)
        return depth_to_space(x, self.scale)


class IWDSRConv3D(nn.Module):
    """Instance-norm + mish WDSR variant: every conv is ``WNConv`` ->
    ``InstanceNorm`` -> activation.  Call as ``WDSRConv3D``, with
    [B, H, W, T, C] and an optional ``norm = [mean, std]`` tensor.

    The flax names: ``mainConv1``, ``expConv_<i>``, ``decConv_<i>``,
    ``normConv_<i>``, ``convReducer_<k>`` (0-based, unlike WDSR's),
    ``upscaleConv1``, ``residConv<k>``, each conv's norm as ``<name>_in``.
    The JAX package's documented deviation is kept: the residual path's
    three extra 3x3 convs (``residConv1``-``residConv3``) pad SAME, so that
    it meets the main path's geometry; ``residConv4`` on are VALID."""

    def __init__(self, scale: int = 3, num_filters: int = 32,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3),
                 num_res_blocks: int = 12, exp_rate: int = 8,
                 decay_rate: float = 0.8, num_img_lr: int = 9,
                 patch_size_lr: int = 16, mean: float = 0.0, std: float = 1.0,
                 dtype: torch.dtype = torch.float32, in_channels: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale, self.num_img_lr = scale, num_img_lr
        self.patch_size_lr = patch_size_lr
        self.num_res_blocks = num_res_blocks
        self.mean, self.std, self.dtype = mean, std, dtype
        f, k = num_filters, tuple(kernel_size)
        kw = dict(device=device, generator=generator)

        def conv_in(name, cin, cout, kernel, padding, act):
            setattr(self, name, WNConv(cin, cout, kernel, padding, None,
                                       dtype=dtype, **kw))
            setattr(self, f"{name}_in", InstanceNorm(cout, **kw))
            self.acts[name] = act

        self.acts = {}
        conv_in("mainConv1", in_channels, f, k, "SAME", "mish")
        c_mid, c_dec = f * exp_rate, int(f * decay_rate)
        for i in range(num_res_blocks):
            conv_in(f"expConv_{i}", f, c_mid, (1, 1, 1), "SAME", "mish")
            conv_in(f"decConv_{i}", c_mid, c_dec, (1, 1, 1), "SAME", None)
            conv_in(f"normConv_{i}", c_dec, f, k, "SAME", None)
        self.schedule = reduction_schedule(num_img_lr, k[2])
        for s, step in enumerate(self.schedule):
            conv_in(f"convReducer_{s}", f, f, step["kernel"], "VALID", "mish")
        s2 = scale ** 2
        conv_in("upscaleConv1", f, s2, k, "VALID", None)
        k2 = k[:2]
        conv_in("residConv1", in_channels, s2, k2, "SAME", "mish")
        conv_in("residConv2", s2, s2, k2, "SAME", None)
        conv_in("residConv3", s2, s2, k2, "SAME", None)
        for i in range(scale):
            conv_in(f"residConv{i + 4}", s2, s2, k2, "VALID",
                    "mish" if i == 0 else None)

    def _conv_in(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, f"{name}_in")(getattr(self, name)(x))
        return _ACTS[self.acts[name]](x)

    def forward(self, x: torch.Tensor, norm=None) -> torch.Tensor:
        if x.dim() != 5 or x.shape[3] != self.num_img_lr:
            raise ValueError(
                f"IWDSRConv3D expects [B, H, W, T={self.num_img_lr}, C] "
                f"input, got {tuple(x.shape)}")
        mean, std = ((self.mean, self.std) if norm is None
                     else (norm[0], norm[1]))
        x = x.float()
        mean_lr = x.mean(dim=3)
        xn = ((x - mean) / std).to(self.dtype)
        mn = ((mean_lr - mean) / std).to(self.dtype)

        h = self._conv_in("mainConv1", xn)
        for i in range(self.num_res_blocks):
            r = self._conv_in(f"expConv_{i}", h)
            r = self._conv_in(f"decConv_{i}", r)
            h = h + self._conv_in(f"normConv_{i}", r)
        for s, step in enumerate(self.schedule):
            if any(step["pad"]):
                h = reflect_pad(h, step["pad"])
            h = self._conv_in(f"convReducer_{s}", h)
        h = self._conv_in("upscaleConv1", h)
        b, hh, ww = h.shape[:3]
        main = depth_to_space(h.reshape(b, hh, ww, self.scale ** 2),
                              self.scale)

        r = mn
        for i in range(3 + self.scale):
            r = self._conv_in(f"residConv{i + 1}", r)
        out = (main + depth_to_space(r, self.scale)).float()
        return out * std + mean


# FuseNet's convs: variant -> [(features, kernel, strides)], and the
# depth-to-space factor of its last layer (None: a mean over channels).
FUSENET = {
    "v3": ([(64, (48, 48), (1, 1))], None),
    "v2": ([(64, (8, 8), (8, 8)), (64, (3, 3), (1, 1))], 8),
    "v1": ([(128, (3, 3), (3, 3)), (64, (3, 3), (1, 1)),
            (32, (3, 3), (1, 1)), (9, (3, 3), (1, 1))], 3),
}


class FuseNetConv2D(nn.Module):
    """Full-scene fusion net: [B, 384, 384, 1] in, the input plus a learned
    correction out, all in float32.  Each conv (``conv<j>``, SAME) is followed
    by ``InstanceNorm`` (``in<j>``) and leaky ReLU 0.3; v3 (the live one)
    is one 64-channel 48x48 conv and a mean over channels, v2 an 8x8
    stride-8 conv, a 3x3 conv and a depth-to-space by 8, v1 a 3x3 stride-3
    conv to 128 channels, then 64, 32 and 9 channels and a depth-to-space
    by 3.  ``norm`` is accepted, for the trainer's call, and ignored."""

    def __init__(self, variant: str = "v3", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if variant not in FUSENET:
            raise ValueError(f"unknown FuseNet variant {variant!r}")
        self.variant = variant
        convs, self.d2s = FUSENET[variant]
        self.n_convs = len(convs)
        cin = 1
        for j, (feats, kernel, strides) in enumerate(convs, start=1):
            setattr(self, f"conv{j}", Conv(cin, feats, kernel, strides,
                                           device=device, generator=generator))
            setattr(self, f"in{j}", InstanceNorm(feats, device=device,
                                                 generator=generator))
            cin = feats

    def forward(self, x: torch.Tensor, norm=None) -> torch.Tensor:
        del norm
        x = x.float()
        h = x
        for j in range(1, self.n_convs + 1):
            h = leaky_relu(getattr(self, f"in{j}")(
                getattr(self, f"conv{j}")(h)))
        main = (h.mean(dim=3, keepdim=True) if self.d2s is None
                else depth_to_space(h, self.d2s))
        return x + main


MODEL_TYPES = ("wdsr", "iwdsr", "fusenet")


def build_model(cfg, band: str, dtype: torch.dtype = torch.float32,
                fused_stack: Union[bool, str] = "t", device=None,
                generator: Optional[torch.Generator] = None,
                fused_block: bool = False, model_type: str = "wdsr",
                remat: bool = False) -> nn.Module:
    """The model a Config (or the path of a ``.cfg`` file) describes, for
    one band (mirrors ``probav_tpu.models.build_model``): ``model_type``
    "wdsr" (``WDSRConv3D``; ``fused_stack``, ``fused_block`` and ``remat``
    as there), "iwdsr" (``IWDSRConv3D``) or "fusenet" (``FuseNetConv2D``
    v3, float32 only).  ``fused_stack``, ``fused_block`` and ``remat``
    apply to "wdsr" only."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"model_type {model_type!r}: one of {MODEL_TYPES}")
    if model_type == "fusenet":
        if dtype != torch.float32:
            raise ValueError("FuseNetConv2D runs in float32 only")
        return FuseNetConv2D(device=device, generator=generator)
    kw = dict(dtype=dtype, device=device, generator=generator)
    if isinstance(cfg, (str, os.PathLike)):
        from probav_tpu_torch.config import Config
        cfg = Config.from_file(cfg)
    mean, std = cfg.band_stats(band)
    common = dict(
        scale=cfg.scale, num_filters=cfg.num_filters,
        kernel_size=(cfg.kernel_size,) * 3,
        num_res_blocks=cfg.num_res_blocks, exp_rate=cfg.exp_rate,
        decay_rate=cfg.decay_rate, num_img_lr=cfg.num_low_res_imgs,
        patch_size_lr=cfg.patch_size, mean=mean, std=std,
        in_channels=1 if cfg.is_grayscale else 3, **kw)
    if model_type == "iwdsr":
        return IWDSRConv3D(**common)
    return WDSRConv3D(fused_stack=fused_stack, fused_block=fused_block,
                      remat=remat, **common)


def input_shape(cfg, batch: int = 1) -> Tuple[int, ...]:
    """Model input shape [B, p+shift, p+shift, T, C]."""
    s = cfg.lr_input_size
    c = 1 if cfg.is_grayscale else 3
    return (batch, s, s, cfg.num_low_res_imgs, c)
