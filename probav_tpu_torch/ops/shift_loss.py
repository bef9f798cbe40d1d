"""Shift-compensated masked losses and the cPSNR metric (port of
``probav_tpu/ops/shift_loss.py``).

For every translation (i, j) of the ground truth within a +-border window,
the prediction's centre crop is bias-corrected by the brightness offset
b = sum(HR - SR*M) / sum(M) and masked, and a masked L1 or L2 is taken;
losses keep the best shift.  All (2*border + 1)^2 = 49 shifts are one
batched computation, plain PyTorch by default as the JAX package runs plain
XLA.  With ``use_kernel`` (the counterpart of JAX's opt-in ``use_pallas``)
the [S, B] table and its gradient come from the hand-written CUDA kernels
of ``ops/shift_table.py`` wherever ``shift_table.supports`` holds
(grayscale square patches); other shapes take the plain path, as JAX's
``_maybe_pallas`` does.  On the card the kernels take every plane that
``supports`` lets through, whole 384x384 scenes among them.

The four cfg losses (``by_name``): ``l1``, ``l2``, ``sobel_l1_mix``
(``l1_edge``: a blend of the masked L1 and the L1 between Sobel edge maps
of the 42x42 crops) and ``l1msssim`` (``rev_msssim``: a reversed
multi-scale SSIM mixed with a window-weighted L1, batch-coupled, so it has
no per-sample form).  Only ``l1``, ``l2`` and ``cpsnr`` take the kernel
tables, as only they reach ``_maybe_pallas`` in the JAX package; the two
others are plain PyTorch there and here, all 49 shifts (and, for
``rev_msssim``, all 5 scales) batched into one computation as JAX's
``vmap`` batches them.

Reference quirks kept: the ground truth enters the residual UNMASKED
(occluded HR pixels add |HR| while the prediction is zeroed there), and the
normalizer is the count of clear pixels.  Losses take the min over shifts
then the mean over the batch; cPSNR takes the max over shifts and returns
the per-sample vector.

Batches are channels-last ``[B, H, W, C]`` as in the JAX package.

Under a mesh (``mesh=``, ``probav_tpu_torch.parallel``) each rank holds
an equal share of the batch (the ranks of a model group the same share;
every sum below runs over the data group).  ``l1``, ``l2`` and ``l1_edge`` stay
the share's mean: with equal shares the mean of the ranks' means is the
global mean, and the trainer averages them.  ``rev_msssim`` is coupled
across the batch (its min over shifts follows a sum over the batch), so
its per-shift sums and ``sum(w)`` are summed over the data group before
the min, and every rank holds the global loss; ``all_sum``'s backward
scales by N, which the trainer's gradient mean divides out.  The
``weighted`` losses sum their numerators and weights over the group.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from probav_tpu_torch.ops import shift_table
from probav_tpu_torch.ops.sobel import sobel_edges
from probav_tpu_torch.parallel.mesh import all_sum


def jnp_linspace(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` as float32 numpy, computed as the
    JAX package's CPU build computes it, which ``torch.linspace`` is not to
    the last ulp (27 of 42 entries differ at num = 42): XLA rewrites
    ``start * (1 - step) + stop * step`` with ``step = i / (num - 1)`` into
    ``fma(i, stop * r, start * (1 - i * r))`` with ``r = 1 / (num - 1)``,
    then appends the endpoint.  The fma is taken in float64, exact for the
    product of two float32 values.  The MS-SSIM window exponentiates this
    (e^42 at sigma = 0.5), which doubles an ulp."""
    f32 = np.float32
    if num == 1:
        return np.array([start], f32)
    i = np.arange(num - 1, dtype=f32)
    r = f32(1) / f32(num - 1)
    head = f32(start) * (f32(1) - i * r)
    out = i.astype(np.float64) * float(f32(stop) * r) + head
    return np.append(out.astype(f32), f32(stop))


class ShiftCompensatedLosses:
    """The shift-compensated losses over [B, H, W, C] HR/mask/pred batches.

    ``target_shape`` is the HR patch shape, ``crop_border`` the per-side
    shift allowance, ``bit_depth`` sets the dynamic range of cPSNR;
    ``use_kernel`` takes the per-shift tables from the CUDA kernels;
    ``mesh`` (a ``parallel.Mesh``) makes the batch-coupled and weighted
    losses global over its data group (module docstring).
    """

    def __init__(self, target_shape: Tuple[int, int, int] = (96, 96, 1),
                 crop_border: int = 3, bit_depth: int = 16,
                 use_kernel: bool = False, mesh=None):
        self.th, self.tw, self.tc = target_shape
        self.border = crop_border
        self.max_shift = 2 * crop_border
        self.num_bytes = float(2 ** bit_depth - 1)
        self.ch = self.th - self.max_shift
        self.cw = self.tw - self.max_shift
        self.use_kernel = use_kernel
        self.mesh = mesh
        self.pi = 0.7                        # SobelL1Mix blend
        # Multi-scale SSIM constants.
        self.sigma = (0.5, 1.0, 2.0, 4.0, 8.0)
        self.C1 = (0.01 * self.num_bytes) ** 2
        self.C2 = (0.03 * self.num_bytes) ** 2
        self.C3 = self.C2 / 2.0
        self.alpha = self.beta = self.gamma = 1.0
        self.eta = 0.25
        self._w2 = {}                        # (h, device) -> [5, h, h]

    def _shift_stack(self, x: torch.Tensor) -> torch.Tensor:
        """[B,H,W,C] -> [S,B,ch,cw,C] float32: all (max_shift+1)^2 crops,
        row-major over (i, j)."""
        win = x.float().unfold(1, self.ch, 1).unfold(2, self.cw, 1)
        # win [B, i, j, C, ch, cw] -> [i*j, B, ch, cw, C]
        win = win.permute(1, 2, 0, 4, 5, 3)
        return win.reshape((-1,) + win.shape[2:])

    def _corrected(self, hr, mask, pred):
        """(hr_s, mask_s, corrected_s, total): the shifted truth and mask,
        the bias-corrected masked prediction [S,B,ch,cw,C], and the
        clear-pixel counts [S,B]."""
        b = self.border
        pred_c = pred[:, b:b + self.ch, b:b + self.cw, :].float()
        hr_s = self._shift_stack(hr)
        mask_s = self._shift_stack(mask)
        total = mask_s.sum(dim=(2, 3, 4))
        bias = (hr_s - pred_c[None] * mask_s).sum(dim=(2, 3, 4)) / total
        corrected = (pred_c[None] + bias[:, :, None, None, None]) * mask_s
        return hr_s, mask_s, corrected, total

    def _per_shift(self, kind: str, hr, mask, pred):
        """Per-shift masked L1 or L2 table [S, B]."""
        hr_s, _, corr, total = self._corrected(hr, mask, pred)
        r = hr_s - corr
        r = r.abs() if kind == "l1" else r.square()
        return r.sum(dim=(2, 3, 4)) / total

    def _table(self, kind: str, hr, mask, pred):
        """Per-shift table [S, B]: the kernels' with ``use_kernel`` where
        they apply (``_maybe_pallas`` of the JAX package), else plain."""
        if self.use_kernel and shift_table.supports(hr, self.border):
            return shift_table.per_shift_table(kind, hr, mask, pred,
                                               self.border)
        return self._per_shift(kind, hr, mask, pred)

    def l1(self, hr, mask, pred):
        """Shift-compensated L1: scalar."""
        return self._table("l1", hr, mask, pred).min(dim=0).values.mean()

    def l2(self, hr, mask, pred):
        """Shift-compensated L2: scalar."""
        return self._table("l2", hr, mask, pred).min(dim=0).values.mean()

    def cpsnr(self, hr, mask, pred):
        """Shift-compensated cPSNR: per-sample [B] vector."""
        l2 = self._table("l2", hr, mask, pred)
        val = 10.0 * (torch.log(self.num_bytes ** 2 / l2) / math.log(10.0))
        return val.max(dim=0).values

    def _per_shift_l1_edge(self, hr, mask, pred):
        """[S, B]: pi * masked L1 + (1 - pi) * L1 between the Sobel edge
        maps of the unmasked truth crops and the corrected masked
        prediction, both over the clear-pixel count."""
        hr_s, _, corr, total = self._corrected(hr, mask, pred)
        s, b = hr_s.shape[:2]
        flat = lambda x: x.reshape((s * b,) + x.shape[2:])
        sob_hr = sobel_edges(flat(hr_s)).reshape(hr_s.shape + (2,))
        sob_sr = sobel_edges(flat(corr)).reshape(corr.shape + (2,))
        l1 = (hr_s - corr).abs().sum(dim=(2, 3, 4)) / total
        sob = (sob_hr - sob_sr).abs().sum(dim=(2, 3, 4, 5)) / total
        return self.pi * l1 + (1.0 - self.pi) * sob

    def l1_edge(self, hr, mask, pred):
        """Shift-compensated Sobel-L1 mix (cfg ``sobel_l1_mix``): scalar."""
        return self._per_shift_l1_edge(hr, mask, pred).min(dim=0) \
            .values.mean()

    def rev_msssim(self, hr, mask, pred):
        """Shift-compensated reversed MS-SSIM (cfg ``l1msssim``): scalar.

        Faithful to the reference formula, idiosyncrasies included: the
        window is exp(-linspace / (2 sigma^2)), not squared, and luminance
        is summed over the scales."""
        return self.rev_msssim_weighted(hr, mask, pred, None)

    def rev_msssim_weighted(self, hr, mask, pred, w):
        """``rev_msssim`` over the w > 0 rows only, exactly: ``w`` is a [B]
        0/1 sample weight (None: all ones).  The window is normalised per
        sample, so zeroing a row's terms and dividing by ``sum(w) * C``
        scores what an unpadded batch of the real rows scores."""
        hr_s, mask_s, corr, _ = self._corrected(hr, mask, pred)
        return self._rev_msssim_shifts(hr_s, mask_s, corr, w).min(dim=0) \
            .values

    def _window(self, h: int, device) -> torch.Tensor:
        """[5, h, h] float32: each sigma's separable window, unmasked.  It
        is built on the host once for each crop size and device, so that a
        step copies nothing from the host (a pageable copy would wait for
        the stream)."""
        key = (h, device)
        if key not in self._w2:
            lin = torch.from_numpy(jnp_linspace(-h / 2.0, h / 2.0, h))
            w1 = torch.stack([torch.exp(-1.0 * lin / (2.0 * sig ** 2))
                              for sig in self.sigma])            # [5, h]
            self._w2[key] = (w1[:, :, None] * w1[:, None, :]).to(device)
        return self._w2[key]

    def _windows(self, mask_s):
        """[S, 5, B, h, w, C] float32: each sigma's separable window, masked
        and normalised per shift and sample.  At sigma = 0.5 and h = 42 the
        outer product peaks near 3e36 (float32 ends at 3.4e38), so the
        order is that of the JAX package: outer product, mask, normalise."""
        w2 = self._window(mask_s.shape[2], mask_s.device)        # [5, h, w]
        win = w2[None, :, None, :, :, None] * mask_s[:, None]
        return win / win.sum(dim=(3, 4, 5), keepdim=True)

    def _rev_msssim_shifts(self, hr, mask, sr, w=None):
        """[S]: the reversed MS-SSIM loss of every shift at once (JAX's
        ``_rev_msssim_single`` under ``vmap``) over [S, B, h, w, C]
        crops."""
        b, c = hr.shape[1], hr.shape[4]
        if w is None:
            w = torch.ones(b, dtype=torch.float32, device=hr.device)
        wb = w[:, None, None, None]                              # [B,1,1,1]
        weights = self._windows(mask)                            # [S,5,B,..]
        hr, sr = hr[:, None], sr[:, None]                        # [S,1,B,..]
        wsum = lambda x: x.sum(dim=(3, 4), keepdim=True)
        mu_hr = wsum(weights * hr)
        mu_sr = wsum(weights * sr)
        var_hr = wsum(weights * hr ** 2) - mu_hr ** 2
        var_sr = wsum(weights * sr ** 2) - mu_sr ** 2
        cov = wsum(weights * hr * sr) - mu_sr * mu_hr

        lum = (2.0 * mu_hr * mu_sr + self.C1) \
            / (mu_hr ** 2 + mu_sr ** 2 + self.C1)
        con = (2.0 * var_hr * var_sr + self.C1) \
            / (var_hr ** 2 + var_sr ** 2 + self.C1)
        struct = (2.0 * cov + self.C3) / (var_hr * var_sr + self.C3)

        pcs = torch.prod((con ** self.beta) * (struct ** self.gamma), dim=1,
                         keepdim=True)                           # [S,1,B,..]
        per = ((lum ** self.alpha) * pcs * wb).sum(dim=(1, 2, 3, 4, 5))
        # Mixed with a window-weighted normalised L1.
        l1w = ((hr - sr).abs() * weights * wb).sum(dim=(1, 2, 3, 4, 5))
        w_sum = w.sum()
        if self.mesh is not None:   # the global batch's sums, before the min
            s = per.shape[0]
            sums = all_sum(torch.cat([per, l1w, w_sum.view(1)]), self.mesh)
            per, l1w, w_sum = sums[:s], sums[s:2 * s], sums[2 * s]
        denom = w_sum * c
        loss = 1.0 - per / denom
        l1w = l1w / denom / self.num_bytes
        return self.eta * loss + (1.0 - self.eta) * l1w

    def by_name(self, name: str):
        """Cfg loss-key dispatch; an unknown key raises KeyError."""
        return {"l1": self.l1, "sobel_l1_mix": self.l1_edge,
                "l2": self.l2, "l1msssim": self.rev_msssim}[name]

    def per_sample(self, name: str):
        """Per-sample [B] variant (min over shifts, no batch mean):
        ``mean(per_sample(...)) == by_name(...)``; None for ``l1msssim``,
        which is batch-coupled (its luminance term sums over the batch)."""
        def reduce(per_shift):
            return lambda hr, mask, pred: per_shift(hr, mask, pred) \
                .min(dim=0).values

        return {
            "l1": reduce(lambda h, m, p: self._table("l1", h, m, p)),
            "l2": reduce(lambda h, m, p: self._table("l2", h, m, p)),
            "sobel_l1_mix": reduce(self._per_shift_l1_edge),
            "l1msssim": None,
        }[name]

    def weighted(self, name: str):
        """fn(hr, mask, pred, w[B]) -> scalar, equal to ``by_name(name)`` on
        the rows with w == 1 (padded eval rows carry w == 0): a weighted
        mean of ``per_sample``, or ``rev_msssim_weighted``.  Under a mesh,
        of the rows of every rank."""
        if name == "l1msssim":
            return self.rev_msssim_weighted
        ps = self.per_sample(name)

        def weighted(hr, mask, pred, w):
            num, den = (ps(hr, mask, pred) * w).sum(), w.sum()
            if self.mesh is not None:
                num, den = all_sum(torch.stack([num, den]), self.mesh)
            return num / den

        return weighted
