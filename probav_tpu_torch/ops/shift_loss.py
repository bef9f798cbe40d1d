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

Reference quirks kept: the ground truth enters the residual UNMASKED
(occluded HR pixels add |HR| while the prediction is zeroed there), and the
normalizer is the count of clear pixels.  Losses take the min over shifts
then the mean over the batch; cPSNR takes the max over shifts and returns
the per-sample vector.

Batches are channels-last ``[B, H, W, C]`` as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from probav_tpu_torch.ops import shift_table


class ShiftCompensatedLosses:
    """The shift-compensated losses over [B, H, W, C] HR/mask/pred batches.

    ``target_shape`` is the HR patch shape, ``crop_border`` the per-side
    shift allowance, ``bit_depth`` sets the dynamic range of cPSNR;
    ``use_kernel`` takes the per-shift tables from the CUDA kernels.
    """

    def __init__(self, target_shape: Tuple[int, int, int] = (96, 96, 1),
                 crop_border: int = 3, bit_depth: int = 16,
                 use_kernel: bool = False):
        self.th, self.tw, self.tc = target_shape
        self.border = crop_border
        self.max_shift = 2 * crop_border
        self.num_bytes = float(2 ** bit_depth - 1)
        self.ch = self.th - self.max_shift
        self.cw = self.tw - self.max_shift
        self.use_kernel = use_kernel

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

    def by_name(self, name: str):
        """Cfg loss-key dispatch."""
        if name in ("sobel_l1_mix", "l1msssim"):
            raise NotImplementedError(
                f"loss {name!r} is not ported yet (l1 and l2 are)")
        return {"l1": self.l1, "l2": self.l2}[name]

    def per_sample(self, name: str):
        """Per-sample [B] variant (min over shifts, no batch mean):
        ``mean(per_sample(...)) == by_name(...)``."""
        self.by_name(name)
        return lambda hr, mask, pred: self._table(
            name, hr, mask, pred).min(dim=0).values

    def weighted(self, name: str):
        """fn(hr, mask, pred, w[B]) -> sum(per_sample * w) / sum(w): equals
        ``by_name(name)`` on the rows with w == 1 (padded eval rows carry
        w == 0)."""
        ps = self.per_sample(name)
        return lambda hr, mask, pred, w: (ps(hr, mask, pred) * w).sum() \
            / w.sum()
