"""Inputs for holding ``blk_bwd``, ``wide_bwd``, ``seg_fwd`` and the
shift-table kernels against their plain twins exactly.

The block backward takes two discontinuous decisions per element: the relu
derivative (z > 0) and, at bf16, the rounding of dd, dz and relu(z) to
bf16.  With random real-valued inputs, z sums 32 products in another order
in the kernel than in the plain version, and over 143 million z values of a
flagship launch a few land within one rounding of zero or of a bf16 tie:
those elements then differ by a whole dz, not by a rounding.  On the dyadic
grids below every product and every partial sum of z, of the conv
transpose dd and of W2 dd is a float32 number, so both versions compute
them exactly, in any order, and take the same decisions; what remains are
the order effects of the sums that follow (dx, the weight gradients).

Grids (value = integer * 2**-bits): x and gy in [-2, 2] step 2**-4; w1 and
b1 in [-0.25, 0.25] step 2**-6; w2 in [-0.25, 0.25] step 2**-5; wc in
[-0.125, 0.125] step 2**-6; d in [-2, 2] step 2**-4.  At the flagship
widths |z| <= 16.25 on a 2**-10 grid and |dd| <= 216 on a 2**-10 grid,
both well inside float32's 24-bit significand (at the widest, 128/1024/102:
|z| <= 64.25, |dd| <= 864); W2 dd sits on a 2**-15 grid and stays exact
while its partial sums stay below 2**9, which these inputs keep (dd is a
sum of 27 C terms of mean 0, spread ~2.4 at C = 32 and ~4.9 at 128; W2 dd
then spreads ~1.8 at 25 decay channels and ~7 at 102).  Every grid value
is exact in bf16, and so is the rounding of an exact value.

``wide_bwd`` (the flat expand -> relu -> decay backward) takes the same
decision, z > 0, and keeps dz in float32: with x and dy on the grid of x
above and w1, b1, w2 on theirs, z (|z| <= 64.25 at 128 input channels,
on a 2**-10 grid) and W2 dy (|W2 dy| <= 64 at 128 output channels, on a
2**-9 grid) are exact in any order at every width the kernel takes.

``seg_fwd`` (expand -> relu -> decay) rounds h = relu(z) to bf16 before
the decay.  With x, w1, b1 on the grids above, w2 in [-0.25, 0.25] step
2**-3 and b2 in [-0.25, 0.25] step 2**-6, at C <= 32 and C_mid <= 256: z
is exact (|z| <= 16.25 on a 2**-10 grid), h stays on that grid in bf16,
each h w2 sits on a 2**-13 grid with |h w2| <= 4.0625, so every partial
sum of d (|d| <= 256 * 4.0625 + 0.25 < 2**11) holds in float32's 24 bits
in any order, and the kernels and the plain version agree bit for bit.

The shift tables decide sign(r) for the L1 backward.  With integer planes
below 2**12 and a 0/1 mask, the window sums of m, hr and p*m (at most
42 * 42 * 4095 < 2**24) are exact in any order, so the bias, one division
of exact numbers, and every residual r are the same in both versions.
"""

from __future__ import annotations

import numpy as np
import torch


def grid(rng: np.random.Generator, shape, lim: int, bits: int):
    """float32 integers in [-lim, lim] times 2**-bits."""
    return (rng.integers(-lim, lim + 1, shape) * 2.0 ** -bits) \
        .astype(np.float32)


def blk_bwd_inputs(shape, c, cmid, cdec, seed=0, device="cpu",
                   dtype=torch.float32):
    """(gy, x, d, w1, b1, w2, wc) for one block of activations
    ``shape + (c,)`` on the grids of the module docstring."""
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device, dtype)
    return (t(grid(r, shape + (c,), 32, 4)), t(grid(r, shape + (c,), 32, 4)),
            t(grid(r, shape + (cdec,), 32, 4)), t(grid(r, (c, cmid), 16, 6)),
            t(grid(r, (cmid,), 16, 6)), t(grid(r, (cmid, cdec), 8, 5)),
            t(grid(r, (3, 3, 3, cdec, c), 8, 6)))


def wide_bwd_inputs(n, c, cmid, cdec, seed=0, device="cpu",
                    dtype=torch.float32):
    """(x [n, c], w1, b1, w2, dy [n, cdec]) on the grids above."""
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device, dtype)
    return (t(grid(r, (n, c), 32, 4)), t(grid(r, (c, cmid), 16, 6)),
            t(grid(r, (cmid,), 16, 6)), t(grid(r, (cmid, cdec), 8, 5)),
            t(grid(r, (n, cdec), 32, 4)))


def seg_fwd_inputs(n, c, cmid, cdec, seed=0, device="cpu",
                   dtype=torch.float32):
    """(x [n, c], w1, b1, w2, b2) on the seg_fwd grids above."""
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device, dtype)
    return (t(grid(r, (n, c), 32, 4)), t(grid(r, (c, cmid), 16, 6)),
            t(grid(r, (cmid,), 16, 6)), t(grid(r, (cmid, cdec), 2, 3)),
            t(grid(r, (cdec,), 16, 6)))


# The shift tables against their plain twins on these integer planes
# (same residuals in both versions): (rtol, atol as a fraction of max|ref|)
# elementwise, the table to 3e-5, d/dpred to 1e-4 plus 1e-6 of max|ref|
# (tests/test_pallas.py holds the TPU kernels to these).
SHIFT_TOL = {"shift_table_fwd": (3e-5, 0.0), "shift_table_bwd": (1e-4, 1e-6)}


def shift_table_inputs(b, size=48, border=3, clear=0.8, seed=0,
                       device="cpu"):
    """(hr, m, p [b, size, size], g [b, (2 border + 1)**2]) float32: hr and
    p integers in [0, 4095], m 1 on ``clear`` of the pixels, hr zeroed
    where m is 0 (with the occluded truth kept, the bias term makes every
    clear L1 residual one sign), g normal."""
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    m = r.uniform(size=(b, size, size)) < clear
    hr = r.integers(0, 4096, (b, size, size)) * m
    p = r.integers(0, 4096, (b, size, size))
    g = r.normal(size=(b, (2 * border + 1) ** 2))
    return t(hr), t(m), t(p), t(g)
