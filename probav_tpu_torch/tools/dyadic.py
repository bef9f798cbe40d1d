"""Inputs for holding ``blk_bwd`` against its plain twin exactly.

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
both well inside float32's 24-bit significand; W2 dd sits on a 2**-15
grid and stays exact while |dd| stays below ~80, which these inputs keep
(dd is a sum of 864 terms of mean 0; its spread is ~2.4).  Every grid
value is exact in bf16, and so is the rounding of an exact value.
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
