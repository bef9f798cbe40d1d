"""The addressing of the bf16 tensor-core wgrad (dWc of ``blk_bwd``), in
numpy.

``wgrad_ring_kernel`` (probav_tpu_torch/csrc/blk_bwd.cu) computes
dWc[tap] = sum_q d(q + off(tap)) gy(q)^T from staged tiles: each row of d
as a zero-padded (W+2) x (T+2) halo grid of [position][CSP = 40] slots,
the row of gy as [position][40] over its W*T positions with K rounded up
to 16; gy position k = w T + t reads halo row prow[k] + (dw - 1)(T+2) +
dt - 1 at tap (dw, dt), and past the row it reads position 0's rows
against a zero gy.  G blocks each walk a contiguous run of (b, h) items
with rows h - 1 .. h + 1 of d in ring slots row % 3, restaging the rows
around h at their first item and at each image's row 0, and one new row
per item otherwise.  The twin below repeats that index math and that
schedule (which rows are staged, into which slot, which slot each h tap
reads) and is held to ``blk_bwd_plain``'s dWc.  The kernel runs only on
the card; this pins what it addresses.

On the dyadic inputs of ``tools/dyadic.py`` (d and gy on a 2**-4 grid in
[-2, 2]) every product is on a 2**-8 grid and every partial sum stays
below 2**14 at these sizes, so float32 sums are exact in any order and
the twin must equal the plain dWc bit for bit: a wrong row, shift or slot
moves whole products.
"""

import numpy as np
import pytest
import torch

from probav_tpu_torch.ops import tstack as ts
from probav_tpu_torch.tools.dyadic import blk_bwd_inputs

torch.set_num_threads(1)

CSP = 40            # bf16 channel stride of a staged position (WGR_CSP)
H100_SLOTS = 264    # partial_slots on an H100 up to 64 channels: 2 x 132


def npk_of(w, t):
    return (w * t + 15) // 16 * 16


def prow_of(w, t):
    """The halo row of each gy position's centre tap; position 0's past
    the row."""
    k = np.arange(npk_of(w, t))
    p = np.where(k < w * t, k, 0)
    return (p // t + 1) * (t + 2) + p % t + 1


def stage(row, prow, rows):
    """One row [W, T, cn] of d (into halo rows prow) or of gy (into rows
    0..W*T-1): channels 0..32, zero from cn, the rest of the slot zero."""
    w, t, cn = row.shape
    slot = np.zeros((rows, CSP), np.float32)
    idx = prow[:w * t] if prow is not None else np.arange(w * t)
    slot[idx, :cn] = row.reshape(w * t, cn)
    return slot


def first_row(item, i0, h_n):
    """The first d row an item stages, or -1 (the kernel's first_row)."""
    h = item % h_n
    lo = max(h - 1, 0) if (item == i0 or h == 0) else h + 1
    return lo if lo < h_n else -1


def wgrad_twin(d, gy, groups):
    """dWc [27, c_dec, c_out] as the kernel's G blocks compute it, their
    float32 slots summed in order; also the number of d rows staged."""
    b_n, h_n, w, t, c_dec = d.shape
    c_out = gy.shape[-1]
    prow = prow_of(w, t)
    npk, halo = len(prow), (w + 2) * (t + 2)
    items = b_n * h_n
    per = -(-items // groups)
    part = np.zeros((groups, 27, c_dec, c_out), np.float32)
    staged = 0
    for blk in range(groups):
        i0 = min(items, blk * per)
        i1 = min(items, i0 + per)
        slots = [np.zeros((halo, CSP), np.float32) for _ in range(3)]
        held = [None] * 3
        acc = np.zeros((27, 32, 32), np.float32)
        for item in range(i0, i1):
            b, h = divmod(item, h_n)
            lo, hi = first_row(item, i0, h_n), min(h + 1, h_n - 1)
            gsl = stage(gy[b, h], None, npk)
            if lo >= 0:
                for r in range(lo, hi + 1):
                    slots[r % 3] = stage(d[b, r], prow, halo)
                    held[r % 3] = (b, r)
                    staged += 1
            for dh in range(3):
                hh = h + dh - 1
                if not 0 <= hh < h_n:
                    continue   # the warp skips a zero row
                assert held[hh % 3] == (b, hh), (item, dh, held)
                for dw in range(3):
                    for dt in range(3):
                        rows = prow + (dw - 1) * (t + 2) + dt - 1
                        assert rows.min() >= 0 and rows.max() < halo
                        a = slots[hh % 3][rows, :32]      # [npk, c]
                        acc[dh * 9 + dw * 3 + dt] += a.T @ gsl[:, :32]
        part[blk] = acc[:, :c_dec, :c_out]
    out = np.zeros((27, c_dec, c_out), np.float32)
    for g in range(groups):
        out += part[g]
    return out, staged


@pytest.mark.parametrize("shape,c,cmid,cdec,groups", [
    ((3, 7, 6, 5), 8, 64, 6, H100_SLOTS),
    ((3, 7, 6, 5), 8, 64, 6, 4),
    ((2, 4, 48, 9), 32, 256, 25, 3),
    ((1, 3, 5, 19), 32, 256, 32, 2),
    ((2, 3, 6, 5), 32, 256, 25, H100_SLOTS)],
    ids=["small", "small_g4", "w48", "t19_cdec32", "bh_below_g"])
def test_wgrad_ring_twin_matches_plain_dwc(shape, c, cmid, cdec, groups):
    """Small widths with every item its own block and with runs that
    start mid-image (G = 4: blocks restart at h = 6, 5, 4 ...), W = 48, T
    = 19 with c_dec = c_out = 32, and fewer items than blocks (B*H = 6 of
    264 slots: the rest hold zeros)."""
    gy, x, d, w1, b1, w2, wc = blk_bwd_inputs(shape, c, cmid, cdec, seed=4)
    want = ts.blk_bwd_plain(gy, x, d, w1, b1, w2, wc)[1]
    got, staged = wgrad_twin(d.numpy(), gy.numpy(), groups)
    np.testing.assert_array_equal(got.reshape(3, 3, 3, cdec, c),
                                  want.numpy())
    # Each d row is staged once per block that reads it: B*H rows, plus
    # the halo rows of each block's restart mid-image.
    b_n, h_n = shape[:2]
    per = -(-(b_n * h_n) // groups)
    restarts = sum(1 for i0 in range(0, b_n * h_n, per) if i0 % h_n)
    assert b_n * h_n <= staged <= b_n * h_n + 2 * restarts


def wgrad_ring_smem(w, t, c_dec, c_out):
    """Shared-memory bytes of wgrad_ring_kernel (blk_bwd.cu's
    wgrad_ring_smem): three d slots, the gy slot, the raw rows of d and gy
    (copied from the 16-byte chunk below their start) and prow."""
    run_buf = lambda n: (n + 43) // 16 * 16
    wt = w * t
    return (2 * CSP * (3 * (w + 2) * (t + 2) + npk_of(w, t)) +
            run_buf(2 * wt * c_dec) + run_buf(2 * wt * c_out) +
            4 * npk_of(w, t))


def test_wgrad_ring_layout_fits_the_routed_shapes():
    """The layouts the kernel's notes give: 22 x 9 (the flagship), W = 48
    and T = 19 fit an H100's 232,448 bytes a block; W = 100 does not and
    takes the CUDA-core wgrad."""
    optin = 232_448
    assert wgrad_ring_smem(22, 9, 25, 32) == 103_472
    assert wgrad_ring_smem(48, 9, 25, 32) == 217_600 <= optin
    assert wgrad_ring_smem(22, 19, 25, 32) == 204_960 <= optin
    assert wgrad_ring_smem(100, 9, 25, 32) > optin
    assert npk_of(22, 9) == 208 and prow_of(22, 9)[197] == 22 * 11 + 9
