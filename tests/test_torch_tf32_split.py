"""The 3xTF32 operand split of the float32 tensor-core kernels, in numpy.

``split_tf32`` (probav_tpu_torch/csrc/common.cuh) splits a float32 v into
hi = v rounded to TF32 (to nearest, ties away from zero, by two integer
operations on its bits) and lo = v - hi; a product a b is taken as
hi_a hi_b + lo_a hi_b + hi_a lo_b, with each operand read by the tensor
cores at TF32 (its top 19 bits).  The emulation below lives in this file,
not in the package: the package runs the split only on the card.

What it pins: the halves (hi TF32, hi + lo = v exactly, |lo| <= 2**-11 |v|),
the dyadic inputs of ``tools/dyadic.py`` that the kernels are held to
(x, w1, b1 and w2 are TF32 values, so z and its relu decision stay exact),
and W2 dd from three products within 2e-5 of float64 where dd (on a 2**-10
grid up to 216) is not TF32.  The products are exact in float64 and summed
there: the tensor cores' own truncating sums are not emulated.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from probav_tpu_torch.tools.dyadic import blk_bwd_inputs

torch.set_num_threads(1)

MASK = np.uint32(0xFFFFE000)   # sign, exponent and TF32's 10 mantissa bits


def split_tf32(v):
    """(hi, lo) float32 of float32 v, as common.cuh's split_tf32."""
    v = np.asarray(v, np.float32)
    hi = ((v.view(np.uint32) + np.uint32(0x1000)) & MASK).view(np.float32)
    return hi, (v - hi).astype(np.float32)


def tf32_read(v):
    """The TF32 operand the tensor cores read from float32 v."""
    return (np.asarray(v, np.float32).view(np.uint32) & MASK) \
        .view(np.float32)


def three_product_matmul(a, b):
    """a @ b as 3xTF32 (lo_a lo_b dropped, each lo read at TF32), the
    products and their sums in float64."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    d = np.float64
    return (ah.astype(d) @ bh.astype(d) + tf32_read(al).astype(d) @
            bh.astype(d) + ah.astype(d) @ tf32_read(bl).astype(d))


def values(kind, rng, n=200_000):
    if kind == "normal":
        return rng.normal(size=n).astype(np.float32)
    if kind == "wide_exponents":
        return (rng.normal(size=n) * 2.0 ** rng.integers(-60, 60, n)) \
            .astype(np.float32)
    return (rng.integers(-2 ** 17, 2 ** 17, n) * 2.0 ** -10).astype(
        np.float32)                           # dd's grid: 2**-10, to 128


@pytest.mark.parametrize("kind", ["normal", "wide_exponents", "dd_grid"])
def test_split_halves_are_tf32_and_sum_to_v(kind):
    v = values(kind, np.random.default_rng(0))
    hi, lo = split_tf32(v)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.array_equal(hi + lo, v)          # exact in float32
    assert (np.abs(lo) <= 2.0 ** -11 * np.abs(v)).all()
    # Rounded to nearest: hi is the TF32 value next to v, either side.
    assert (np.abs(lo) <= np.abs(v - tf32_read(v))).all()


def test_dyadic_blk_bwd_operands_split_exactly():
    """x, w1, b1, w2 (and gy, d, wc) of the kernel checks are TF32 values:
    lo = 0, so z = x W1 + b1 from TF32 products is exact."""
    gy, x, d, w1, b1, w2, wc = blk_bwd_inputs((2, 6, 6, 5), 32, 256, 25,
                                              seed=3)
    for name, t in (("gy", gy), ("x", x), ("d", d), ("w1", w1), ("b1", b1),
                    ("w2", w2), ("wc", wc)):
        hi, lo = split_tf32(t.numpy())
        assert not lo.any(), name
        assert np.array_equal(hi, t.numpy()), name


@pytest.mark.parametrize("kind", ["dyadic", "normal"])
def test_three_product_w2_dd_is_within_2e5_of_float64(kind):
    """W2 dd at 32/256/25, dd the conv transpose of gy (blk_bwd_plain's):
    three products within 2e-5 of max|ref| of float64, where one (hi hi,
    plain TF32) is not."""
    gy, x, d, w1, b1, w2, wc = blk_bwd_inputs((2, 6, 6, 5), 32, 256, 25,
                                              seed=3)
    if kind == "normal":
        r = np.random.default_rng(1)
        gy = torch.from_numpy(r.normal(size=gy.shape).astype(np.float32))
        wc = torch.from_numpy((r.normal(size=wc.shape) / 30)
                              .astype(np.float32))
        w2 = torch.from_numpy((r.normal(size=w2.shape) / 16)
                              .astype(np.float32))
    w = wc.double().permute(4, 3, 0, 1, 2)
    dd = F.conv_transpose3d(gy.double().permute(0, 4, 1, 2, 3), w,
                            padding=1).permute(0, 2, 3, 4, 1)
    dd = dd.reshape(-1, 25).float().numpy()
    if kind == "dyadic":   # exact in float32, but not a TF32 grid
        assert np.array_equal(dd, dd.astype(np.float64).astype(np.float32))
        assert split_tf32(dd)[1].any()
    w2t = w2.numpy().T                        # [c_dec, c_mid]
    ref = dd.astype(np.float64) @ w2t.astype(np.float64)
    scale = np.abs(ref).max()
    err3 = np.abs(three_product_matmul(dd, w2t) - ref).max() / scale
    err1 = np.abs(split_tf32(dd)[0].astype(np.float64) @
                  split_tf32(w2t)[0].astype(np.float64) - ref).max() / scale
    assert err3 <= 2e-5, err3
    assert err1 > 2e-5, err1


def test_three_product_wgrad_is_within_2e5_of_float64():
    """dWc of blk_bwd (wgrad_tf32_kernel's products), sum over positions of
    d shifted by the tap times gy, at 32/25 channels on random-normal d and
    gy: three products within 2e-5 of max|ref| of float64 for every tap,
    where one (hi hi, plain TF32) is not."""
    r = np.random.default_rng(2)
    b, h, w, t, c, c_dec = 2, 6, 6, 5, 32, 25
    d = r.normal(size=(b, h, w, t, c_dec)).astype(np.float32)
    gy = r.normal(size=(b, h, w, t, c)).astype(np.float32)
    dpad = np.pad(d, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
    g2 = gy.reshape(-1, c)
    err1 = err3 = 0.0
    refs = []
    for dh in range(3):
        for dw in range(3):
            for dt in range(3):
                ds = dpad[:, dh:dh + h, dw:dw + w, dt:dt + t]
                ds = ds.reshape(-1, c_dec).T
                refs.append((ds, ds.astype(np.float64) @ g2))
    scale = max(np.abs(ref).max() for _, ref in refs)
    for dst, ref in refs:
        err3 = max(err3, np.abs(three_product_matmul(dst, g2) - ref).max())
        err1 = max(err1, np.abs(split_tf32(dst)[0].astype(np.float64) @
                                split_tf32(g2)[0].astype(np.float64) -
                                ref).max())
    assert err3 / scale <= 2e-5, err3 / scale
    assert err1 / scale > 2e-5, err1 / scale
