"""The index map of the float32 tensor-core seg_fwd beyond the flagship's
widths, in numpy.

``seg_fwd_tf32_wide_kernel`` (probav_tpu_torch/csrc/tstack.cu) computes
d = relu(x W1 + b1) W2 + b2 as 3xTF32 on mma.sync m16n8k8 at c_in, c_dec
<= 64 and c_mid <= 512 (the 64-filter model's 64/512/51), where W1 and W2
do not fit a block's shared memory whole:

- C_mid in chunks of SFW_JC = 128 middle channels, each staged by cp.async
  as W1's [c][j] plane (row stride SFW_WS = 136; zeros from c_in and c_mid
  on) and W2's [j][c] plane (W2's rows as they lie in memory, row stride
  SFW_XS = 68; zeros from c_mid on, its columns from c_dec on zeroed once);
  a tile's chunks in order, the weights staged again for every tile;
- x in tiles of SFW_ROWS = 128 rows, row stride 68 (columns from c_in on
  are never written; rows past n are zeros); warp w owns rows 16 w ..
  16 w + 15;
- fragments (g = lane // 4, q = lane % 4; common.cuh, mma_tf32): A (16 x
  8) holds (g, q), (g+8, q), (g, q+4), (g+8, q+4); B (8 x 8) rows q and
  q+4 of column g; C (16 x 8) rows g, g+8 at columns 2q, 2q+1;
- expand: x's A fragments of the KS k-steps (zero from column c_in on)
  split once a tile; per group of four 8-column n-tiles of a chunk, z = x
  W1 from B rows k*8 + q (+4) of column jn + t*8 + g, three products (hi
  hi, lo hi, hi lo);
- decay: h = relu(z + b1) from C columns 2q, 2q+1 fed as A columns q,
  q+4, with W2's B rows jl = jn + t*8 + 2q and jl + 1 of column ct*8 + g
  (NCT n-tiles: C_dec padded to 8 NCT); each chunk's products in fresh
  sums, added to the running sums;
- epilogue: + b2, staged in the warp's own rows of the x tile, stored as
  the contiguous run of its rows' c_dec real columns, nothing past n.

The twin repeats that map register by register: fragments are gathered by
lane from the staged planes, each mma rebuilds its A, B and C matrices
from the lanes' registers (the split and the products of
``test_torch_seg_fwd_tf32_layout.mma3``, rounded to float32 per mma; the
tensor cores' truncating sums are not emulated).  It is held to float64
and to the JAX package's Pallas ``seg_fwd`` (interpret mode) at 2e-5 of
max|ref|, the float32 kernel tolerance; twins that stage a chunk's W2 rows
off by one row pair, or skip the C -> A permutation, are not.  The kernel
runs only on the card; this pins what it addresses.
"""

import re

import numpy as np
import pytest
import torch

from probav_tpu_torch.ops import _build
from probav_tpu_torch.ops import tstack as ts
from test_torch_seg_fwd_tf32_layout import (G_, LANE, Q_, TOL, float64_ref,
                                            inputs, jax_pallas_seg_fwd,
                                            max_rel, mma3)

torch.set_num_threads(1)

WARPS, JC, GROUP, CH, MID = 8, 128, 4, 64, 512   # tstack.cu's SFW_*
ROWS, XS, WS = 16 * WARPS, CH + 4, JC + 8
OPTIN = 232_448
# (n, c_in, c_mid, c_dec): the 64- and 48-filter models' widths on rows
# below one tile; C_in no multiple of 4 with C_mid cut inside a chunk (and
# no multiple of 4) and C_dec > C_in on ragged rows over three tiles; one
# row with C_mid below one chunk and C_dec 57 (eight d n-tiles).
WIDTHS = [(40, 64, 512, 51), (36, 48, 384, 38), (300, 37, 300, 45),
          (1, 33, 100, 57)]
IDS = ["c64_n40", "c48_n36", "c37_cmid300_n300", "c33_cdec57_n1"]


def widths_of(c_in, c_dec):
    """(KS, NCT) of launch_seg_fwd_tf32_wide: k-steps over c_in and 8-column
    n-tiles of d."""
    if c_in <= 48 and c_dec <= 40:
        return 6, 5
    return (8, 7) if c_dec <= 56 else (8, 8)


def stage_chunk(w1, w2, ch, w2_shift=0):
    """Chunk ch's W1 [c][j] and W2 [j][c] planes as stage_w leaves them
    (W1's pad columns NaN: never read).  ``w2_shift`` stages W2 from row
    j0 + w2_shift on, the fault a wrong chunk offset makes."""
    c_in, c_mid = w1.shape
    c_dec = w2.shape[1]
    j0 = ch * JC
    p1 = np.full((CH, WS), np.nan, np.float32)
    p1[:, :JC] = 0.0
    nj = min(JC, c_mid - j0)
    p1[:c_in, :nj] = w1[:, j0:j0 + nj]
    p2 = np.zeros((JC, XS), np.float32)
    src = w2[j0 + w2_shift:j0 + w2_shift + nj]
    p2[:len(src), :c_dec] = src
    return p1, p2


def twin(x, w1, b1, w2, b2, permute=True, w2_shift=0):
    """d [n, c_dec] as seg_fwd_tf32_wide_kernel addresses and sums it.
    ``permute=False`` feeds h's C registers to the decay in their own
    order (a0..a3 = c0..c3)."""
    n, c_in = x.shape
    c_mid, c_dec = w2.shape
    ks, nct = widths_of(c_in, c_dec)
    nch = -(-c_mid // JC)
    b1s = np.zeros(MID, np.float32)
    b1s[:c_mid] = b1
    b2s = np.zeros(CH, np.float32)
    b2s[:c_dec] = b2
    tiles = -(-n // ROWS)
    xt = np.full((tiles * ROWS, XS), np.nan, np.float32)
    xt[:, :c_in] = 0.0
    xt[:n, :c_in] = x
    X = xt.reshape(tiles * WARPS, 16, XS)         # a warp's 16 rows
    nw = X.shape[0]

    ax = []
    for k in range(ks):
        c = k * 8 + Q_
        lo, hi = c < c_in, c + 4 < c_in
        ax.append((np.where(lo, X[:, G_, c], 0),
                   np.where(lo, X[:, G_ + 8, c], 0),
                   np.where(hi, X[:, G_, c + 4], 0),
                   np.where(hi, X[:, G_ + 8, c + 4], 0)))
    zero = lambda: [np.zeros((nw, 32), np.float32) for _ in range(4)]
    acc = [zero() for _ in range(nct)]
    for ch in range(nch):
        p1, p2 = stage_chunk(w1, w2, ch, w2_shift)
        dc = [zero() for _ in range(nct)]
        for jn in range(0, JC, 8 * GROUP):
            z = [zero() for _ in range(GROUP)]
            for k in range(ks):
                for t in range(GROUP):
                    col = jn + t * 8 + G_
                    bw = (p1[k * 8 + Q_, col], p1[k * 8 + Q_ + 4, col])
                    z[t] = mma3(z[t], ax[k], bw)
            for t in range(GROUP):
                jl = jn + t * 8 + 2 * Q_
                bb = (b1s[ch * JC + jl], b1s[ch * JC + jl + 1])
                h = [np.maximum(z[t][i] + bb[i & 1], 0) for i in range(4)]
                ah = (h[0], h[2], h[1], h[3]) if permute else tuple(h)
                for ct in range(nct):
                    bd = (p2[jl, ct * 8 + G_], p2[jl + 1, ct * 8 + G_])
                    dc[ct] = mma3(dc[ct], ah, bd)
        acc = [[a + b for a, b in zip(acc[ct], dc[ct])] for ct in range(nct)]

    for ct in range(nct):
        cc = ct * 8 + 2 * Q_
        X[:, G_, cc] = acc[ct][0] + b2s[cc]
        X[:, G_, cc + 1] = acc[ct][1] + b2s[cc + 1]
        X[:, G_ + 8, cc] = acc[ct][2] + b2s[cc]
        X[:, G_ + 8, cc + 1] = acc[ct][3] + b2s[cc + 1]
    d = np.empty(n * c_dec, np.float32)
    for w in range(nw):
        r0 = w * 16
        nr = max(0, min(16, n - r0))
        e = np.arange(nr * c_dec)
        d[r0 * c_dec + e] = X[w, e // c_dec, e % c_dec]
    return d.reshape(n, c_dec)


@pytest.mark.parametrize("n,c_in,c_mid,c_dec", WIDTHS, ids=IDS)
def test_wide_twin_matches_float64_and_jax_pallas(n, c_in, c_mid, c_dec,
                                                  monkeypatch):
    args = inputs(n, c_in, c_mid, c_dec, seed=n + c_in)
    got = twin(*args)
    assert got.shape == (n, c_dec) and np.isfinite(got).all()
    assert max_rel(got, float64_ref(*args)) < TOL
    ref = jax_pallas_seg_fwd(*args, monkeypatch).astype(np.float64)
    assert max_rel(got, ref) < TOL
    # ... and the port's plain version, the kernel's reference on the card.
    plain = ts.seg_fwd_plain(*(torch.from_numpy(a) for a in args)).numpy()
    assert max_rel(plain, ref) < TOL


@pytest.mark.parametrize("kw", [dict(permute=False), dict(w2_shift=2)],
                         ids=["no_permutation", "w2_rows_offset"])
def test_wrong_wide_twins_fail(kw, monkeypatch):
    """Without the C -> A permutation h's middle channels meet the wrong W2
    rows; a chunk's W2 staged one row pair late does the same: both far
    beyond the tolerance of the JAX reference at 64/512/51."""
    args = inputs(40, 64, 512, 51, seed=104)
    ref = jax_pallas_seg_fwd(*args, monkeypatch).astype(np.float64)
    assert max_rel(twin(*args, **kw), ref) > 1e-2


def test_wide_mirror_matches_the_source():
    """The constants and the width rule above are the kernel's."""
    src = (_build.SRC_DIR / "tstack.cu").read_text()
    got = {k: int(v) for k, v in re.findall(
        r"constexpr int SFW_(\w+) = (\d+);", src)}
    assert got == dict(WARPS=WARPS, JC=JC, GROUP=GROUP, CH=CH, MID=MID)
    for name, want in (("ROWS", "16 * SFW_WARPS"), ("XS", "SFW_CH + 4"),
                       ("WS", "SFW_JC + 8")):
        assert f"constexpr int SFW_{name} = {want};" in src, name
    for c_in, c_dec, ks, nct in ((48, 40, 6, 5), (64, 51, 8, 7),
                                 (48, 41, 8, 7), (64, 57, 8, 8)):
        assert widths_of(c_in, c_dec) == (ks, nct)
    assert "if (c_in <= 48 && c_dec <= 40)" in src
    assert "return launch_seg_fwd_tf32_wide_as<6, 5>(" in src
    assert "if (c_dec <= 56)" in src
    assert "return launch_seg_fwd_tf32_wide_as<8, 7>(" in src
    assert ("const bool wide = c_in <= SFW_CH && c_dec <= SFW_CH && "
            "c_mid <= SFW_MID;") in src
    assert "wide ? SEG_FWD_TF32_WIDE : SEG_FWD_CUDA_CORES" in src
    assert "SEG_FWD_TF32_WIDE = 4" in src
    assert ts.SEG_FWD_ROUTES[4].startswith("seg_fwd_tf32_wide_kernel ")


def test_wide_layout_fits_and_its_loads_are_conflict_free():
    """211,200 of a block's 232,448 bytes (two weight chunks, two x tiles,
    b1, b2), every region 16-byte aligned; every 32-lane fragment load
    (x's A words, W1's and W2's B words) falls in distinct banks."""
    wbuf = CH * WS + JC * XS
    offsets = (0, wbuf, 2 * wbuf, 2 * wbuf + CH * WS,
               2 * wbuf + ROWS * XS, 2 * wbuf + 2 * ROWS * XS,
               2 * wbuf + 2 * ROWS * XS + MID)
    assert all(o % 4 == 0 for o in offsets)
    assert 4 * (2 * wbuf + 2 * ROWS * XS + MID + CH) == 211_200 <= OPTIN
    banks = lambda a: len(set(np.asarray(a) % 32))
    for k in range(8):
        x_lo = G_ * XS + k * 8 + Q_
        assert banks(x_lo) == banks(x_lo + 4) == 32       # a0, a2 (a1, a3:
        assert banks(x_lo + 8 * XS) == 32                 # rows g + 8)
        for jn in (0, 8, 96, 120):
            w1 = (k * 8 + Q_) * WS + jn + G_
            assert banks(w1) == banks(w1 + 4 * WS) == 32
    for jn in (0, 8, 96, 120):
        for ct in range(8):
            w2 = (jn + 2 * Q_) * XS + ct * 8 + G_
            assert banks(w2) == banks(w2 + XS) == 32
    assert LANE.size == 32


def test_wide_variants_tool_applies_to_the_kernel_source():
    """tools/seg_fwd_variants.py --dtype float32 --section wide builds its
    variants by substitution in the kernel's section of tstack.cu: every
    substitution still finds its text, each variant gets its own copy of
    the kernel and a launch case, and the grid-split variant launches
    dx_sum_kernel<float> after it; the flagship's float32 section ends
    where this one starts."""
    from probav_tpu_torch.tools import seg_fwd_variants as sv
    names = list(sv.WIDE_VARIANTS)
    src = sv.source(names, "wide")
    assert src.count("\nseg_fwd_tf32_wide_kernel(const float* __restrict__ "
                     "x,") == len(names)
    for i in range(len(names)):
        assert f"if (v == {i}) return v{i}::launch_seg_fwd_tf32_wide(" in src
    split = sv.source(["grid_split"], "wide")
    assert "launch_dx_sum(" in split and "dx_sum_kernel(" in split
    assert "seg_fwd_tf32_wide_kernel" not in sv.source(["kernel"], "float32")
