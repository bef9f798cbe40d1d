"""The addressing of the bf16 tensor-core seg_fwd past the flagship's
widths, in numpy.

``seg_fwd_bf16_wide_kernel`` (probav_tpu_torch/csrc/tstack.cu) computes
d = bf16(bf16(relu(x W1 + b1)) W2 + b2), sums in float32, on mma.sync
m16n8k16 (fragment layouts in common.cuh), for C_in, C_dec <= 64 and
C_mid <= 512 where ``seg_fwd_bf16_kernel``'s tiles end (the 64-filter
model's 64/512/51, and 48/384/38):

- shared memory, in bf16 elements: W1 as it lies in memory, [k][j], and
  W2 as [c][j], both 64 rows of WS = 520 and zeroed first; W1's rows by
  16-byte copies (element by element where C_mid % 8 != 0 or w1 is not
  16-byte aligned), W2 scattered from the flat array by 16-byte chunks
  (element by element where it is not aligned, and at the tail); two x
  tiles [ROWS = 256][XS = 72]; b1 and b2 in float32 beside them;
- instantiations <KS, NT>: KS k-steps of 16 inputs, NT n-tiles of 8
  outputs, by the launcher's rule (<3, 5> at C_in <= 48 and C_dec <= 40,
  <4, 7> at C_dec <= 56, <4, 8>);
- x rows land by 16-byte copies where C_in % 8 == 0 and x is 16-byte
  aligned, else element by element; every copy writes the 16 KS columns
  the fragments read, zeros from C_in on and past n;
- warp w owns rows 32 w .. 32 w + 31 of a tile, MT = 2 row tiles of 16,
  whose A fragments are plain ldmatrix.x4 of x; per step of 16 middle
  channels KS ldmatrix.x4.trans of W1 [k][j] (load i reads matrix m = 4 i
  + lane / 8: inputs 8 (m % 2KS) .., middle channels 16 s + 8 (m / 2KS)
  ..) give the expand's B fragments and ceil(NT / 2) plain ldmatrix.x4 of
  W2 [c][j] the decay's, each used for both row tiles; z starts from b1
  in the mma's C registers; h = bf16(relu(z)) in pairs, and the two
  8-column C tiles of z are the decay's A fragment; steps go in pairs
  through two fragment sets, none past C_mid;
- epilogue: d = acc + b2, rounded to bf16, staged in the warp's own rows
  of the x tile it has read, at d's 16-byte skew, as the contiguous run
  of its rows' C_dec columns, then stored as whole 16-byte chunks and
  element by element at the run's two ends; nothing past n.

The twin below models shared memory as one flat array with the kernel's
offsets (NaN where nothing was written), performs every ldmatrix by the
lanes' addresses (checking their 16-byte alignment), rebuilds each mma's
A, B and C matrices from the lanes' registers, and writes d through the
same span and chunk stores into a buffer with guard elements.  It is held
to ``seg_fwd_plain`` bit for bit on the bf16 dyadic inputs of
``tools/dyadic.seg_fwd_inputs`` (every sum exact in float32), and to the
JAX package's Pallas ``seg_fwd`` in interpret mode at bf16 within 2e-2 of
max|ref|, the bf16 kernel tolerance.  A twin that reads W1 transposed
(without .trans), or whose copies leave x's pad columns as they were
(NaN here, or the d a previous tile staged there), is not.  The kernel
runs only on the card; this pins what it addresses.
"""

import re

import numpy as np
import pytest
import torch

import test_torch_seg_bwd_mma_layout as mma_twin
from probav_tpu_torch.ops import _build
from probav_tpu_torch.ops import tstack as ts
from test_torch_seg_bwd_mma_layout import bf16, mma
from test_torch_seg_fwd_bf16_layout import (dyadic, jax_pallas_seg_fwd,
                                            max_rel)

torch.set_num_threads(1)

WARPS, MT, MINB, CH, MID = 8, 2, 1, 64, 512      # tstack.cu's SFBW_*
ROWS, XS, WS = 16 * MT * WARPS, CH + 8, MID + 8
OPTIN = 232_448
LANE = np.arange(32)
G_, Q_ = LANE // 4, LANE % 4
L8, M2, H16, L_8 = LANE % 8, (LANE // 8) % 2, LANE // 16, LANE // 8
TOL = 2e-2
# (n, c_in, c_mid, c_dec): the 64- and 48-filter models' widths over
# ragged tiles; C_in no multiple of 8 (element copies) with C_mid cut
# inside an odd step count; C_dec 57 (eight n-tiles) above C_in at one
# row; C_dec below 32 with C_mid past 256.
SHAPES = [(600, 64, 512, 51), (300, 48, 384, 38), (129, 37, 300, 45),
          (1, 33, 100, 57), (40, 7, 260, 12)]
IDS = ["w64_n600", "w48_n300", "c37_cmid300_n129", "cdec57_n1",
       "c7_cmid260_n40"]


def widths_of(c_in, c_dec):
    """<KS, NT> of the launcher's instantiation for these widths."""
    if c_in <= 48 and c_dec <= 40:
        return 3, 5
    return (4, 7) if c_dec <= 56 else (4, 8)


def smem_bytes(warps=WARPS, mt=MT):
    """tstack.cu's seg_fwd_bf16_wide_smem: W1, W2 and two x tiles in bf16,
    b1 and b2 in float32."""
    rows = 16 * mt * warps
    return 2 * (2 * CH * WS + 2 * rows * XS) + 4 * (MID + CH)


class Smem(mma_twin.Smem):
    """The kernel's shared memory in bf16 elements (held as float32), NaN
    where nothing was written; b1 and b2 apart, in float32."""

    def __init__(self):
        self.w1s = 0                          # [CH][WS]  W1 [k][j]
        self.w2s = CH * WS                    # [CH][WS]  W2 [c][j]
        self.xb = self.w2s + CH * WS          # [2][ROWS][XS]
        self.m = np.full(self.xb + 2 * ROWS * XS, np.nan, np.float32)


def stage_transposed(S, base, stride, src):
    """stage_transposed: the flat [rows][cols] src (16-byte aligned) into
    the plane at base as [col][row], by 16-byte chunks (r, c advanced
    element by element, wrapping at cols), the tail element by element."""
    rows, cols = src.shape
    flat = src.reshape(-1)
    total = flat.size
    body = total // 8 * 8
    for e0 in range(0, body, 8):
        r, c = divmod(e0, cols)
        for k in range(8):
            S.m[base + c * stride + r] = flat[e0 + k]
            c += 1
            if c == cols:
                c, r = 0, r + 1
    for e in range(body, total):
        S.m[base + (e % cols) * stride + e // cols] = flat[e]


def twin(x, w1, b1, w2, b2, w1_trans=True, copy_pad=True, x_off=0,
         d_off=0):
    """d [n, c_dec] as seg_fwd_bf16_wide_kernel addresses and sums it, for
    one block walking every tile.  x lies ``x_off`` elements past a
    16-byte boundary (16-byte copies only where C_in % 8 == 0 and x_off %
    8 == 0), d ``d_off``, the weights on the 16-byte grid.
    ``w1_trans=False`` reads W1's fragments without .trans;
    ``copy_pad=False`` copies x's columns below C_in only."""
    n, c_in = x.shape
    c_mid, c_dec = w2.shape
    ks_, nt = widths_of(c_in, c_dec)
    K, NP = 16 * ks_, (nt + 1) // 2
    S = Smem()
    S.m[S.w1s:S.xb] = 0.0
    if c_mid % 8 == 0:   # W1's rows by 16-byte copies: both ends aligned
        for k in range(c_in):
            for j in range(0, c_mid, 8):
                assert (k * c_mid + j) % 8 == 0 and (k * WS + j) % 8 == 0
    S.m[S.w1s + np.arange(c_in)[:, None] * WS + np.arange(c_mid)] = w1
    stage_transposed(S, S.w2s, WS, w2)
    b1s = np.zeros(MID, np.float32)
    b1s[:c_mid] = b1
    b2s = np.zeros(CH, np.float32)
    b2s[:c_dec] = b2
    xvec = c_in % 8 == 0 and x_off % 8 == 0
    guard = 8
    dflat = np.full(d_off + n * c_dec + 2 * guard, np.nan, np.float32)
    steps = -(-c_mid // 16)
    W = np.arange(WARPS)[:, None]
    rw = 16 * MT * W                                          # [W, 1]
    xoff = (L8 + 8 * M2) * XS + 8 * H16
    mi = 4 * np.arange(ks_)[:, None] + L_8                    # [KS, 32]
    w1off = (8 * (mi % (2 * ks_)) + L8) * WS + 8 * (mi // (2 * ks_))
    w2off = (8 * H16 + L8) * WS + 8 * M2
    for tile in range(-(-n // ROWS)):
        xt = S.xb + tile % 2 * ROWS * XS
        row0, nr = tile * ROWS, min(ROWS, n - tile * ROWS)
        cols = K if copy_pad else c_in
        rows = np.zeros((ROWS, cols), np.float32)
        rows[:nr, :min(c_in, cols)] = x[row0:row0 + nr, :cols]
        if xvec:   # 16-byte chunks: both ends 16-byte aligned
            for ch in range(-(-cols // 8)):
                src = x_off + (row0 + np.arange(ROWS)) * c_in + 8 * ch
                dst = xt + np.arange(ROWS) * XS + 8 * ch
                assert (src % 8 == 0).all() and (dst % 8 == 0).all()
                S.m[dst[:, None] + np.arange(8)] = rows[:, 8 * ch:8 * ch + 8]
        else:
            S.m[xt + np.arange(ROWS)[:, None] * XS + np.arange(cols)] = rows

        ax = np.stack([np.stack([S.ldsm(xt + (rw + 16 * m) * XS + 16 * k +
                                        xoff) for k in range(ks_)])
                       for m in range(MT)])        # [MT, KS, W, 4, 32, 2]
        acc = np.zeros((MT, nt, WARPS, 4, 32), np.float32)
        for s in range(steps):
            f1 = S.ldsm(S.w1s + 16 * s + w1off, trans=w1_trans)
            f2 = S.ldsm(S.w2s + 16 * np.arange(NP)[:, None] * WS + 16 * s +
                        w2off)                     # [NP, 4, 32, 2]
            f1 = f1.reshape(4 * ks_, 32, 2)        # matrix m = 4 i + r
            bias = np.stack([np.stack([b1s[16 * s + 8 * t + 2 * Q_ + i % 2]
                                       for i in range(4)])
                             for t in range(2)])   # [2, 4, 32]
            z = np.broadcast_to(bias[None, :, None],
                                (MT, 2, WARPS, 4, 32)).astype(np.float32)
            for k in range(ks_):
                b0 = np.stack([f1[2 * ks_ * t + 2 * k] for t in range(2)])
                b1_ = np.stack([f1[2 * ks_ * t + 2 * k + 1]
                                for t in range(2)])
                z = mma(z, ax[:, k, None], b0[None, :, None],
                        b1_[None, :, None])
            # relu and bf16 in pairs: (c0, c1) and (c2, c3) of each C tile
            # are a0, a1 (t = 0) and a2, a3 (t = 1).
            ah = np.stack([bf16(np.maximum(
                np.stack([z[:, t, :, 2 * h], z[:, t, :, 2 * h + 1]], -1), 0))
                for t in range(2) for h in range(2)], 2)  # [MT, W, 4, 32, 2]
            b0 = np.stack([f2[ct // 2, 2 * (ct % 2)] for ct in range(nt)])
            b1_ = np.stack([f2[ct // 2, 2 * (ct % 2) + 1]
                            for ct in range(nt)])
            acc = mma(acc, ah[:, None], b0[None, :, None], b1_[None, :, None])

        # Epilogue: stage each warp's span in its rows of the x tile at d's
        # skew, store its chunks.
        for w in range(WARPS):
            r0 = row0 + 16 * MT * w
            nrw = max(0, min(16 * MT, n - r0))
            span, skew = xt + 16 * MT * w * XS, (d_off + r0 * c_dec) % 8
            for m in range(MT):
                for ct in range(nt):
                    for i in range(4):
                        r = 16 * m + G_ + 8 * (i // 2)
                        c = 8 * ct + 2 * Q_ + i % 2
                        ok = c < c_dec
                        at = span + skew + r * c_dec + c
                        assert at.max() < span + 16 * MT * XS
                        S.m[at[ok]] = bf16(acc[m, ct, w, i] +
                                           b2s[np.minimum(c, CH - 1)])[ok]
            cnt = nrw * c_dec
            for i in range(-(-(skew + cnt) // 8)):
                j0 = 8 * i - skew
                k = np.arange(8)
                if not (0 <= j0 and j0 + 8 <= cnt):
                    k = k[(j0 + k >= 0) & (j0 + k < cnt)]
                else:   # a 16-byte store
                    assert (d_off + r0 * c_dec + j0) % 8 == 0
                dflat[guard + d_off + r0 * c_dec + j0 + k] = S.m[span + 8 * i
                                                                 + k]
    body = dflat[guard + d_off:guard + d_off + n * c_dec]
    rest = np.concatenate([dflat[:guard + d_off],
                           dflat[guard + d_off + n * c_dec:]])
    assert np.isnan(rest).all()
    return body.reshape(n, c_dec)


@pytest.mark.parametrize("n,c_in,c_mid,c_dec", SHAPES, ids=IDS)
def test_wide_twin_matches_seg_fwd_plain_bit_for_bit(n, c_in, c_mid, c_dec):
    """The 64-filter widths over three tiles with a ragged third (88
    rows: warp 2 cut at 24 rows, warps 3-7 empty), 48/384/38 (<3, 5>),
    37/300/45 (element copies, 19 steps: the pair loop's odd end),
    33/100/57 at one row (<4, 8>) and 7/260/12 (C_mid just past the
    flagship's tiles)."""
    args, feed = dyadic(n, c_in, c_mid, c_dec, seed=n + c_mid)
    got = twin(*feed)
    want = ts.seg_fwd_plain(*args).float().numpy()
    assert got.shape == (n, c_dec)
    np.testing.assert_array_equal(got, want)


def test_wide_twin_takes_views_at_odd_offsets():
    """x one element past a 16-byte boundary takes the element copies, d
    three past takes a skewed span: both bit for bit."""
    args, feed = dyadic(77, 64, 512, 51, seed=9)
    want = ts.seg_fwd_plain(*args).float().numpy()
    np.testing.assert_array_equal(twin(*feed, x_off=1, d_off=3), want)


@pytest.mark.parametrize("n,c_in,c_mid,c_dec",
                         [(40, 64, 512, 51), (36, 48, 384, 38),
                          (29, 37, 300, 45), (1, 33, 100, 57)],
                         ids=["w64", "w48", "c37_ragged", "cdec57_n1"])
def test_wide_twin_matches_jax_pallas_seg_fwd(n, c_in, c_mid, c_dec,
                                              monkeypatch):
    """Random-normal inputs rounded to bf16: the twin and the port's plain
    version against the Pallas kernel, within the bf16 tolerance."""
    r = np.random.default_rng(n + c_mid)
    mk = lambda *s, sc=1.0: bf16(r.normal(size=s) * sc)
    x, w1, w2 = (mk(n, c_in), mk(c_in, c_mid, sc=c_in ** -0.5),
                 mk(c_mid, c_dec, sc=c_mid ** -0.5))
    b1, b2 = mk(c_mid, sc=0.1), mk(c_dec, sc=0.1)
    ref = jax_pallas_seg_fwd(x, w1, b1, w2, b2, monkeypatch)
    assert max_rel(twin(x, w1, b1, w2, b2), ref) < TOL
    plain = ts.seg_fwd_plain(torch.from_numpy(x).bfloat16(),
                             *(torch.from_numpy(a) for a in (w1, b1, w2, b2)))
    assert max_rel(plain.float().numpy(), ref) < TOL


def test_wide_twin_reading_w1_transposed_is_wrong():
    """W1's [k][j] rows read without .trans pair inputs with the wrong
    middle channels: d far beyond the bf16 tolerance."""
    args, feed = dyadic(64, 64, 512, 51, seed=3)
    want = ts.seg_fwd_plain(*args).float().numpy()
    assert max_rel(twin(*feed, w1_trans=False), want) > 0.1


def test_wide_twin_copying_only_c_in_columns_is_wrong():
    """At C_in = 37 the fragments read x's columns 37..47 against zero rows
    of W1: copies that write only C_in columns leave them as they were
    (NaN in the twin's shared memory, and on the card whatever d a
    previous tile staged there), and 0 x NaN poisons every row; the
    kernel's copies zero them every tile."""
    args, feed = dyadic(129, 37, 300, 45, seed=4)
    assert np.isnan(twin(*feed, copy_pad=False)).all()
    assert np.isfinite(twin(*feed)).all()


def test_wide_mirror_matches_the_source():
    """The constants, the instantiation rule and the route above are the
    kernel's."""
    src = (_build.SRC_DIR / "tstack.cu").read_text()
    got = {k: int(v) for k, v in re.findall(
        r"constexpr int SFBW_(\w+) = (\d+);", src)}
    assert got == dict(WARPS=WARPS, MT=MT, MINB=MINB, CH=CH, MID=MID)
    for name, want in (("ROWS", "16 * SFBW_MT * SFBW_WARPS"),
                       ("XS", "SFBW_CH + 8"), ("WS", "SFBW_MID + 8")):
        assert re.search(rf"constexpr int SFBW_{name} = {re.escape(want)};",
                         src), name
    for c_in, c_dec, want in ((48, 38, (3, 5)), (48, 40, (3, 5)),
                              (64, 51, (4, 7)), (48, 41, (4, 7)),
                              (49, 40, (4, 7)), (64, 57, (4, 8))):
        assert widths_of(c_in, c_dec) == want
    for want in ("if (c_in <= 48 && c_dec <= 40)\n"
                 "    return launch_seg_fwd_bf16_wide_as<3, 5>(",
                 "if (c_dec <= 56)\n"
                 "    return launch_seg_fwd_bf16_wide_as<4, 7>(",
                 "return launch_seg_fwd_bf16_wide_as<4, 8>(",
                 "wide ? SEG_FWD_BF16_WIDE : SEG_FWD_BF16_MMA",
                 "SEG_FWD_BF16_WIDE = 5",
                 "static_assert(SFBW_CH == SFW_CH && SFBW_MID == SFW_MID,"):
        assert want in src, want
    assert ts.SEG_FWD_ROUTES[5].startswith("seg_fwd_bf16_wide_kernel ")


def test_wide_layout_fits_and_ldmatrix_rows_are_conflict_free():
    """209,152 bytes of a block's 232,448 at 8 warps of 2 row tiles
    (span buffers of 32,896 B beside the x tiles would not fit); 12 warps
    of one row tile fit too.  Every region starts on 16 bytes, a warp's d
    span fits its 32 rows of the x tile, and the 8 rows of every ldmatrix
    (x at 36 words a row, W1 and W2 at 260) fall in 32 distinct banks."""
    assert smem_bytes() == 209_152 <= OPTIN
    assert smem_bytes() + WARPS * (16 * MT * 64 + 8) * 2 > OPTIN
    assert smem_bytes(12, 1) <= OPTIN
    for off in (CH * WS, 2 * CH * WS, 2 * CH * WS + ROWS * XS,
                2 * CH * WS + 2 * ROWS * XS):
        assert 2 * off % 16 == 0
    assert 7 + 16 * MT * CH <= 16 * MT * XS
    assert (16 * MT * XS * 2) % 16 == 0
    for stride in (XS, WS):
        banks = (np.arange(8)[:, None] * stride // 2 + np.arange(4)) % 32
        assert len(set(banks.ravel())) == 32


def test_wide_variants_tool_applies_to_the_kernel_source():
    """tools/seg_fwd_variants.py --section bf16_wide builds its variants by
    substitution in the kernel's section of tstack.cu: every substitution
    still finds its text, each variant gets its own copy of the kernel and
    a launch case, and the flagship's bf16 section ends where this one
    starts."""
    from probav_tpu_torch.tools import seg_fwd_variants as sv
    names = list(sv.BF16_WIDE_VARIANTS)
    src = sv.source(names, "bf16_wide")
    assert src.count("\nseg_fwd_bf16_wide_kernel(const __nv_bfloat16* "
                     "__restrict__ x,") == len(names)
    for i in range(len(names)):
        assert f"if (v == {i}) return v{i}::launch_seg_fwd_bf16_wide(" in src
    assert "seg_fwd_bf16_wide_kernel" not in sv.source(["kernel"],
                                                       "bfloat16")
    w12 = sv.source(["warps12_mt1"], "bf16_wide")
    assert "constexpr int SFBW_WARPS = 12;" in w12
    assert "constexpr int SFBW_MT = 1;" in w12
    assert "fake_mma(" in sv.source(["no_mma"], "bf16_wide")
