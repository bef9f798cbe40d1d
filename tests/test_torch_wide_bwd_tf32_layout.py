"""The fragments of the float32 tensor-core wide_bwd, in numpy.

``wide_bwd_tf32_kernel`` (probav_tpu_torch/csrc/blk_bwd.cu) is the WIDE
flavour of ``seg_bwd_tf32_kernel``: one body, ``seg_bwd_tf32_body<WIDE>``.
It computes the flat expand/decay backward (dx = dz W1^T, dW1, db1, dW2,
db2, with dz and h = relu(z) in float32) as 3xTF32 on mma.sync m16n8k8
(fragment layouts in common.cuh, mma_tf32):

- x and dy are staged in tiles of SBT_ROWS = 128 rows, row stride SBT_XS
  = 40 floats, by copy_rows (zeros past n; the columns from c_in or c_dec
  on were zeroed once and are never written); W1 as a [c][j] plane and
  W2 transposed to [c][j], zero-padded to 32 x 256, row stride SBT_WS =
  264; b1 zero-padded to 256;
- phase A, warp w on rows 16 w .. 16 w + 15: the A fragments of x and dy
  (four k-steps) split once a tile; per 64-channel chunk and per pair of
  8-column n-tiles, z = x W1 + b1 and W2 dy come out in the C layout;
  dz = W2 dy where z > 0 and h = relu(z) go to the chunk's dz and h
  buffers ([row][SBT_ZS = 72]) and dz, without shuffles, into dx += dz
  W1^T: C columns 2q, 2q + 1 are fed as A columns q, q + 4, and W1^T's B
  rows q, q + 4 are W1[c][j], W1[c][j + 1] (the k order of a dot product
  is free); each chunk's dx products in fresh sums, added to the tile's;
- phase B, block-wide: dW1 += x^T dz (warp w one 32 x 8 tile, columns j
  = 8 w ..) and dW2 += h^T dy (warp w one 16 x 16 tile, rows 16 (w / 2),
  columns 16 (w % 2)) over the tile's 128 rows, K = 8 rows a step; db1
  from dz's B fragments, db2 (chunk 0, warps 0 and 1) from dy's; each
  chunk's products over one tile in fresh sums, added to the block's
  running sums;
- the epilogue stores dx = W1 dz for rows below n, columns below c_in (no
  gy, unlike blk_bwd's dx = W1 dz + gy);
- one wave: min(G, resident) blocks, block b taking tiles b, b + blocks,
  ...; each writes its slot in wide_bwd's layout (dW1 [c][j], dW2 [j][c],
  db1, db2: no dWc, no dbc), the other G - blocks slots are neither
  written nor read, and the reduce sums the blocks' slots in order.

The twin repeats that map register by register: fragments are gathered by
lane from the staged tiles, each mma rebuilds its A, B and C matrices
from the lanes' registers, as three products (hi hi, lo hi, hi lo; lo lo
dropped) of the numpy split of ``test_torch_tf32_split.py``, exact in
float64 and rounded to float32 per mma (the tensor cores' truncating sums
are not emulated).  It is held to ``wide_bwd_plain`` on the dyadic inputs
of ``tools/dyadic.py`` at dx 2e-5 and the gradients 1e-4 of max|ref|
(``tests/test_torch_kernels.py``'s ``wide_bwd_tolerance``), exactly where
the reference is all zeros, and on a dy of 15 significant bits, which
TF32 does not hold; a twin without the C -> A permutation, or with one
TF32 product instead of three on that dy, is not.  The kernel runs only
on the card; this pins what it addresses.
"""

import numpy as np
import pytest
import torch

from probav_tpu_torch.ops import wide_block as wb
from probav_tpu_torch.tools.dyadic import grid, wide_bwd_inputs
from test_torch_tf32_split import split_tf32, tf32_read

torch.set_num_threads(1)

ROWS, WARPS, CH, NCH, XS, ZS, WS = 128, 8, 64, 4, 40, 72, 264  # SBT_*
H100_SLOTS, H100_SMS = 264, 132   # the wrapper's G; one block an SM
SMEM_OPTIN = 232_448
LANE = np.arange(32)
G_, Q_ = LANE // 4, LANE % 4
W_ = np.arange(WARPS)[:, None]
NAMES = ("dx", "dw1", "db1", "dw2", "db2")
TOLS = (2e-5, 1e-4, 1e-4, 1e-4, 1e-4)


def frag(*regs):
    """A fragment's registers [WARPS, 32] each, split: (hi, lo read at
    TF32)."""
    hi, lo = zip(*(split_tf32(np.broadcast_to(r, (WARPS, 32)))
                   for r in regs))
    return hi, tuple(tf32_read(v) for v in lo)


def a_mat(a):
    """[WARPS, 16, 8] A of m16n8k8 from its four registers."""
    m = np.zeros((WARPS, 16, 8))
    m[:, G_, Q_], m[:, G_ + 8, Q_] = a[0], a[1]
    m[:, G_, Q_ + 4], m[:, G_ + 8, Q_ + 4] = a[2], a[3]
    return m


def b_mat(b):
    """[WARPS, 8, 8] B (k x n) from its two registers."""
    m = np.zeros((WARPS, 8, 8))
    m[:, Q_, G_], m[:, Q_ + 4, G_] = b[0], b[1]
    return m


def c_mat(c):
    m = np.zeros((WARPS, 16, 8))
    m[:, G_, 2 * Q_], m[:, G_, 2 * Q_ + 1] = c[0], c[1]
    m[:, G_ + 8, 2 * Q_], m[:, G_ + 8, 2 * Q_ + 1] = c[2], c[3]
    return m


def c_regs(m):
    return np.stack([m[:, G_, 2 * Q_], m[:, G_, 2 * Q_ + 1],
                     m[:, G_ + 8, 2 * Q_], m[:, G_ + 8, 2 * Q_ + 1]])


def mma_term(c, a, b, term):
    """mma_term: c += term 0 (hi hi), 1 (lo hi) or 2 (hi lo) of a b, the
    product exact in float64, rounded into the float32 registers."""
    pa, pb = ((a[0], b[0]), (a[1], b[0]), (a[0], b[1]))[term]
    return c_regs(c_mat(c) + a_mat(pa) @ b_mat(pb)).astype(np.float32)


def shfl_sum(v, masks):
    """v += __shfl_xor_sync(v, m) for each m in order, over the lanes."""
    for m in masks:
        v = (v + v[..., LANE ^ m]).astype(np.float32)
    return v


def twin(x, w1, b1, w2, dy, groups, resident=H100_SMS, permute=True,
         terms=3):
    """(dx, dw1, db1, dw2, db2, slots) as wide_bwd_tf32_kernel addresses
    and sums them, and the reduce.  ``permute=False`` feeds dz's C
    registers to the dx product in their own order (a0..a3 = c0..c3);
    ``terms=1`` takes each product as hi hi alone (one TF32 product)."""
    f32 = np.float32
    n, c_in = x.shape
    c_mid, c_dec = w2.shape
    w1s = np.zeros((32, WS), f32)
    w1s[:c_in, :c_mid] = w1
    w2s = np.zeros((32, WS), f32)
    w2s[:c_dec, :c_mid] = w2.T
    b1s = np.zeros(256, f32)
    b1s[:c_mid] = b1
    tiles = -(-n // ROWS)
    slot_len = c_in * c_mid + c_mid * c_dec + c_mid + c_dec
    slots = np.full((groups, slot_len), np.nan, f32)
    blocks = min(groups, resident)        # slots past blocks stay unwritten
    dx = np.full((n, c_in), np.nan, f32)
    ra = 16 * W_ + G_                      # phase A rows (and + 8)
    mh, nd = (W_ // 2) * 16, (W_ % 2) * 16   # a warp's dW2 tile
    zero = lambda *s: np.zeros(s + (WARPS, 32), f32)
    for blk in range(blocks):
        acc1, acc2 = zero(NCH, 2, 4), zero(NCH, 2, 4)
        db1a, db2a = zero(NCH), zero(2)
        for tile in range(blk, tiles, blocks):
            row0, nr = tile * ROWS, min(ROWS, n - tile * ROWS)
            xt = np.zeros((ROWS, XS), f32)
            xt[:nr, :c_in] = x[row0:row0 + nr]
            dt = np.zeros((ROWS, XS), f32)
            dt[:nr, :c_dec] = dy[row0:row0 + nr]
            a_of = lambda t, k: frag(t[ra, k * 8 + Q_], t[ra + 8, k * 8 + Q_],
                                     t[ra, k * 8 + Q_ + 4],
                                     t[ra + 8, k * 8 + Q_ + 4])
            ax = [a_of(xt, k) for k in range(4)]
            ad = [a_of(dt, k) for k in range(4)]
            dxa = zero(4, 4)
            for ch in range(NCH):
                j0 = ch * CH
                if j0 >= c_mid:
                    break
                zs = np.full((ROWS, ZS), np.nan, f32)
                hs = np.full((ROWS, ZS), np.nan, f32)
                dxc = zero(4, 4)
                for p in range(CH // 16):           # phase A
                    jn = j0 + p * 16
                    z, gg = zero(2, 4), zero(2, 4)
                    for k in range(4):
                        kr = k * 8 + Q_
                        bw = [frag(w1s[kr, jn + t * 8 + G_],
                                   w1s[kr + 4, jn + t * 8 + G_])
                              for t in range(2)]
                        bv = [frag(w2s[kr, jn + t * 8 + G_],
                                   w2s[kr + 4, jn + t * 8 + G_])
                              for t in range(2)]
                        for term in range(terms):
                            for t in range(2):
                                z[t] = mma_term(z[t], ax[k], bw[t], term)
                                gg[t] = mma_term(gg[t], ad[k], bv[t], term)
                    for t in range(2):
                        jl = p * 16 + t * 8 + 2 * Q_   # chunk column of 2q
                        bb = (b1s[j0 + jl], b1s[j0 + jl + 1])
                        zz = [(z[t][i] + bb[i % 2]).astype(f32)
                              for i in range(4)]
                        dz = [np.where(zz[i] > 0, gg[t][i], f32(0))
                              for i in range(4)]
                        h = [np.fmax(zz[i], f32(0)) for i in range(4)]
                        for buf, v in ((zs, dz), (hs, h)):
                            buf[ra, jl], buf[ra, jl + 1] = v[0], v[1]
                            buf[ra + 8, jl], buf[ra + 8, jl + 1] = v[2], v[3]
                        az = frag(dz[0], dz[2], dz[1], dz[3]) if permute \
                            else frag(*dz)
                        bx = [frag(w1s[ct * 8 + G_, j0 + jl],
                                   w1s[ct * 8 + G_, j0 + jl + 1])
                              for ct in range(4)]
                        for term in range(terms):
                            for ct in range(4):
                                dxc[ct] = mma_term(dxc[ct], az, bx[ct], term)
                dxa = (dxa + dxc).astype(f32)
                assert not np.isnan(zs[:, :CH]).any()   # every word written
                t1, t2 = zero(2, 4), zero(2, 4)
                for kk in range(ROWS // 8):              # phase B
                    r = kk * 8 + Q_
                    axt = [frag(xt[r, mt * 16 + G_], xt[r, mt * 16 + G_ + 8],
                                xt[r + 4, mt * 16 + G_],
                                xt[r + 4, mt * 16 + G_ + 8])
                           for mt in range(2)]
                    zc = W_ * 8 + G_
                    bz = frag(zs[r, zc], zs[r + 4, zc])
                    db1a[ch] += (zs[r, zc] + zs[r + 4, zc]).astype(f32)
                    ah = frag(hs[r, mh + G_], hs[r, mh + G_ + 8],
                              hs[r + 4, mh + G_], hs[r + 4, mh + G_ + 8])
                    bd = []
                    for nt in range(2):
                        col = nd + nt * 8 + G_
                        bd.append(frag(dt[r, col], dt[r + 4, col]))
                        if ch == 0:
                            db2a[nt] += (dt[r, col] + dt[r + 4, col]) \
                                .astype(f32)
                    for term in range(terms):
                        for mt in range(2):
                            t1[mt] = mma_term(t1[mt], axt[mt], bz, term)
                        for nt in range(2):
                            t2[nt] = mma_term(t2[nt], ah, bd[nt], term)
                acc1[ch] = (acc1[ch] + t1).astype(f32)
                acc2[ch] = (acc2[ch] + t2).astype(f32)
            for t in range(4):                           # dx = W1 dz
                for i in range(4):
                    r = ra + (0 if i < 2 else 8)
                    c = t * 8 + 2 * Q_ + (i & 1) + 0 * W_
                    ok = (r < nr) & (c < c_in)
                    dx[row0 + r[ok], c[ok]] = dxa[t][i][ok]
        # The block's slot (zeros for a block with no tile).
        slot = slots[blk]
        o2 = c_in * c_mid
        ob1, ob2 = o2 + c_mid * c_dec, o2 + c_mid * c_dec + c_mid
        for ch in range(NCH):
            for i in range(4):
                rr, cc = G_ + (0 if i < 2 else 8), 2 * Q_ + (i & 1)
                for t in range(2):
                    c, j = t * 16 + rr + 0 * W_, ch * CH + W_ * 8 + cc
                    ok = (c < c_in) & (j < c_mid)
                    slot[(c * c_mid + j)[ok]] = acc1[ch][t][i][ok]
                    j2, c2 = ch * CH + mh + rr, nd + t * 8 + cc
                    ok = (j2 < c_mid) & (c2 < c_dec)
                    slot[(o2 + j2 * c_dec + c2)[ok]] = acc2[ch][t][i][ok]
            v = shfl_sum(db1a[ch], (1, 2))
            j = ch * CH + W_ * 8 + G_
            ok = (Q_ == 0) & (j < c_mid)
            slot[(ob1 + j)[ok]] = v[ok]
        for t in range(2):
            v = shfl_sum(db2a[t], (1, 2))
            c = nd + t * 8 + G_
            ok = (W_ < 2) & (Q_ == 0) & (c < c_dec)
            slot[(ob2 + c)[ok]] = v[ok]
    total = np.zeros(slot_len, f32)
    for gi in range(blocks):                    # reduce_partials, in order
        total += slots[gi]
    o2, ob1 = c_in * c_mid, c_in * c_mid + c_mid * c_dec
    return (dx, total[:o2].reshape(c_in, c_mid), total[ob1:ob1 + c_mid],
            total[o2:ob1].reshape(c_mid, c_dec), total[ob1 + c_mid:], slots)


def case(n, c, cmid, cdec, seed):
    """float32 dyadic inputs and their numpy arrays for the twin."""
    args = wide_bwd_inputs(n, c, cmid, cdec, seed=seed)
    return args, tuple(t.numpy() for t in args)


def max_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def check(got, want):
    """The tolerances of the module docstring; exact where max|ref| = 0.
    Returns the names of the all-zero references."""
    zeros = []
    for name, a, r, tol in zip(NAMES, got, want, TOLS):
        r = r.numpy()
        assert a.shape == r.shape, name
        if not np.abs(r).max():
            zeros.append(name)
            np.testing.assert_array_equal(a, r)
        else:
            assert max_rel(a, r) < tol, (name, max_rel(a, r))
    return zeros


@pytest.mark.parametrize("n,c,cmid,cdec,groups,resident", [
    (200, 32, 256, 25, H100_SLOTS, H100_SMS), (129, 7, 100, 12, 1, 1),
    (1, 32, 256, 25, H100_SLOTS, H100_SMS), (129, 32, 256, 25, 4, 4),
    (300, 8, 64, 7, 4, 2)],
    ids=["flagship_widths_2tiles_g264", "c7_cmid100_n129_one_block", "n1",
         "n129_g4", "300rows_g4_2blocks"])
def test_twin_matches_wide_bwd_plain(n, c, cmid, cdec, groups, resident):
    """The flagship's widths over two tiles (a ragged second) in 264 slots,
    132 blocks launched; 7/100/12 (two of the four chunks, 129 rows: one
    row in the second tile) in one block; one row; 129 rows in 4 slots;
    300 rows in 4 slots with 2 blocks resident (block 0 takes tiles 0 and
    2).  Every entry of a launched block's slot is written, zeros in the
    slots of blocks past the tiles; the slots of blocks not launched are
    never written (NaN), and the reduce never reads them."""
    args, feed = case(n, c, cmid, cdec, seed=n + cmid)
    got = twin(*feed, groups, resident=resident)
    assert check(got[:5], wb.wide_bwd_plain(*args)) == []
    slots, blocks = got[5], min(groups, resident)
    assert not np.isnan(slots[:blocks]).any()
    tiles = -(-n // ROWS)
    assert (slots[min(tiles, blocks):blocks] == 0).all()
    assert np.isnan(slots[blocks:]).all()


def test_all_zero_references_are_matched_exactly():
    """1/1/1 where w2's one draw is 0: dz is 0, so the reference dx, dW1
    and db1 are all zeros (max|ref| = 0, no relative error), and the twin
    gives exact zeros."""
    for seed in range(100):
        args, feed = case(150, 1, 1, 1, seed)
        if not feed[3].any():
            break
    else:
        pytest.fail("no seed draws w2 = 0")
    got = twin(*feed, 2)
    assert check(got[:5], wb.wide_bwd_plain(*args)) == ["dx", "dw1", "db1"]


def test_phase_a_without_the_k_permutation_is_wrong():
    """dz's C registers fed to the dx product in their own order pair dz
    with the wrong W1^T rows: dx far beyond 2e-5 of max|ref|."""
    args, feed = case(200, 32, 256, 25, seed=5)
    dx = twin(*feed, 1, permute=False)[0]
    assert max_rel(dx, wb.wide_bwd_plain(*args)[0].numpy()) > 1e-2


def test_three_tf32_products_hold_what_one_cannot():
    """On the dyadic inputs dz and h mostly fit TF32's 11 bits, so one
    product would pass there.  With dy on a 2**-13 grid in [-2, 2] (15
    bits), dz = W2 dy is still exact in float32 in any order (|W2 dy| <
    2**22 steps of 2**-18) but not in TF32: the three products meet the
    tolerances, hi hi alone puts dx beyond its 2e-5."""
    args, feed = case(200, 32, 256, 25, seed=5)
    dy = grid(np.random.default_rng(6), (200, 25), 2 ** 14, 13)
    args, feed = args[:4] + (torch.from_numpy(dy),), feed[:4] + (dy,)
    assert (split_tf32(dy)[1] != 0).mean() > 0.5   # most not TF32
    want = wb.wide_bwd_plain(*args)
    assert check(twin(*feed, 1)[:5], want) == []
    assert max_rel(twin(*feed, 1, terms=1)[0], want[0].numpy()) > TOLS[0]


def seg_bwd_tf32_smem(wide):
    """blk_bwd.cu's seg_bwd_tf32_smem: the weights [32][WS] twice, b1, dz
    and h [ROWS][ZS], four tiles [ROWS][XS], and blk_bwd's dbc sums."""
    return 4 * (2 * 32 * WS + 256 + 2 * ROWS * ZS + 4 * ROWS * XS +
                (0 if wide else WARPS * 32))


def test_layout_fits_one_block_an_sm_and_phase_b_reads_are_conflict_free():
    """224,256 B (WIDE) and 225,280 B (blk_bwd's) of a block's 232,448:
    one block an SM.  Phase B's fragment reads of the x and dy tiles
    (stride 40) and of the dz and h buffers (stride 72) put the 32 lanes
    in 32 distinct banks."""
    assert seg_bwd_tf32_smem(True) == 224_256 <= SMEM_OPTIN
    assert seg_bwd_tf32_smem(False) == 225_280 <= SMEM_OPTIN
    assert 2 * seg_bwd_tf32_smem(True) > SMEM_OPTIN
    r = 8 * 3 + Q_
    for stride, col in ((XS, G_), (XS, G_ + 8), (ZS, G_), (ZS, 8 + G_)):
        assert len(set((r * stride + col) % 32)) == 32


def test_profiled_names_keep_the_wide_kernel_out_of_blk_bwd_parts():
    """tstack_roofline.blk_bwd_part files seg_bwd_tf32_kernel under
    blk_bwd's seg_bwd and leaves wide_bwd_tf32_kernel out: it is
    wide_bwd's."""
    from probav_tpu_torch.tools.tstack_roofline import blk_bwd_part
    args = "(float const*, float const*, float const*, float const*, long)"
    ns = "(anonymous namespace)::"
    assert blk_bwd_part(ns + "seg_bwd_tf32_kernel" + args) == "seg_bwd"
    assert blk_bwd_part(ns + "wide_bwd_tf32_kernel" + args) is None


def test_wide_tf32_variants_tool_applies_to_the_kernel_source():
    """tools/seg_bwd_variants.py --section wide_tf32 builds its variants
    by substitution in the float32 section of blk_bwd.cu: every
    substitution still finds its text, and each variant gets its own copy
    of the kernel and a launch case."""
    from probav_tpu_torch.tools import seg_bwd_variants as sv
    names = list(sv.WIDE_TF32_VARIANTS)
    src = sv.source(names, "wide_tf32")
    assert src.count("\nwide_bwd_tf32_kernel(const float* __restrict__ x,") \
        == len(names)
    for i in range(len(names)):
        assert f"if (v == {i}) return v{i}::launch_wide_bwd_tf32(" in src
    assert "const int G1 = G;" in sv.source(["g_blocks"], "wide_tf32")
    assert "fake_mma_tf32(" in sv.source(["no_mma"], "wide_tf32")
    assert "for (int kk = 0; kk < 0;" in sv.source(["no_phase_b"],
                                                    "wide_tf32")
    assert "struct Slot" in src and "wgrad_tf32_kernel" not in src
