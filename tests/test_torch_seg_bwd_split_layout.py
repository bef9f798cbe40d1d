"""The addressing and schedule of the bf16 tensor-core seg_bwd of
``blk_bwd`` beyond the flagship's widths, in numpy.

``seg_bwd_split_kernel`` and ``dx_sum_kernel`` (probav_tpu_torch/csrc/
blk_bwd.cu) compute the expand/decay backward of a block (dx = W1 dz + gy,
dW1, db1, dW2, db2, dbc) at c_in, c_dec <= 64 and c_mid <= 512 on
mma.sync m16n8k16 (fragment layouts in common.cuh):

- C_mid is cut into chunks of JC = 256 middle channels j.  Block b of the
  G x chunks takes chunk b % chunks of the 64-row tiles of slot b / chunks
  (tiles s, s + G, ...), and writes its chunk's columns of dW1, rows of
  dW2 and entries of db1 into that slot, db2 from the chunk-0 block;
- shared memory, in bf16 elements: the chunk's W1 and W2 as [j][c] (row
  stride CS = 72), dz^T [256][ZS = 72], two each of the x and dd tiles
  [64][72], each warp's raw dd span; x rows land by 16-byte copies (zeros
  past n and from c_in); warp w copies the dd of rows 8 w .. 8 w + 7 as one
  span from the 16-byte chunk below its start and repacks it, zeros from
  c_dec and past n;
- warp w owns j = 32 w .. 32 w + 31 of the chunk: per 16 rows, the A
  fragments of W1^T and W2 by ldmatrix per k-step (K = 64 channels, four
  k-steps), the B fragments of x^T and dd^T by ldmatrix, z^T and W2 dd^T
  as C tiles; dz = bf16(W2 dd) where z + b1 > 0 and h = bf16(relu(z + b1))
  as the A fragments of dW1^T += dz^T x and dW2 += h^T dd (eight c-tiles,
  B by ldmatrix.trans, one load a c-tile pair for both m-tiles); dz^T to
  shared memory;
- phase C, after a barrier: warp w computes rows 16 (w % 4) .. + 15 by
  channels 32 (w / 4) .. + 31 of the chunk's part of dx, dz W1^T over its
  256 j (A from dz^T, B from the W1 plane, both ldmatrix.trans), stored as
  float32 into dxp[chunk][row][ldp] (ldp = c_in rounded up to 8);
- dx_sum_kernel: block b of G sums rows [b per, (b + 1) per): dx =
  bf16((part_0 + part_1 + ...) + gy) in float32, thread t the four channels
  4 (t % 16) .. of rows t / 16 + 16 k, and dbc: each thread's gy sums in
  row order, then the 16 row lanes in order, into slot b.

The twin below models shared memory as one flat array with the kernel's
offsets, performs every ldmatrix by the lanes' addresses (checking their
16-byte alignment) and every mma from the lanes' registers (the flagship
twin's helpers, ``test_torch_seg_bwd_mma_layout``), and is held to:

- ``blk_bwd_plain`` on the dyadic inputs of ``tools/dyadic.py``: the dz^T
  words, dx, db2 and dbc bit for bit (every product and every partial sum
  of z, W2 dd and of gy and dd is exact; dx is one bf16 rounding of a
  float32 sum that both sides take); dW1, db1 and dW2 within 2e-6 of
  max|ref| (x dz with dz a bf16 number down to 2**-15 outgrows float32's
  24 bits, so the order shows in the last bits, as for the flagship
  kernel's twin);
- the JAX package's Pallas ``blk_bwd`` in interpret mode at bf16, at
  ``blk_bwd_tolerances(bfloat16)``.

The kernels run only on the card; this pins what they address.
"""

import numpy as np
import pytest
import torch

from probav_tpu_torch.ops import tstack as ts
from test_torch_kernels import BWD_NAMES, blk_bwd_tolerances
from test_torch_seg_bwd_mma_layout import (G_, H16, L8, LANE, M2, Q_,
                                           SUM_TOL, Smem, bf16, case,
                                           jax_pallas_blk_bwd, max_rel, mma,
                                           seg_bwd_bf16_smem, shfl_sum)

torch.set_num_threads(1)

ROWS, WARPS, JC, CH = 64, 8, 256, 64   # blk_bwd.cu's SBS_*
CS, ZS = CH + 8, ROWS + 8
RG, DR = ROWS // 16, ROWS // WARPS     # row groups a tile, dd rows a warp
RAWW = (DR * CH * 2 + 43) // 16 * 8    # a warp's raw dd span, elements
DXS = 256                              # dx_sum_kernel's threads
H100_SLOTS = 264
OPTIN = 232_448


class SplitSmem:
    """seg_bwd_split_kernel's shared memory in bf16 elements (held as
    float32), NaN where nothing was written."""

    ldsm = Smem.ldsm

    def __init__(self):
        self.w1s = 0                          # [JC][CS]
        self.w2s = JC * CS                    # [JC][CS]
        self.zt = 2 * JC * CS                 # [JC][ZS]
        self.xb = self.zt + JC * ZS           # [2][ROWS][CS]
        self.dbt = self.xb + 2 * ROWS * CS    # [2][ROWS][CS]
        self.raw = self.dbt + 2 * ROWS * CS   # [WARPS][RAWW]
        self.m = np.full(self.raw + WARPS * RAWW, np.nan, np.float32)


def split_plan(c_in, c_mid):
    """(chunks, ldp) as seg_bwd_split_chunks and seg_bwd_split_ldp give
    them."""
    return -(-c_mid // JC), -(-c_in // 8) * 8


def split_block(S, blk, x, ddg, w1, b1, w2, groups, dxp, slots):
    """One block of seg_bwd_split_kernel: its tiles' products and phase C
    into dxp, its part of its slot into slots; returns the dz^T words of
    its rows by (row, j)."""
    n, c_in = x.shape
    c_mid, c_dec = w2.shape
    chunks, ldp = split_plan(c_in, c_mid)
    chunk, slot_i = blk % chunks, blk // chunks
    j0, jn = chunk * JC, min(JC, c_mid - chunk * JC)
    tiles = -(-n // ROWS)
    W = np.arange(WARPS)[:, None]
    J0 = 32 * W
    words = {}
    w1p = np.zeros((JC, CH), np.float32)
    w1p[:jn, :c_in] = w1[:, j0:j0 + jn].T
    w2p = np.zeros((JC, CH), np.float32)
    w2p[:jn, :c_dec] = w2[j0:j0 + jn]
    for base, plane in ((S.w1s, w1p), (S.w2s, w2p)):
        S.m[base + np.arange(JC)[:, None] * CS + np.arange(CH)] = plane
    S.m[S.xb:S.raw] = 0.0         # the x and dd tiles
    jb = j0 + J0[None] + 16 * np.arange(2)[:, None, None] + G_   # [2, W, 32]
    bias = np.stack([np.where(jb + 8 * hh < c_mid,
                              np.pad(b1, (0, 2 * JC))[jb + 8 * hh], 0)
                     for hh in range(2)]).astype(np.float32)   # [hh, mt, W]
    acc1 = np.zeros((2, 8, WARPS, 4, 32), np.float32)
    acc2 = np.zeros_like(acc1)
    db1a = np.zeros((2, 2, WARPS, 32), np.float32)
    db2a = np.zeros((8, WARPS, 32), np.float32)
    p_, c_ = np.arange(DR)[:, None], np.arange(CH)
    for k, tile in enumerate(range(slot_i, tiles, groups)):
        buf = k % 2
        row0, nr = tile * ROWS, min(ROWS, n - tile * ROWS)
        xt, dt = S.xb + buf * ROWS * CS, S.dbt + buf * ROWS * CS
        xs = np.zeros((ROWS, c_in), np.float32)
        xs[:nr] = x[row0:row0 + nr]
        S.m[xt + np.arange(ROWS)[:, None] * CS + np.arange(c_in)] = xs
        for w in range(WARPS):
            nrw = min(DR, nr - DR * w)
            raw, skew = S.raw + w * RAWW, 0
            if nrw > 0:
                src = (row0 + DR * w) * c_dec
                a0 = src - src % 8
                chunks16 = -(-(src + nrw * c_dec - a0) // 8)
                assert 8 * chunks16 <= RAWW
                S.m[raw:raw + 8 * chunks16] = ddg[a0:a0 + 8 * chunks16]
                skew = src - a0
            inside = (p_ < nrw) & (c_ < c_dec)
            S.m[dt + (DR * w + p_) * CS + c_] = np.where(
                inside, S.m[np.where(inside, raw + skew + p_ * c_dec + c_,
                                     raw)], 0.0)

        for rg in range(RG):
            r0 = 16 * rg
            xf = [[S.ldsm(xt + (r0 + 8 * nt + L8) * CS + 32 * kp +
                          8 * (LANE // 8)) for kp in range(2)]
                  for nt in range(2)]
            df = [[S.ldsm(dt + (r0 + 8 * nt + L8) * CS + 32 * kp +
                          8 * (LANE // 8)) for kp in range(2)]
                  for nt in range(2)]
            adz = np.zeros((2, WARPS, 4, 32, 2), np.float32)
            ah = np.zeros_like(adz)
            for mt in range(2):
                arow = S.w1s + (J0 + 16 * mt + 8 * M2 + L8) * CS + 8 * H16
                z = [np.zeros((WARPS, 4, 32), np.float32) for _ in range(2)]
                gg = [np.zeros((WARPS, 4, 32), np.float32) for _ in range(2)]
                for ks in range(4):
                    wa = S.ldsm(arow + 16 * ks)
                    wb = S.ldsm(arow + JC * CS + 16 * ks)
                    for nt in range(2):
                        b0, b1_ = xf[nt][ks // 2][2 * (ks % 2):2 * (ks % 2) + 2]
                        z[nt] = mma(z[nt], wa, b0, b1_)
                        b0, b1_ = df[nt][ks // 2][2 * (ks % 2):2 * (ks % 2) + 2]
                        gg[nt] = mma(gg[nt], wb, b0, b1_)
                for nt in range(2):
                    for hh in range(2):
                        zz = np.stack([z[nt][:, 2 * hh], z[nt][:, 2 * hh + 1]],
                                      -1) + bias[hh, mt, :, :, None]
                        g2 = np.stack([gg[nt][:, 2 * hh],
                                       gg[nt][:, 2 * hh + 1]], -1)
                        dzp = np.where(zz > 0, bf16(g2), 0.0)
                        adz[mt, :, 2 * nt + hh] = dzp
                        ah[mt, :, 2 * nt + hh] = bf16(np.maximum(zz, 0.0))
                        db1a[mt, hh] += (dzp[..., 0] + dzp[..., 1]
                                         ).astype(np.float32)
                        jrow = J0 + 16 * mt + G_ + 8 * hh
                        at = S.zt + jrow * ZS + r0 + 8 * nt + 2 * Q_
                        S.m[at], S.m[at + 1] = dzp[..., 0], dzp[..., 1]
            for p in range(4):
                tr = (r0 + 8 * M2 + L8) * CS + 16 * p + 8 * H16
                xtr = S.ldsm(xt + tr, trans=True)
                dtr = S.ldsm(dt + tr, trans=True)
                for mt in range(2):
                    for u in range(2):
                        acc1[mt, 2 * p + u] = mma(acc1[mt, 2 * p + u],
                                                  adz[mt], xtr[2 * u],
                                                  xtr[2 * u + 1])
                        acc2[mt, 2 * p + u] = mma(acc2[mt, 2 * p + u],
                                                  ah[mt], dtr[2 * u],
                                                  dtr[2 * u + 1])
                for i in range(4):   # db2: warp rg sums row group rg
                    db2a[2 * p + i // 2, rg] += (dtr[i, :, 0] +
                                                 dtr[i, :, 1]
                                                 ).astype(np.float32)
        zrows = S.m[S.zt + np.arange(jn)[:, None] * ZS + np.arange(nr)]
        for r in range(nr):
            words[row0 + r] = zrows[:, r]

        # Phase C: warp w's rows and c-tiles over the chunk's 256 j.
        pr0, ct0 = 16 * (W % RG), 4 * (W // RG)              # [W, 1]
        za = S.zt + (8 * H16 + L8) * ZS + pr0 + 8 * M2
        wp = S.w1s + (8 * M2 + L8) * CS + 8 * (ct0 + H16)
        dxc = np.zeros((4, WARPS, 4, 32), np.float32)
        for ks in range(JC // 16):
            a = S.ldsm(za + ks * 16 * ZS, trans=True)
            for pp in range(2):
                b = S.ldsm(wp + ks * 16 * CS + 16 * pp, trans=True)
                for u in range(2):
                    dxc[2 * pp + u] = mma(dxc[2 * pp + u], a, b[:, 2 * u],
                                          b[:, 2 * u + 1])
        for hh in range(2):
            row = row0 + pr0 + G_ + 8 * hh                     # [W, 32]
            for t in range(4):
                c = 8 * (ct0 + t) + 2 * Q_ + 0 * row
                ok = (row < n) & (c < ldp)
                for u in range(2):
                    dxp[chunk, row[ok], c[ok] + u] = dxc[t, :, 2 * hh + u][ok]

    # The block's part of its slot (no dWc): dW1 [c][j0..], dW2 [j0..][c],
    # db1 [j0..], db2 from the chunk-0 block.
    slot = slots[slot_i]
    o2, ob1 = c_in * c_mid, c_in * c_mid + c_mid * c_dec
    ob2 = ob1 + c_mid
    for mt in range(2):
        for ct in range(8):
            for i in range(4):
                j = J0 + 16 * mt + G_ + 8 * (i // 2)            # [W, 32]
                cc = 8 * ct + 2 * Q_ + (i & 1) + 0 * j
                ok = j < jn
                k1 = ok & (cc < c_in)
                at1 = (cc * c_mid + j0 + j)[k1]
                assert np.isnan(slot[at1]).all(), "dW1 written twice"
                slot[at1] = acc1[mt, ct][:, i][k1]
                k2 = ok & (cc < c_dec)
                at2 = (o2 + (j0 + j) * c_dec + cc)[k2]
                assert np.isnan(slot[at2]).all(), "dW2 written twice"
                slot[at2] = acc2[mt, ct][:, i][k2]
        for hh in range(2):
            v = shfl_sum(db1a[mt, hh], (1, 2))
            j = J0 + 16 * mt + G_ + 8 * hh + 0 * W
            ok = (Q_ == 0) & (j < jn)
            slot[(ob1 + j0 + j)[ok]] = v[ok]
    if chunk == 0:
        db2w = shfl_sum(db2a, (1, 2))                      # [8, W, 32]
        red = np.zeros((WARPS, CH), np.float32)
        for ct in range(8):
            for q0 in np.flatnonzero(Q_ == 0):
                red[:, 8 * ct + G_[q0]] = db2w[ct, :, q0]
        s2 = np.zeros(CH, np.float32)
        for w in range(WARPS):
            s2 += red[w]
        slot[ob2:ob2 + c_dec] = s2[:c_dec]
    return words


def dx_sum(dxp, gy, groups, slots):
    """dx_sum_kernel: dx rows and each block's dbc into its slot."""
    n, c_in = gy.shape
    dx = np.full((n, c_in), np.nan, np.float32)
    per = -(-n // groups)
    obc = slots.shape[1] - c_in
    for b in range(groups):
        r0, r1 = min(n, b * per), min(n, b * per + per)
        v = np.zeros((r1 - r0, c_in), np.float32)
        for k in range(dxp.shape[0]):          # the chunks in order
            v = (v + dxp[k, r0:r1, :c_in]).astype(np.float32)
        g = gy[r0:r1]
        dx[r0:r1] = bf16(v + g)
        red = np.zeros((DXS // 16, c_in), np.float32)
        for rl in range(DXS // 16):            # each lane's rows in order
            rows = g[rl::DXS // 16]
            if len(rows):
                red[rl] = np.cumsum(rows, 0, dtype=np.float32)[-1]
        slots[b, obc:] = np.cumsum(red, 0, dtype=np.float32)[-1]
    return dx


def twin(x, dd, gy, w1, b1, w2, groups):
    """(dx, dw1, db1, dw2, db2, dbc, dz^T words [n, c_mid], slots) as the
    two kernels address and sum them."""
    n, c_in = x.shape
    c_mid, c_dec = w2.shape
    chunks, ldp = split_plan(c_in, c_mid)
    ddg = np.concatenate([dd.reshape(-1), np.full(8, np.nan, np.float32)])
    slot_len = c_in * c_mid + c_mid * c_dec + c_mid + c_dec + c_in
    slots = np.full((groups, slot_len), np.nan, np.float32)
    dxp = np.full((chunks, n, ldp), np.nan, np.float32)
    dzt = np.full((n, c_mid), np.nan, np.float32)
    for blk in range(groups * chunks):
        words = split_block(SplitSmem(), blk, x, ddg, w1, b1, w2, groups,
                            dxp, slots)
        j0 = (blk % chunks) * JC
        for r, w in words.items():
            dzt[r, j0:j0 + len(w)] = w
    assert not np.isnan(dxp[:, :, :c_in]).any(), "a part of dx unwritten"
    dx = dx_sum(dxp, gy, groups, slots)
    assert not np.isnan(slots).any(), "a slot entry unwritten"
    total = np.zeros(slot_len, np.float32)
    for g in range(groups):
        total += slots[g]
    o2, ob1 = c_in * c_mid, c_in * c_mid + c_mid * c_dec
    return (dx, total[:o2].reshape(c_in, c_mid), total[ob1:ob1 + c_mid],
            total[o2:ob1].reshape(c_mid, c_dec),
            total[ob1 + c_mid:ob1 + c_mid + c_dec],
            total[ob1 + c_mid + c_dec:], dzt, slots)


SHAPES = [((1, 3, 11, 9), 64, 512, 51, 2),
          ((1, 2, 11, 9), 48, 384, 38, 3),
          ((1, 2, 5, 7), 64, 512, 51, H100_SLOTS),
          ((1, 3, 7, 9), 36, 300, 64, 2)]
IDS = ["c64_cmid512_297rows_g2", "c48_cmid384_198rows_g3",
       "c64_70rows_g264", "c36_cmid300_cdec64"]


@pytest.mark.parametrize("shape,c,cmid,cdec,groups", SHAPES, ids=IDS)
def test_split_twin_matches_blk_bwd_plain(shape, c, cmid, cdec, groups):
    """The 64-filter widths over five tiles (a partial last) in two slots
    (each slot's chunks 0 and 1), the 48-filter widths (C_mid 384: the
    second chunk half real, its last four warps all padding) in three
    slots, 70 rows (two tiles) in 264 slots (every slot past the second
    zero, dbc's rows cut per block), and 36/300/64 (c_in not a multiple of
    8: element copies of x and four-channel dx rows cut at 36; 64 decay
    channels, 128-byte dd rows)."""
    args, feed = case(shape, c, cmid, cdec, seed=sum(shape) + cmid)
    dx, dw1, db1, dw2, db2, dbc, dzt, slots = twin(*feed, groups)
    want = ts.blk_bwd_plain(*args)
    x2, dd2 = (torch.from_numpy(a) for a in feed[:2])
    w1f, w2f = args[3].float(), args[5].float()
    z = x2 @ w1f + args[4].float()
    dz = torch.where(z > 0, dd2 @ w2f.t(), 0.0).to(torch.bfloat16).float()
    np.testing.assert_array_equal(dzt, dz.numpy())
    np.testing.assert_array_equal(dx, want[0].float().reshape(dx.shape))
    np.testing.assert_array_equal(db2, want[5].numpy())
    np.testing.assert_array_equal(dbc, want[6].numpy())
    for name, got, ref in zip(BWD_NAMES[2:], (dw1, db1, dw2, db2, dbc),
                              want[2:]):
        assert got.shape == tuple(ref.shape), name
        assert max_rel(got, ref.numpy()) < SUM_TOL, (name,
                                                     max_rel(got, ref))
    tiles = -(-feed[0].shape[0] // ROWS)
    if groups > tiles:   # slots past the tiles hold zeros (dbc: past rows)
        assert (slots[tiles:, :-c] == 0).all()


def test_split_twin_matches_jax_pallas_blk_bwd(monkeypatch):
    """The 64-filter widths against the JAX package's Pallas kernel."""
    shape, c, cmid, cdec, groups = SHAPES[0]
    args, feed = case(shape, c, cmid, cdec, seed=sum(shape) + cmid + 1)
    ref = jax_pallas_blk_bwd(args, monkeypatch)
    got = twin(*feed, groups)
    tol = blk_bwd_tolerances(torch.bfloat16)
    assert max_rel(got[0], ref[0].reshape(got[0].shape)) < tol["dx"]
    for name, a, r in zip(BWD_NAMES[2:], got[1:6], ref[2:]):
        assert a.shape == r.shape, name
        assert max_rel(a, r) < tol[name], (name, max_rel(a, r))


def seg_bwd_split_smem():
    """blk_bwd.cu's seg_bwd_split_smem: the W1 and W2 planes [256][72] and
    dz^T [256][72], two each of the x and dd tiles [64][72], the warps' raw
    dd spans (bf16), the db2 sums [8][64] (float32)."""
    return 2 * (JC * (2 * CS + ZS) + 4 * ROWS * CS + WARPS * RAWW) + \
        4 * WARPS * CH


def test_split_layout_fits_and_leaves_the_flagship_plan_unchanged():
    """The split kernel's layout takes 157,952 of a block's 232,448 bytes
    at every width it is routed (it does not depend on them); the
    flagship kernel's stays 231,680.  The 72-element strides (36 words, 4
    mod 32) put the 8 rows of every ldmatrix and the 32 lanes of every
    dz^T word store in distinct banks; a warp's raw span holds its 8 rows
    of 64 channels from any 16-byte skew; the slot's dW1 and dW2 staging
    (64 x 256 floats) fits the W planes; dx's parts take 2 x N x 64 floats
    at 64/512 (and 2 x N x 48 at 48/384)."""
    assert seg_bwd_split_smem() == 157_952 <= OPTIN
    assert seg_bwd_bf16_smem() == 231_680
    for stride in (CS, ZS):
        banks = (np.arange(8)[:, None] * stride // 2 + np.arange(4)) % 32
        assert len(set(banks.ravel())) == 32
    assert len(set(((G_ * ZS + 2 * Q_) // 2) % 32)) == 32
    assert 8 * -(-(7 + DR * CH) // 8) <= RAWW
    assert 4 * CH * JC <= 2 * 2 * JC * CS
    assert split_plan(64, 512) == (2, 64) and split_plan(48, 384) == (2, 48)
    assert split_plan(36, 300) == (2, 40) and split_plan(64, 256) == (1, 64)
