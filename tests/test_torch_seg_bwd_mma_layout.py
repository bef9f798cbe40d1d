"""The addressing of the bf16 tensor-core seg_bwd of ``blk_bwd``, in numpy.

``seg_bwd_bf16_kernel`` (probav_tpu_torch/csrc/blk_bwd.cu) computes the
expand/decay backward of a block (dx = W1 dz + gy, dW1, db1, dW2, db2, dbc)
from x, dd and gy rows on mma.sync m16n8k16 (fragment layouts in
common.cuh):

- shared memory, in bf16 elements: W1 as [j][c] (row stride CS = 40), two
  dz^T buffers [256][ZS = 136] (W2 as [j][c] in the first while the
  fragments load), two each of the x, dd and gy tiles [128][40], and each
  warp's raw dd span;
- x rows land by 16-byte copies (zeros past n); warp w copies the dd of
  rows 16 w .. 16 w + 15 of a tile as one span from the 16-byte chunk
  below its start and repacks it to [row][40], zeros from c_dec and past
  n, and copies the gy of those rows;
- warp w owns middle channels 32 w .. 32 w + 31: the A fragments of W1^T
  and W2 (plain ldmatrix of the [j][c] planes) stay in its registers;
  per 16 rows, the B fragments of x^T and dd^T (plain ldmatrix) give z^T
  and W2 dd^T as C tiles (16 j x 8 rows); dz = bf16(W2 dd) where z + b1 >
  0, h = bf16(relu(z + b1)), and two C tiles adjacent in rows are the A
  fragment of dW1^T += dz^T x and dW2 += h^T dd, whose B fragments are
  x and dd by ldmatrix.trans; dz^T goes to the tile's dz^T buffer as
  bf16x2 words (a warp whose channels are all past c_mid writes zeros);
- phase C, run beside the block's next tile's products: warp w computes
  dx for rows 16 w .. 16 w + 15 over all 256 j: A = dz from dz^T and B =
  W1^T from the [j][c] plane, both by ldmatrix.trans; dx + gy is rounded
  to bf16, staged in place of the warp's gy and stored;
- db1 sums dz^T's C fragments per lane, db2 dd's .trans B fragments (warp
  w those of row group w), dbc gy at the epilogue; lanes and warps are
  reduced in a fixed order; each of the G blocks writes its slot, the G
  slots are summed in order.

The twin below models shared memory as one flat array with the kernel's
offsets, performs every ldmatrix by the lanes' addresses (checking their
16-byte alignment), rebuilds each mma's A, B and C matrices from the lanes'
registers, and is held to:

- ``blk_bwd_plain``: the dz^T words and the dx rows bit for bit; the
  float32 sums (dW1, db1, dW2, db2, dbc), which the twin takes 16 rows an
  mma and the plain version in BLAS's order, within 2e-6 of max|ref|: on
  the dyadic inputs of ``tools/dyadic.py`` every product is exact, but the
  partial sums of x dz (dz a bf16 number down to 2**-15) outgrow float32's
  24 bits, so the order shows in the last bits;
- the JAX package's Pallas ``blk_bwd`` in interpret mode at bf16, at
  ``blk_bwd_tolerances(bfloat16)``.

The kernel runs only on the card; this pins what it addresses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import probav_tpu.ops.pallas_tstack as jts
from probav_tpu_torch.ops import tstack as ts
from probav_tpu_torch.tools.dyadic import blk_bwd_inputs
from test_torch_kernels import BWD_NAMES, blk_bwd_tolerances

torch.set_num_threads(1)

ROWS, WARPS, CS = 128, 8, 40          # blk_bwd.cu's SBB_*
ZS = ROWS + 8
MT, RG, CTW = 2, ROWS // 16, 4        # j tiles a warp, row groups, dx tiles
RAWW = (16 * 64 + 43) // 16 * 8       # a warp's raw dd span, elements
H100_SLOTS = 264
LANE = np.arange(32)
G_, Q_ = LANE // 4, LANE % 4
L8, M2, H16 = LANE % 8, (LANE // 8) % 2, LANE // 16
SUM_TOL = 2e-6


def bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .to(torch.bfloat16).float().numpy()


class Smem:
    """The kernel's shared memory in bf16 elements (held as float32), NaN
    where nothing was written."""

    def __init__(self):
        self.w1s = 0
        self.zt = 256 * CS                    # [2][256][ZS]
        self.xb = self.zt + 2 * 256 * ZS      # [2][ROWS][CS] each:
        self.dbt = self.xb + 2 * ROWS * CS
        self.gyb = self.dbt + 2 * ROWS * CS
        self.raw = self.gyb + 2 * ROWS * CS   # [WARPS][RAWW]
        self.m = np.full(self.raw + WARPS * RAWW, np.nan, np.float32)

    def ldsm(self, addr, trans=False):
        """ldmatrix.x4 (.trans) at lane addresses ``addr`` [..., 32]:
        registers [..., 4, 32, 2] of two bf16 values each."""
        assert (addr % 8 == 0).all(), "ldmatrix rows must be 16-byte aligned"
        assert addr.min() >= 0 and addr.max() + 8 <= len(self.m)
        rows = self.m[addr[..., None] + np.arange(8)]       # [..., 32, 8]
        mats = rows.reshape(addr.shape[:-1] + (4, 8, 8))
        if trans:
            mats = np.swapaxes(mats, -1, -2)
        return mats[..., G_[:, None], 2 * Q_[:, None] + np.arange(2)]


def a_mat(a):
    """[..., 16, 16] A of m16n8k16 from its registers [..., 4, 32, 2]."""
    m = np.zeros(a.shape[:-3] + (16, 16))
    for i, (r, c) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        m[..., G_ + r, 2 * Q_ + c] = a[..., i, :, 0]
        m[..., G_ + r, 2 * Q_ + c + 1] = a[..., i, :, 1]
    return m


def b_mat(b0, b1):
    """[..., 16, 8] B (k x n) from its registers [..., 32, 2] each."""
    m = np.zeros(b0.shape[:-2] + (16, 8))
    for r, b in ((0, b0), (8, b1)):
        m[..., 2 * Q_ + r, G_] = b[..., 0]
        m[..., 2 * Q_ + r + 1, G_] = b[..., 1]
    return m


def c_mat(c):
    """[..., 16, 8] C from its four registers [..., 4, 32]."""
    m = np.zeros(c.shape[:-2] + (16, 8))
    m[..., G_, 2 * Q_], m[..., G_, 2 * Q_ + 1] = c[..., 0, :], c[..., 1, :]
    m[..., G_ + 8, 2 * Q_] = c[..., 2, :]
    m[..., G_ + 8, 2 * Q_ + 1] = c[..., 3, :]
    return m


def c_regs(m):
    return np.stack([m[..., G_, 2 * Q_], m[..., G_, 2 * Q_ + 1],
                     m[..., G_ + 8, 2 * Q_], m[..., G_ + 8, 2 * Q_ + 1]], -2)


def mma(c, a, b0, b1):
    """c += a b: exact bf16 products summed in float64, rounded into the
    float32 registers once an mma."""
    return c_regs(c_mat(c) + a_mat(a) @ b_mat(b0, b1)).astype(np.float32)


def shfl_sum(v, masks):
    """v += __shfl_xor_sync(v, m) for each m in order, over the last axis."""
    for m in masks:
        v = (v + v[..., LANE ^ m]).astype(np.float32)
    return v


def twin(x, dd, gy, w1, b1, w2, groups, trans_w1=True, dd_repacked=True):
    """(dx, dw1, db1, dw2, db2, dbc, dz^T words, slots) as
    seg_bwd_bf16_kernel addresses and sums them.  ``trans_w1=False`` reads
    phase C's W1^T fragments without .trans; ``dd_repacked=False`` reads dd
    straight from the raw span at its c_dec-element rows."""
    n, c_in = x.shape
    c_mid, c_dec = w2.shape
    tiles = -(-n // ROWS)
    nan8 = np.full(8, np.nan, np.float32)   # past the end of a global array
    ddg = np.concatenate([dd.reshape(-1), nan8])
    dx = np.full((n, c_in), np.nan, np.float32)
    slot_len = c_in * c_mid + c_mid * c_dec + c_mid + c_dec + c_in
    slots = np.full((groups, slot_len), np.nan, np.float32)
    dzt_words = np.full((n, c_mid), np.nan, np.float32)
    W = np.arange(WARPS)[:, None]
    J0 = 16 * MT * W                                    # [W, 1]
    for blk in range(groups):
        if blk >= tiles:   # no tile: the kernel writes zeros to the slot
            slots[blk] = 0.0
            continue
        S = Smem()
        w1p = np.zeros((256, 32), np.float32)
        w1p[:c_mid, :c_in] = w1.T
        w2p = np.zeros((256, 32), np.float32)
        w2p[:c_mid, :c_dec] = w2
        for base, plane in ((S.w1s, w1p), (S.zt, w2p)):
            S.m[base + np.arange(256)[:, None] * CS + np.arange(32)] = plane
        S.m[S.xb:S.raw] = 0.0         # the x, dd and gy tiles
        wa, wb = [], []
        for mt in range(MT):
            row = J0 + 16 * mt + 8 * M2 + L8                # [W, 32]
            wa.append([S.ldsm(S.w1s + row * CS + 16 * ks + 8 * H16)
                       for ks in range(2)])
            wb.append([S.ldsm(S.zt + row * CS + 16 * ks + 8 * H16)
                       for ks in range(2)])
        wa, wb = np.array(wa), np.array(wb)      # [MT, 2, W, 4, 32, 2]
        jb = J0[None, :, :] + 16 * np.arange(MT)[:, None, None] + G_
        bias = np.stack([np.where(jb + 8 * hh < c_mid,
                                  np.pad(b1, (0, 264))[jb + 8 * hh], 0)
                         for hh in range(2)]).astype(np.float32)
        acc1 = np.zeros((MT, 4, WARPS, 4, 32), np.float32)
        acc2 = np.zeros_like(acc1)
        db1a = np.zeros((MT, 2, WARPS, 32), np.float32)
        db2a = np.zeros((4, WARPS, 32), np.float32)
        dbca = np.zeros((CTW, 2, WARPS, 32), np.float32)
        for k, tile in enumerate(range(blk, tiles, groups)):
            buf = k % 2
            row0, nr = tile * ROWS, min(ROWS, n - tile * ROWS)
            xt = S.xb + buf * ROWS * CS
            dt = S.dbt + buf * ROWS * CS
            yt = S.gyb + buf * ROWS * CS
            zw = S.zt + buf * 256 * ZS
            # x: rows [0, nr) by 16-byte copies (or element copies), zeros
            # past nr; the columns from c_in on keep their zeros.
            xs = np.zeros((ROWS, c_in), np.float32)
            xs[:nr] = x[row0:row0 + nr]
            S.m[xt + np.arange(ROWS)[:, None] * CS + np.arange(c_in)] = xs
            # dd: warp w copies the span of its rows 16 w .. 16 w + 15 from
            # the chunk below its start into its raw buffer and repacks it.
            p, c = np.arange(16)[:, None], np.arange(32)
            skews = []
            for w in range(WARPS):
                nrw = min(16, nr - 16 * w)
                raw, skew = S.raw + w * RAWW, 0
                if nrw > 0:
                    src = (row0 + 16 * w) * c_dec
                    a0 = src - src % 8
                    chunks = -(-(src + nrw * c_dec - a0) // 8)
                    assert 8 * chunks <= RAWW
                    S.m[raw:raw + 8 * chunks] = ddg[a0:a0 + 8 * chunks]
                    skew = src - a0
                skews.append(skew)
                inside = (p < nrw) & (c < c_dec)
                S.m[dt + (16 * w + p) * CS + c] = np.where(
                    inside, S.m[np.where(inside, raw + skew + p * c_dec + c,
                                         raw)], 0.0)
            if dd_repacked:
                d_at = lambda rows, cols: dt + rows * CS + cols
            else:   # the raw spans at their c_dec-element rows
                d_at = lambda rows, cols: (
                    S.raw + rows // 16 * RAWW + np.array(skews)[rows // 16] +
                    rows % 16 * c_dec + cols)
            # gy: each warp its 16 rows, zeros past n and from c_in.
            gs = np.zeros((ROWS, 32), np.float32)
            gs[:nr, :c_in] = gy[row0:row0 + nr]
            S.m[yt + np.arange(ROWS)[:, None] * CS + c] = gs

            # Phases A and B, every warp at once (a warp whose channels are
            # all past c_mid computes zeros).
            act = slice(0, WARPS)
            for rg in range(RG):
                r0 = 16 * rg
                xf = [S.ldsm(xt + (r0 + 8 * t + L8) * CS + 8 * (LANE // 8))
                      for t in range(2)]
                df = [S.ldsm(d_at(r0 + 8 * t + L8, 8 * (LANE // 8)))
                      for t in range(2)]
                xtr = [S.ldsm(xt + (r0 + 8 * M2 + L8) * CS +
                              8 * (2 * t + H16), trans=True)
                       for t in range(2)]
                dtr = [S.ldsm(d_at(r0 + 8 * M2 + L8, 8 * (2 * t + H16)),
                              trans=True) for t in range(2)]
                for mt in range(MT):
                    adz = np.zeros((WARPS, 4, 32, 2), np.float32)
                    ah = np.zeros_like(adz)
                    for nt in range(2):
                        z = np.zeros((WARPS, 4, 32), np.float32)
                        gg = np.zeros_like(z)
                        for ks in range(2):
                            z = mma(z, wa[mt, ks, act], xf[nt][2 * ks],
                                    xf[nt][2 * ks + 1])
                            gg = mma(gg, wb[mt, ks, act], df[nt][2 * ks],
                                     df[nt][2 * ks + 1])
                        for hh in range(2):
                            zz = np.stack([z[:, 2 * hh], z[:, 2 * hh + 1]],
                                          -1) + bias[hh, mt, act, :, None]
                            g2 = np.stack([gg[:, 2 * hh], gg[:, 2 * hh + 1]],
                                          -1)
                            dzp = np.where(zz > 0, bf16(g2), 0.0)
                            adz[:, 2 * nt + hh] = dzp
                            ah[:, 2 * nt + hh] = bf16(np.maximum(zz, 0.0))
                            db1a[mt, hh, act] += (dzp[..., 0] + dzp[..., 1]
                                                  ).astype(np.float32)
                            jrow = J0[act] + 16 * mt + G_ + 8 * hh
                            at = zw + jrow * ZS + r0 + 8 * nt + 2 * Q_
                            S.m[at], S.m[at + 1] = dzp[..., 0], dzp[..., 1]
                    for t in range(2):
                        for u in range(2):
                            acc1[mt, 2 * t + u, act] = mma(
                                acc1[mt, 2 * t + u, act], adz,
                                xtr[t][2 * u], xtr[t][2 * u + 1])
                            acc2[mt, 2 * t + u, act] = mma(
                                acc2[mt, 2 * t + u, act], ah,
                                dtr[t][2 * u], dtr[t][2 * u + 1])
                w = rg % WARPS
                for t in range(2):
                    for i in range(4):
                        db2a[2 * t + i // 2, w] += (
                            dtr[t][i, :, 0] + dtr[t][i, :, 1]
                        ).astype(np.float32)
            # The dz^T words of this tile's rows, for the test.
            zrows = S.m[zw + np.arange(c_mid)[:, None] * ZS + np.arange(nr)]
            dzt_words[row0:row0 + nr] = zrows.T

            # Phase C (in the kernel, beside the block's next tile's phases
            # A and B): warp w, rows 16 w .. 16 w + 15, all of dx's columns,
            # over all 256 j.
            pr0 = 16 * W                                     # [W, 1]
            za = zw + (8 * H16 + L8) * ZS + pr0 + 8 * M2
            wp = S.w1s + (8 * M2 + L8) * CS + 8 * H16
            dxc = np.zeros((CTW, WARPS, 4, 32), np.float32)
            for ks in range(16):
                a = S.ldsm(za + ks * 16 * ZS, trans=True)
                for pp in range(CTW // 2):
                    b = S.ldsm(wp + ks * 16 * CS + 16 * pp, trans=trans_w1)
                    for u in range(2):
                        dxc[2 * pp + u] = mma(dxc[2 * pp + u], a, b[2 * u],
                                              b[2 * u + 1])
            # Epilogue: dx + gy in float32, bf16, staged in place of the
            # warp's gy rows, stored for rows < n and columns < c_in.
            for t in range(CTW):
                for hh in range(2):
                    off = (pr0 + G_ + 8 * hh) * CS + 8 * t + 2 * Q_
                    g0, g1 = S.m[yt + off], S.m[yt + off + 1]
                    dbca[t, 0] += g0
                    dbca[t, 1] += g1
                    S.m[yt + off] = bf16(dxc[t, :, 2 * hh] + g0)
                    S.m[yt + off + 1] = bf16(dxc[t, :, 2 * hh + 1] + g1)
            dx[row0:row0 + nr] = S.m[yt + np.arange(nr)[:, None] * CS +
                                     np.arange(c_in)]

        # The block's slot: dW1 [c][j], dW2 [j][c], db1, db2, dbc.
        slot = slots[blk]
        o2, ob1 = c_in * c_mid, c_in * c_mid + c_mid * c_dec
        ob2, obc = ob1 + c_mid, ob1 + c_mid + c_dec
        for mt in range(MT):
            for ct in range(4):
                for i in range(4):
                    j = J0 + 16 * mt + G_ + 8 * (i // 2)    # [W, 32]
                    cc = 8 * ct + 2 * Q_ + (i & 1) + 0 * j
                    ok = j < c_mid
                    k1 = ok & (cc < c_in)
                    slot[(cc * c_mid + j)[k1]] = acc1[mt, ct][:, i][k1]
                    k2 = ok & (cc < c_dec)
                    slot[(o2 + j * c_dec + cc)[k2]] = acc2[mt, ct][:, i][k2]
            for hh in range(2):
                v = shfl_sum(db1a[mt, hh], (1, 2))
                j = J0 + 16 * mt + G_ + 8 * hh + 0 * W
                ok = (Q_ == 0) & (j < c_mid)
                slot[(ob1 + j)[ok]] = v[ok]
        db2w = shfl_sum(db2a, (1, 2))                      # [4, W, 32]
        red2 = np.zeros((WARPS, 32), np.float32)
        for ct in range(4):
            for q0 in np.flatnonzero(Q_ == 0):
                red2[:, 8 * ct + G_[q0]] = db2w[ct, :, q0]
        dbcw = shfl_sum(dbca, (4, 8, 16))                  # [CTW, 2, W, 32]
        red = np.zeros((WARPS, 32), np.float32)
        for t in range(CTW):
            for u in range(2):
                for l in np.flatnonzero(G_ == 0):
                    red[:, 8 * t + 2 * Q_[l] + u] = dbcw[t, u, :, l]
        s2 = np.zeros(32, np.float32)
        sc = np.zeros(32, np.float32)
        for w in range(WARPS):
            s2 += red2[w]
            sc += red[w]
        slot[ob2:obc] = s2[:c_dec]
        slot[obc:] = sc[:c_in]

    total = np.zeros(slot_len, np.float32)
    for g in range(groups):
        total += slots[g]
    o2, ob1 = c_in * c_mid, c_in * c_mid + c_mid * c_dec
    return (dx, total[:o2].reshape(c_in, c_mid), total[ob1:ob1 + c_mid],
            total[o2:ob1].reshape(c_mid, c_dec),
            total[ob1 + c_mid:ob1 + c_mid + c_dec],
            total[ob1 + c_mid + c_dec:], dzt_words, slots)


def plain_dd(gy, wc):
    """blk_bwd_plain's dd: the conv transpose of gy, rounded to gy's
    dtype (bf16 here)."""
    w = wc.float().permute(4, 3, 0, 1, 2)
    dd5 = F.conv_transpose3d(gy.float().permute(0, 4, 1, 2, 3), w, padding=1)
    return dd5.to(gy.dtype).float().permute(0, 2, 3, 4, 1)


def case(shape, c, cmid, cdec, seed):
    """bf16 dyadic inputs, the twin's rows and the plain reference."""
    args = blk_bwd_inputs(shape, c, cmid, cdec, seed=seed,
                          dtype=torch.bfloat16)
    gy, x, d, w1, b1, w2, wc = args
    rows = lambda t, k: t.float().reshape(-1, k).numpy()
    feed = (rows(x, c), rows(plain_dd(gy, wc), cdec), rows(gy, c),
            w1.float().numpy(), b1.float().numpy(), w2.float().numpy())
    return args, feed


def max_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


SHAPES = [((1, 3, 7, 9), 32, 256, 25, 2), ((1, 3, 5, 7), 32, 256, 25,
                                            H100_SLOTS),
          ((1, 3, 5, 7), 8, 64, 6, 1), ((1, 3, 5, 9), 24, 200, 19, 1),
          ((1, 2, 8, 9), 32, 256, 32, 1)]
IDS = ["flagship_widths_189rows_g2", "flagship_105rows_g264", "c8_cmid64",
       "c24_cmid200", "cdec32"]


@pytest.mark.parametrize("shape,c,cmid,cdec,groups", SHAPES, ids=IDS)
def test_twin_matches_blk_bwd_plain(shape, c, cmid, cdec, groups):
    """The flagship's widths over two tiles (a partial second) in two
    blocks, 105 rows (under one tile) in 264 blocks (every slot but the
    first zero), 8/64/6 (two warps active), 24/200/19 (a warp's channels
    cut short) and c_dec = 32 (64-byte dd rows)."""
    args, feed = case(shape, c, cmid, cdec, seed=sum(shape) + cmid)
    dx, dw1, db1, dw2, db2, dbc, dzt, slots = twin(*feed, groups)
    want = ts.blk_bwd_plain(*args)
    # dz as plain rounds it, word for word.
    x2, dd2 = (torch.from_numpy(a) for a in feed[:2])
    w1f, w2f = args[3].float(), args[5].float()
    z = x2 @ w1f + args[4].float()
    dz = torch.where(z > 0, dd2 @ w2f.t(), 0.0).to(torch.bfloat16).float()
    np.testing.assert_array_equal(dzt, dz.numpy())
    np.testing.assert_array_equal(dx, want[0].float().reshape(dx.shape))
    for name, got, ref in zip(BWD_NAMES[2:], (dw1, db1, dw2, db2, dbc),
                              want[2:]):
        assert got.shape == tuple(ref.shape), name
        assert max_rel(got, ref.numpy()) < SUM_TOL, (name,
                                                     max_rel(got, ref))
    if groups > 1:   # blocks past the tiles hold zeros
        tiles = -(-feed[0].shape[0] // ROWS)
        assert (slots[tiles:] == 0).all()


def jax_pallas_blk_bwd(args, monkeypatch):
    """(dx, dwc, dw1, db1, dw2, db2, dbc) of the JAX package's Pallas
    blk_bwd in interpret mode at bf16, on the block's [C, ext] layout."""
    monkeypatch.setattr(jts, "INTERPRET", True)
    gy, x, d, w1, b1, w2, wc = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                for t in args)
    b, h, w, t, c = x.shape
    s = h * (w + 2) * (t + 2)   # one grid step: interpret mode runs fast
    g = jts.make_geom(h, w, t, b, target_rows=s, target_ch=s, itemsize=2,
                      width=c)
    im = jts.interior_mask(g, jnp.bfloat16)
    out = jts.blk_bwd(g, jts.to_t(gy, g) * im, jts.to_t(d, g),
                      jts.to_t(x, g), wc, w1, b1.astype(jnp.float32), w2, im)
    return (np.asarray(jts.from_t(out[0], g, b, h, w, t), np.float32),) + \
        tuple(np.asarray(o, np.float32) for o in out[1:])


@pytest.mark.parametrize("shape,c,cmid,cdec,groups",
                         [SHAPES[0], SHAPES[2]], ids=[IDS[0], IDS[2]])
def test_twin_matches_jax_pallas_blk_bwd(shape, c, cmid, cdec, groups,
                                         monkeypatch):
    args, feed = case(shape, c, cmid, cdec, seed=sum(shape) + cmid + 1)
    ref = jax_pallas_blk_bwd(args, monkeypatch)
    got = twin(*feed, groups)
    tol = blk_bwd_tolerances(torch.bfloat16)
    assert max_rel(got[0], ref[0].reshape(got[0].shape)) < tol["dx"]
    for name, a, r in zip(BWD_NAMES[2:], got[1:6], ref[2:]):
        assert a.shape == r.shape, name
        assert max_rel(a, r) < tol[name], (name, max_rel(a, r))


def test_twin_without_trans_on_w1_is_wrong():
    """Phase C's W1^T fragments read plain, not .trans, pair dz with the
    wrong weights: dx far beyond the bf16 tolerance."""
    args, feed = case((1, 3, 7, 9), 32, 256, 25, seed=3)
    dx = twin(*feed, 2, trans_w1=False)[0]
    want = ts.blk_bwd_plain(*args)[0].float().reshape(dx.shape).numpy()
    assert max_rel(dx, want) > 0.1


def test_twin_reading_dd_unrepacked_is_refused():
    """dd read straight from the raw span at its 50-byte rows (c_dec = 25)
    puts ldmatrix rows off their 16-byte alignment: the repack is what
    makes the fragments loadable."""
    _, feed = case((1, 3, 7, 9), 32, 256, 25, seed=4)
    with pytest.raises(AssertionError, match="16-byte aligned"):
        twin(*feed, 2, dd_repacked=False)


def seg_bwd_bf16_smem(rows=ROWS, warps=WARPS):
    """blk_bwd.cu's seg_bwd_bf16_smem: W1 [256][40], two dz^T buffers
    [256][rows + 8], two each of the x, dd and gy tiles [rows][40], each
    warp's raw dd span (bf16), and the dbc / db2 sums [2][warps][32]
    (float32)."""
    return 2 * (256 * (CS + 2 * (rows + 8)) + 6 * rows * CS +
                warps * RAWW) + 4 * 2 * warps * 32


def test_layout_fits_and_fragment_accesses_are_conflict_free():
    """The shipped shape takes 231,680 of a block's 232,448 bytes (one
    block an SM; 16 warps would not fit, nor two blocks of 8); 64-row tiles
    take 135,424.  dz^T's row stride (68 words, 4 mod 32) and the tiles'
    (20 words) put the 8 rows of every ldmatrix and the 32 lanes of every
    dz^T word store in distinct banks; a warp's raw span holds its 16 rows
    of 32 channels from any 16-byte skew; dW1's slot staging (8,192
    floats) fits the dz^T space."""
    assert seg_bwd_bf16_smem() == 231_680 <= 232_448
    assert seg_bwd_bf16_smem(warps=16) > 232_448
    assert seg_bwd_bf16_smem(64) == 135_424
    for stride in (CS, ZS):
        banks = (np.arange(8)[:, None] * stride // 2 + np.arange(4)) % 32
        assert len(set(banks.ravel())) == 32
    words = ((G_ * ZS + 2 * Q_) // 2) % 32
    assert len(set(words)) == 32
    assert 256 * ZS * 2 >= 256 * 32 * 4
    assert 8 * -(-(7 + 16 * 32) // 8) <= RAWW


def test_seg_bwd_variants_tool_applies_to_the_kernel_source():
    """tools/seg_bwd_variants.py builds its variants by substitution in the
    kernel's section of blk_bwd.cu: every substitution still finds its
    text, and each variant gets its own copy of the kernel and a launch
    case."""
    from probav_tpu_torch.tools import seg_bwd_variants as sv
    names = list(sv.VARIANTS)
    src = sv.source(names)
    assert src.count("seg_bwd_bf16_kernel(const __nv_bfloat16* __restrict__"
                     " x") == len(names)
    for i in range(len(names)):
        assert f"if (v == {i}) return v{i}::launch_seg_bwd_bf16(" in src
    assert "constexpr int SBB_ROWS = 64;" in sv.source(["rows64"])
    assert "fake_mma(" in sv.source(["no_mma"])
    after = sv.source(["phase_c_after"])
    assert after.count(sv._PHASE_C) == 2 and "++rg) phase_c(" in after
    assert "struct Slot" in src and "seg_bwd_tf32_kernel" not in src
