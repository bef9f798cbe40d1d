"""The addressing of the bf16 tensor-core wide_bwd, in numpy.

``wide_bwd_bf16_kernel`` (probav_tpu_torch/csrc/blk_bwd.cu) computes the
flat expand/decay backward (dx = dz W1^T, dW1, db1, dW2, db2, with dz and
h = relu(z) in float32) from x and dy rows on mma.sync m16n8k16 (fragment
layouts in common.cuh):

- shared memory, in bytes: the float32 dz buffer [128][ZS = 260] (W2 as
  bf16 [j][c] there while the fragments load), W1 as bf16 [j][c] (row
  stride CS = 40), two each of the x and dy tiles [128][40], the dx tile
  [128][40], each warp's raw dy span, and the db2 sums [8][32];
- x rows land by 16-byte copies (zeros past n), into tiles whose columns
  from c_in on were zeroed once; warp w copies the dy of rows 16 w .. 16 w
  + 15 of a tile as one span from the 16-byte chunk below its start and
  repacks it to [row][40], zeros from c_dec and past n;
- warp w owns middle channels 32 w .. 32 w + 31: the A fragments of W1^T
  and W2 stay in its registers; per 16 rows, the B fragments of x^T and
  dy^T give z^T and W2 dy^T as C tiles; dz = W2 dy where z + b1 > 0 and h
  = relu(z + b1) stay float32, each pair is split into three bf16x2 words
  (hi, mid, lo), and the three A fragments feed dW1^T += dz^T x and dW2 +=
  h^T dy (lo, then mid, then hi), whose B fragments are x and dy by
  ldmatrix.trans; dz goes to the tile's buffer as float32 [row][j];
- phase C, after the tile's products: warp w computes dx for rows 16 w ..
  16 w + 15 and all 32 columns over all 256 j: A = dz by plain ldmatrix of the
  float32 rows (lane (g, q) receives dz[g][j0 + 4 i + q] of matrix i, so
  the fragment's k order is permuted), split three ways; B = W1^T from the
  [j][c] plane by ldmatrix.trans, its rows in the same permuted order; dx
  is rounded to bf16, staged in the dx tile and stored;
- db1 sums dz's C fragments per lane, db2 dy's .trans B fragments (warp w
  those of row group w); lanes and warps are reduced in a fixed order;
  the launch is one wave, min(G, resident) blocks (one an SM), each
  taking every blocks-th tile and writing its slot (dW1 | dW2 | db1 |
  db2); the slots of the blocks not launched are neither written nor
  read, and the launched blocks' slots are summed in order.

The twin below models shared memory as the kernel's bytes (0xff, a NaN in
either type, where nothing was written), performs every ldmatrix by the
lanes' addresses (checking their 16-byte alignment), rebuilds each mma's
A, B and C matrices from the lanes' registers, and is held to:

- ``wide_bwd_plain``, on the dyadic inputs of ``tools/dyadic.py`` at bf16:
  the float32 dz words and the dx rows bit for bit; the float32 sums (dW1,
  db1, dW2, db2), which the twin takes 16 rows an mma and a piece at a
  time and the plain version in BLAS's order, within 2e-6 of max|ref|
  (every product is exact, but the partial sums of x dz outgrow float32's
  24 bits, so the order shows in the last bits);
- the JAX package's Pallas ``_bwd`` in interpret mode at bf16, at the
  tolerances of ``test_wide_bwd_matches_plain_on_card``: dx 8e-3 and the
  gradients 1e-4 of max|ref|.

The kernel runs only on the card; this pins what it addresses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from probav_tpu.ops import pallas_wide_block as pwb
from probav_tpu_torch.ops import wide_block as wb
from probav_tpu_torch.tools.dyadic import grid, wide_bwd_inputs

torch.set_num_threads(1)

ROWS, WARPS, CS, ZS = 128, 8, 40, 256 + 4   # blk_bwd.cu's WBB_*
MT, RG = 2, ROWS // 16                # j tiles a warp, row groups a tile
RPW = ROWS // WARPS                   # dy rows a warp stages
RAWW = (RPW * 64 + 43) // 16 * 8      # a warp's raw dy span, elements
H100_SLOTS, H100_SMS = 264, 132   # the wrapper's G; one block an SM
SMEM_OPTIN = 232_448
LANE = np.arange(32)
G_, Q_ = LANE // 4, LANE % 4
L8, M2, H16 = LANE % 8, (LANE // 8) % 2, LANE // 16
W_ = np.arange(WARPS)[:, None]
SUM_TOL = 2e-6
NAMES = ("dx", "dw1", "db1", "dw2", "db2")


def bf16_bits(v):
    """uint16 bits of float32 values rounded to bf16 (nearest, even)."""
    t = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def from_bf16(bits):
    return (np.asarray(bits).astype(np.uint32) << 16).view(np.float32)


def bf16(v):
    return from_bf16(bf16_bits(v))


def pack(lo, hi):
    """bf16x2 words of float32 pairs (lo in the low half), each rounded."""
    return bf16_bits(lo).astype(np.uint32) | \
        (bf16_bits(hi).astype(np.uint32) << 16)


def unpack(w):
    w = np.asarray(w, np.uint32)
    return from_bf16(w & 0xffff), from_bf16(w >> 16)


def split3(v0, v1, pieces=3):
    """split3_bf16x2: the bf16x2 words (hi, mid, lo) of the pair (v0, v1),
    each difference taken in float32.  ``pieces`` < 3 zeroes the smallest
    pieces (what a kernel with fewer pieces adds)."""
    v0, v1 = np.float32(v0), np.float32(v1)
    hi = pack(v0, v1)
    h0, h1 = unpack(hi)
    r0, r1 = (v0 - h0).astype(np.float32), (v1 - h1).astype(np.float32)
    mid = pack(r0, r1)
    m0, m1 = unpack(mid)
    lo = pack((r0 - m0).astype(np.float32), (r1 - m1).astype(np.float32))
    out = [hi, mid, lo]
    for p in range(pieces, 3):
        out[p] = np.zeros_like(hi)
    return out


class Smem:
    """The kernel's shared memory as bytes (0xff where nothing was
    written: NaN in bf16 and in float32); offsets as in the kernel."""

    def __init__(self):
        self.zb = 0                                  # float32 [ROWS][ZS]
        self.w1s = 4 * ROWS * ZS                     # bf16 [256][CS]
        self.xb = self.w1s + 2 * 256 * CS            # bf16 [2][ROWS][CS]
        self.dyt = self.xb + 2 * 2 * ROWS * CS       # bf16 [2][ROWS][CS]
        self.dxs = self.dyt + 2 * 2 * ROWS * CS      # bf16 [ROWS][CS]
        self.raw = self.dxs + 2 * ROWS * CS          # bf16 [WARPS][RAWW]
        self.red = self.raw + 2 * WARPS * RAWW       # float32 [WARPS][32]
        self.size = self.red + 4 * WARPS * 32
        self.b = np.full(self.size, 0xff, np.uint8)

    def _u16(self, addr):
        addr = np.asarray(addr)
        assert (addr % 2 == 0).all() and addr.min() >= 0 and \
            addr.max() + 2 <= self.size
        return addr // 2

    def _u32(self, addr):
        addr = np.asarray(addr)
        assert (addr % 4 == 0).all() and addr.min() >= 0 and \
            addr.max() + 4 <= self.size
        return addr // 4

    def put16(self, addr, bits):
        self.b.view(np.uint16)[self._u16(addr)] = bits

    def get16(self, addr):
        return self.b.view(np.uint16)[self._u16(addr)]

    def put32(self, addr, v):
        self.b.view(np.float32)[self._u32(addr)] = v

    def get32(self, addr):
        return self.b.view(np.float32)[self._u32(addr)]

    def ldsm(self, addr, trans=False):
        """ldmatrix.x4 (.trans) at lane byte addresses ``addr`` [..., 32]:
        registers [..., 4, 32] (uint32).  Lane l gives row l % 8 of matrix
        l / 8; plain, lane (g, q) receives word q of row g; .trans, the
        b16 elements (row 2q, column g) and (row 2q + 1, column g)."""
        addr = np.asarray(addr)
        assert (addr % 16 == 0).all(), "ldmatrix rows must be 16-byte aligned"
        assert addr.min() >= 0 and addr.max() + 16 <= self.size
        rows = self.b[addr[..., None] + np.arange(16)]       # [..., 32, 16]
        mats = rows.reshape(addr.shape[:-1] + (4, 8, 16))
        if not trans:
            words = mats.view(np.uint32)                       # [..., 4, 8, 4]
            return words[..., G_, Q_]
        el = mats.view(np.uint16).astype(np.uint32)            # [..., 4, 8, 8]
        return el[..., 2 * Q_, G_] | (el[..., 2 * Q_ + 1, G_] << 16)


def a_mat(a):
    """[..., 16, 16] A of m16n8k16 from its registers [..., 4, 32]."""
    m = np.zeros(a.shape[:-2] + (16, 16))
    for i, (r, c) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        lo, hi = unpack(a[..., i, :])
        m[..., G_ + r, 2 * Q_ + c] = lo
        m[..., G_ + r, 2 * Q_ + c + 1] = hi
    return m


def b_mat(b0, b1):
    """[..., 16, 8] B (k x n) from its registers [..., 32] each."""
    m = np.zeros(b0.shape[:-1] + (16, 8))
    for r, b in ((0, b0), (8, b1)):
        lo, hi = unpack(b)
        m[..., 2 * Q_ + r, G_] = lo
        m[..., 2 * Q_ + r + 1, G_] = hi
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


def twin(x, w1, b1, w2, dy, groups, pieces=3, zero_pad=True, perm_w1=True,
         resident=H100_SMS):
    """(dx, dw1, db1, dw2, db2, dz words, slots) as wide_bwd_bf16_kernel
    addresses and sums them (x, w1, w2, dy bf16 values in float32 arrays,
    b1 float32).  ``pieces`` < 3 drops the smallest pieces of each split
    (1: dz and h rounded to bf16 once); ``zero_pad=False`` leaves the x
    tiles unzeroed, so pad columns hold NaN; ``perm_w1=False`` reads phase
    C's W1^T rows in plain order, not the A fragment's k order."""
    n, c_in = x.shape
    c_mid, c_dec = w2.shape
    tiles = -(-n // ROWS)
    # dy in device memory as bf16 bits, NaN past its end (a span's last
    # 16-byte chunk may reach up to 7 elements beyond).
    dyg = np.concatenate([bf16_bits(dy.reshape(-1)),
                          np.full(8, 0xffff, np.uint16)])
    dx = np.full((n, c_in), np.nan, np.float32)
    slot_len = c_in * c_mid + c_mid * c_dec + c_mid + c_dec
    slots = np.full((groups, slot_len), np.nan, np.float32)
    # One wave: min(G, resident) blocks, block b taking tiles b, b +
    # blocks, ...; the slots of the blocks not launched left unwritten.
    blocks = min(groups, resident)
    dz_words = np.full((n, c_mid), np.nan, np.float32)
    J0 = 16 * MT * W_                                   # [W, 1]
    pr0, dr0 = 16 * W_, RPW * W_
    for blk in range(blocks):
        S = Smem()
        w1p = np.zeros((256, 32), np.float32)
        w1p[:c_mid, :c_in] = w1.T
        w2p = np.zeros((256, 32), np.float32)
        w2p[:c_mid, :c_dec] = w2
        jc = np.arange(256)[:, None] * CS + np.arange(32)
        S.put16(S.w1s + 2 * jc, bf16_bits(w1p))
        S.put16(S.zb + 2 * jc, bf16_bits(w2p))
        if zero_pad:
            S.b[S.xb:S.dyt] = 0
        wa, wb_ = [], []
        for mt in range(MT):
            row = J0 + 16 * mt + 8 * M2 + L8                # [W, 32]
            wa.append([S.ldsm(S.w1s + 2 * (row * CS + 16 * ks + 8 * H16))
                       for ks in range(2)])
            wb_.append([S.ldsm(S.zb + 2 * (row * CS + 16 * ks + 8 * H16))
                        for ks in range(2)])
        wa, wb_ = np.array(wa), np.array(wb_)    # [MT, 2, W, 4, 32]
        jb = J0[None] + 16 * np.arange(MT)[:, None, None] + G_
        bias = np.stack([np.where(jb + 8 * hh < c_mid,
                                  np.pad(b1, (0, 264))[jb + 8 * hh], 0)
                         for hh in range(2)]).astype(np.float32)
        acc1 = np.zeros((MT, 4, WARPS, 4, 32), np.float32)
        acc2 = np.zeros_like(acc1)
        db1a = np.zeros((MT, 2, WARPS, 32), np.float32)
        db2a = np.zeros((4, WARPS, 32), np.float32)
        for k, tile in enumerate(range(blk, tiles, blocks)):
            buf = k % 2
            row0, nr = tile * ROWS, min(ROWS, n - tile * ROWS)
            xt = S.xb + 2 * buf * ROWS * CS
            dt = S.dyt + 2 * buf * ROWS * CS
            zw = S.zb
            # x: rows [0, nr), zeros past nr; columns from c_in untouched.
            xs = np.zeros((ROWS, c_in), np.float32)
            xs[:nr] = x[row0:row0 + nr]
            S.put16(xt + 2 * (np.arange(ROWS)[:, None] * CS +
                              np.arange(c_in)), bf16_bits(xs))
            # dy: warp w copies the span of its RPW rows from the chunk below
            # their start into its raw buffer and repacks them.
            p, c = np.arange(RPW)[:, None], np.arange(32)
            for w in range(WARPS):
                nrw = min(RPW, nr - RPW * w)
                raw, skew = S.raw + 2 * w * RAWW, 0
                if nrw > 0:
                    src = (row0 + RPW * w) * c_dec
                    a0 = src - src % 8
                    chunks = -(-(src + nrw * c_dec - a0) // 8)
                    assert 8 * chunks <= RAWW
                    S.put16(raw + 2 * np.arange(8 * chunks),
                            dyg[a0:a0 + 8 * chunks])
                    skew = src - a0
                inside = (p < nrw) & (c < c_dec)
                got = S.get16(np.where(inside, raw + 2 * (skew + p * c_dec +
                                                          c), raw))
                S.put16(dt + 2 * ((RPW * w + p) * CS + c),
                        np.where(inside, got, 0))

            # Phases A and B, every warp at once (a warp whose channels are
            # all past c_mid computes zeros).
            for rg in range(RG):
                r0 = 16 * rg
                xf = [S.ldsm(xt + 2 * ((r0 + 8 * t + L8) * CS +
                                       8 * (LANE // 8))) for t in range(2)]
                df = [S.ldsm(dt + 2 * ((r0 + 8 * t + L8) * CS +
                                       8 * (LANE // 8))) for t in range(2)]
                tr = lambda t: 2 * ((r0 + 8 * M2 + L8) * CS + 8 * (2 * t + H16))
                xtr = [S.ldsm(xt + tr(t), trans=True) for t in range(2)]
                dtr = [S.ldsm(dt + tr(t), trans=True) for t in range(2)]
                for mt in range(MT):
                    adz = np.zeros((3, WARPS, 4, 32), np.uint32)
                    ah = np.zeros_like(adz)
                    for nt in range(2):
                        z = np.zeros((WARPS, 4, 32), np.float32)
                        gg = np.zeros_like(z)
                        for ks in range(2):
                            z = mma(z, wa[mt, ks], xf[nt][2 * ks],
                                    xf[nt][2 * ks + 1])
                            gg = mma(gg, wb_[mt, ks], df[nt][2 * ks],
                                     df[nt][2 * ks + 1])
                        for hh in range(2):
                            b = bias[hh, mt][:, :]            # [W, 32]
                            z0 = (z[:, 2 * hh] + b).astype(np.float32)
                            z1 = (z[:, 2 * hh + 1] + b).astype(np.float32)
                            dz0 = np.where(z0 > 0, gg[:, 2 * hh], 0)
                            dz1 = np.where(z1 > 0, gg[:, 2 * hh + 1], 0)
                            dz0, dz1 = (dz0.astype(np.float32),
                                        dz1.astype(np.float32))
                            i = 2 * nt + hh
                            for pc, v in enumerate(split3(dz0, dz1, pieces)):
                                adz[pc, :, i] = v
                            for pc, v in enumerate(split3(   # fmaxf
                                    np.fmax(z0, 0), np.fmax(z1, 0), pieces)):
                                ah[pc, :, i] = v
                            db1a[mt, hh] += (dz0 + dz1).astype(np.float32)
                            at = zw + 4 * ((r0 + 8 * nt + 2 * Q_) * ZS +
                                           J0 + 16 * mt + G_ + 8 * hh)
                            S.put32(at, dz0)
                            S.put32(at + 4 * ZS, dz1)
                    for pc in (2, 1, 0):                      # lo, mid, hi
                        for t in range(2):
                            for u in range(2):
                                acc1[mt, 2 * t + u] = mma(
                                    acc1[mt, 2 * t + u], adz[pc],
                                    xtr[t][2 * u], xtr[t][2 * u + 1])
                                acc2[mt, 2 * t + u] = mma(
                                    acc2[mt, 2 * t + u], ah[pc],
                                    dtr[t][2 * u], dtr[t][2 * u + 1])
                w = rg % WARPS
                for t in range(2):
                    for i in range(4):
                        lo, hi = unpack(dtr[t][i])
                        db2a[2 * t + i // 2, w] += (lo + hi).astype(
                            np.float32)
            # The dz words of this tile's rows, for the test.
            zrows = S.get32(zw + 4 * (np.arange(nr)[:, None] * ZS +
                                      np.arange(c_mid)))
            dz_words[row0:row0 + nr] = zrows

            # Phase C, after the tile's products.
            zoff = (pr0 + L8) * ZS + 4 * (LANE // 8)          # [W, 32]
            wrow = 8 * M2 + (4 * (LANE % 2) + L8 // 2 if perm_w1 else L8)
            wp = S.w1s + 2 * (wrow * CS + 8 * H16) + 0 * W_   # [W, 32]
            dxc = np.zeros((4, WARPS, 4, 32), np.float32)
            for ks in range(16):
                r = S.ldsm(zw + 4 * (zoff + 16 * ks))
                s = S.ldsm(zw + 4 * (zoff + 8 * ZS + 16 * ks))
                a = np.zeros((3, WARPS, 4, 32), np.uint32)
                for i in range(2):
                    f = lambda reg, m: reg[:, m].view(np.float32)
                    for pc, v in enumerate(split3(f(r, 2 * i),
                                                  f(r, 2 * i + 1), pieces)):
                        a[pc, :, 2 * i] = v
                    for pc, v in enumerate(split3(f(s, 2 * i),
                                                  f(s, 2 * i + 1), pieces)):
                        a[pc, :, 2 * i + 1] = v
                bs = [S.ldsm(wp + 2 * (ks * 16 * CS + 16 * pp), trans=True)
                      for pp in range(2)]
                for pc in (2, 1, 0):
                    for pp in range(2):
                        for u in range(2):
                            dxc[2 * pp + u] = mma(
                                dxc[2 * pp + u], a[pc], bs[pp][:, 2 * u],
                                bs[pp][:, 2 * u + 1])
            # Epilogue: dx rounded to bf16, staged in the warp's part of the
            # dx tile, stored for rows < n and columns < c_in.
            for t in range(4):
                for hh in range(2):
                    off = S.dxs + 2 * ((pr0 + G_ + 8 * hh) * CS + 8 * t +
                                       2 * Q_)
                    word = pack(dxc[t, :, 2 * hh], dxc[t, :, 2 * hh + 1])
                    S.put16(off, (word & 0xffff).astype(np.uint16))
                    S.put16(off + 2, (word >> 16).astype(np.uint16))
            dx[row0:row0 + nr] = from_bf16(S.get16(
                S.dxs + 2 * (np.arange(nr)[:, None] * CS + np.arange(c_in))))

        # The block's slot: dW1 [c][j], dW2 [j][c], db1, db2 (zeros for a
        # block with no tile: its sums stayed 0).
        slot = slots[blk]
        o2, ob1 = c_in * c_mid, c_in * c_mid + c_mid * c_dec
        ob2 = ob1 + c_mid
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
                j = J0 + 16 * mt + G_ + 8 * hh + 0 * W_
                ok = (Q_ == 0) & (j < c_mid)
                slot[(ob1 + j)[ok]] = v[ok]
        db2w = shfl_sum(db2a, (1, 2))                      # [4, W, 32]
        for ct in range(4):
            for q0 in np.flatnonzero(Q_ == 0):
                S.put32(S.red + 4 * (W_[:, 0] * 32 + 8 * ct + G_[q0]),
                        db2w[ct, :, q0])
        s2 = np.zeros(32, np.float32)
        for w in range(WARPS):
            s2 += S.get32(S.red + 4 * (w * 32 + np.arange(32)))
        slot[ob2:] = s2[:c_dec]

    total = np.zeros(slot_len, np.float32)
    for gi in range(blocks):              # the reduce: the launched slots
        total += slots[gi]
    o2, ob1 = c_in * c_mid, c_in * c_mid + c_mid * c_dec
    return (dx, total[:o2].reshape(c_in, c_mid), total[ob1:ob1 + c_mid],
            total[o2:ob1].reshape(c_mid, c_dec), total[ob1 + c_mid:],
            dz_words, slots)


def case(n, c, cmid, cdec, seed):
    """bf16 dyadic inputs and their float32 arrays for the twin."""
    args = wide_bwd_inputs(n, c, cmid, cdec, seed=seed, dtype=torch.bfloat16)
    feed = tuple(t.float().numpy() for t in args)
    return args, feed


def max_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


SHAPES = [(201, 32, 256, 25, 1), (105, 32, 256, 25, H100_SLOTS),
          (150, 7, 100, 12, 2), (90, 32, 256, 32, 1), (1, 32, 256, 25, 1)]
IDS = ["flagship_widths_2tiles_ragged", "flagship_105rows_g264",
       "c7_cmid100_plain_copies", "cdec32", "one_row"]


@pytest.mark.parametrize(
    "n,c,cmid,cdec,groups,resident",
    [s + (H100_SMS,) for s in SHAPES] + [(300, 8, 64, 7, 4, 2)],
    ids=IDS + ["300rows_g4_2blocks"])
def test_twin_matches_wide_bwd_plain(n, c, cmid, cdec, groups, resident):
    """The flagship's widths over two tiles (a ragged second) in one block
    (both x and dy buffers), 105 rows in 264 slots (132 blocks launched;
    slots 1-131 zero, 132-263 never written), 7/100/12 over two tiles in
    two blocks (x by plain copies, four warps' channels past c_mid), c_dec
    = 32 (64-byte dy rows), one row, and 300 rows in 4 slots with 2 blocks
    resident (block 0 takes tiles 0 and 2, slots 2 and 3 never written)."""
    args, feed = case(n, c, cmid, cdec, seed=n + cmid)
    dx, dw1, db1, dw2, db2, dzw, slots = twin(*feed, groups,
                                              resident=resident)
    want = wb.wide_bwd_plain(*args)
    # dz as plain computes it, word for word (float32, not rounded).
    xf, w1f, b1f, w2f, dyf = (torch.from_numpy(a) for a in feed)
    z = xf @ w1f + b1f
    dz = torch.where(z > 0, dyf @ w2f.t(), 0.0)
    np.testing.assert_array_equal(dzw, dz.numpy())
    np.testing.assert_array_equal(dx, want[0].float().numpy())
    for name, got, ref in zip(NAMES[1:], (dw1, db1, dw2, db2), want[1:]):
        assert got.shape == tuple(ref.shape), name
        assert max_rel(got, ref.numpy()) < SUM_TOL, (name,
                                                     max_rel(got, ref))
    # Launched blocks past the tiles hold zeros; the slots of blocks not
    # launched are never written (NaN), and the reduce reads them not.
    blocks, tiles = min(groups, resident), -(-n // ROWS)
    assert (slots[min(tiles, blocks):blocks] == 0).all()
    assert np.isnan(slots[blocks:]).all()


@pytest.mark.parametrize("n,c,cmid,cdec,groups", [SHAPES[0], SHAPES[2]],
                         ids=[IDS[0], IDS[2]])
def test_twin_matches_jax_pallas_bwd(n, c, cmid, cdec, groups, monkeypatch):
    """The twin against the JAX package's Pallas _bwd in interpret mode at
    bf16 (weights in bf16, b1 float32, as _vjp_bwd passes them): dx 8e-3
    and the gradients 1e-4 of max|ref|."""
    monkeypatch.setattr(pwb, "INTERPRET", True)
    args, feed = case(n, c, cmid, cdec, seed=n + cmid + 1)
    x, w1, b1, w2, dy = (jnp.asarray(a, jnp.bfloat16) for a in feed)
    ref = pwb._bwd(x, w1, b1.astype(jnp.float32), w2, dy, interpret=True)
    got = twin(*feed, groups)
    for name, a, r, tol in zip(NAMES, got, ref, (8e-3,) + (1e-4,) * 4):
        r = np.asarray(r, np.float32)
        assert a.shape == r.shape, name
        assert max_rel(a, r) < tol, (name, max_rel(a, r))


def test_dz_and_h_rounded_once_to_bf16_are_wrong():
    """One piece (dz and h rounded to bf16 once, as seg_bwd_bf16_kernel
    takes them) moves the weight gradients beyond 1e-4 of max|ref|."""
    args, feed = case(201, 32, 256, 25, seed=3)
    want = wb.wide_bwd_plain(*args)
    one = twin(*feed, 1, pieces=1)
    assert max(max_rel(one[i], want[i].numpy()) for i in (1, 3)) > 1e-4


def test_a_float32_value_needs_the_third_piece():
    """The dyadic dz and h carry at most 16 significant bits, which hi and
    mid hold; 1 + 2**-8 + 2**-23 rounds up to hi = 1 + 2**-7, leaves mid =
    -2**-8 and needs lo = 2**-23."""
    v = np.array([1 + 2.0 ** -8 + 2.0 ** -23, -(1 + 2.0 ** -8 + 2.0 ** -23)],
                 np.float32)
    hi, mid, lo = (np.concatenate(unpack(p)) for p in split3(v[:1], v[1:]))
    assert (np.float64(hi) + mid != v).all()
    assert (np.float64(hi) + mid + lo == v).all()
    np.testing.assert_array_equal(np.abs(lo), 2.0 ** -23)


def test_nan_in_the_pad_columns_is_wrong():
    """x's pad columns c_in .. 31 (c_in = 7) left unzeroed: the fragments
    read them against W1's zero rows and 0 x NaN is NaN, so every z is NaN,
    no row passes the relu, and dx and the gradients of z come out 0."""
    args, feed = case(80, 7, 100, 12, seed=4)
    want = wb.wide_bwd_plain(*args)
    got = twin(*feed, 1, zero_pad=False)
    for i in range(4):   # dx, dw1, db1, dw2
        assert (got[i] == 0).all() and (want[i] != 0).any(), NAMES[i]


def test_phase_c_without_the_k_permutation_is_wrong():
    """W1^T's B rows read in plain order, not the A fragment's (permuted) k
    order, pair dz with the wrong weights: dx far beyond the bf16
    tolerance."""
    args, feed = case(201, 32, 256, 25, seed=5)
    dx = twin(*feed, 1, perm_w1=False)[0]
    assert max_rel(dx, wb.wide_bwd_plain(*args)[0].float().numpy()) > 0.1


F32_BIG = float(np.float32(3e38))   # below bf16's largest finite value


@settings(max_examples=200, deadline=None)
@given(st.floats(-F32_BIG, F32_BIG, width=32),
       st.floats(-F32_BIG, F32_BIG, width=32))
def test_three_pieces_hold_a_float32_value(v0, v1):
    """hi + mid + lo reproduces a float32 value to 2**-24 of |v| (each
    difference is exact, the last piece holds the last 8 bits), exactly
    wherever the pieces stay normal."""
    v = np.array([v0, v1], np.float32)
    hi, mid, lo = (np.concatenate(unpack(p)) for p in split3(v[:1], v[1:]))
    s = np.float64(hi) + mid + lo
    assert (np.abs(s - v) <= 2.0 ** -24 * np.abs(v) + 2.0 ** -133).all()
    big = np.abs(v) >= 2.0 ** -100
    assert (s[big] == v[big]).all()


def test_three_pieces_hold_dyadic_values_exactly():
    """On the dyadic grids of dz (2**-9) and of relu(z) (2**-10) every
    value is the sum of its three pieces."""
    r = np.random.default_rng(0)
    v = np.concatenate([grid(r, 4096, 2 ** 15, 9), grid(r, 4096, 2 ** 14, 10)])
    pieces = [np.concatenate(unpack(p)) for p in split3(v[0::2], v[1::2])]
    both = np.concatenate([v[0::2], v[1::2]])
    assert (np.float64(pieces[0]) + pieces[1] + pieces[2] == both).all()


def wide_bwd_bf16_smem(rows=ROWS, buffers=1):
    """blk_bwd.cu's wide_bwd_bf16_smem at `rows` rows a tile and `buffers`
    dz buffers (the shipped layout has one; the 64-row variant of
    tools/seg_bwd_variants.py two): the dz buffers and the db2 sums
    (float32), W1, two each of the x and dy tiles, the dx tile and the
    warps' raw dy spans (bf16)."""
    rpw = rows // WARPS
    raww = (rpw * 64 + 43) // 16 * 8
    return 4 * (buffers * rows * ZS + WARPS * 32) + \
        2 * (256 * CS + 5 * rows * CS + WARPS * raww)


def test_layout_fits_and_fragment_accesses_are_conflict_free():
    """128-row tiles with one dz buffer take 214,272 of a block's 232,448
    bytes (one block an SM), 64 rows with two 184,576, 128 with two do
    not fit.  The dz row stride (260 words, 4 mod 32) puts the 8 rows of
    every float32 ldmatrix and the 32 lanes of every dz word store in
    distinct banks; W1's rows in the permuted k order and the tiles' rows
    (20 words) too; a warp's raw span holds its 16 rows of 32 channels from
    any 16-byte skew; dW1's slot staging (8,192 floats) and W2 (bf16 [256]
    [40]) fit the dz space."""
    assert wide_bwd_bf16_smem() == 214_272 <= SMEM_OPTIN
    assert wide_bwd_bf16_smem(64, 2) == 184_576 <= SMEM_OPTIN
    assert wide_bwd_bf16_smem(128, 2) > SMEM_OPTIN
    # Phase C's A rows: 8 rows of 4 words at stride ZS.
    banks = (np.arange(8)[:, None] * ZS + np.arange(4)) % 32
    assert len(set(banks.ravel())) == 32
    # The dz stores of a C tile: lane (g, q) at word (2q + e) ZS + g.
    for e in (0, 1):
        assert len(set(((2 * Q_ + e) * ZS + G_) % 32)) == 32
    # ldmatrix rows of 8 bf16 (4 words) at stride CS / 2 words: tiles and
    # W1 in plain and permuted row order.
    for rows in (np.arange(8), 4 * (np.arange(8) % 2) + np.arange(8) // 2):
        banks = (rows[:, None] * CS // 2 + np.arange(4)) % 32
        assert len(set(banks.ravel())) == 32
    assert 8 * -(-(7 + RPW * 32) // 8) <= RAWW
    assert 4 * ROWS * ZS >= max(4 * 256 * 32, 2 * 256 * CS)


def test_wide_variants_tool_applies_to_the_kernel_source():
    """tools/seg_bwd_variants.py --section wide builds its variants by
    substitution in wide_bwd_bf16_kernel's section of blk_bwd.cu: every
    substitution still finds its text, and each variant gets its own copy
    of the kernel and a launch case."""
    from probav_tpu_torch.tools import seg_bwd_variants as sv
    names = list(sv.WIDE_VARIANTS)
    src = sv.source(names, "wide")
    assert src.count("wide_bwd_bf16_kernel(const __nv_bfloat16* __restrict__"
                     " x") == len(names)
    for i in range(len(names)):
        assert f"if (v == {i}) return v{i}::launch_wide_bwd_bf16(" in src
    for name, beside in (("rows64", True), ("rows64_after", False)):
        rows64 = sv.source([name], "wide")
        assert "constexpr int WBB_ROWS = 64;" in rows64
        assert "const int ct0 = CTW * (warp / RG);" in rows64
        assert ("(size_t)2 * WBB_ROWS * WBB_ZS" in rows64) == beside
        assert ("if (prev >= 0) epilogue(prev);" in rows64) == beside
        assert ("phase_c(zb + (buf ^ 1) * ROWS * ZS, rg * KPG, KPG);\n"
                "#pragma unroll\n      for (int mt" in rows64) == beside
        assert "phase_c(kp)" not in rows64
    split1 = sv.source(["split1"], "wide")
    assert split1.count("for (int pc = 0;") == 2 and "pc = 2;" not in split1
    assert "fake_mma(" in sv.source(["no_mma"], "wide")
    assert "phase_c(kp)" not in sv.source(["no_phase_c"], "wide")
    assert "const int G1 = G;" in sv.source(["g_blocks"], "wide")
    assert "struct Slot" in src and "seg_bwd_bf16_kernel" not in src
