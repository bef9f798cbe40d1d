"""The addressing and schedule of the float32 tensor-core seg_bwd of
``blk_bwd`` beyond the flagship's widths, in numpy.

``seg_bwd_tf32_split_kernel`` and ``dx_sum_kernel<float>``
(probav_tpu_torch/csrc/blk_bwd.cu) compute the expand/decay backward of a block (dx = W1 dz
+ gy, dW1, db1, dW2, db2, dbc) at c_in, c_dec <= 64 and c_mid <= 512 as
3xTF32 on mma.sync m16n8k8 (fragment layouts in common.cuh, mma_tf32):

- C_mid is cut into chunks of JC = 128 middle channels j.  Block b of the
  G x chunks takes chunk b % chunks of the 64-row tiles of slot b / chunks
  (tiles s, s + G, ...), and writes its chunk's columns of dW1, rows of
  dW2 and entries of db1 into that slot, db2 from the chunk-0 block;
- shared memory, in floats: the chunk's W1^T and W2 as A-fragment words
  (word i of lane (g, q), warp w, k-step k at ((w KS + k) 32 + lane) 4 +
  i: j = 16 w + g + 8 (i & 1), c = 8 k + q + 4 (i >> 1)), W1^T as B words
  for phase C (word u of lane (g, q), j-step s, c-tile t at ((8 s + t) 32
  + lane) 2 + u: c = 8 t + g, j = 8 s + q + 4 u), b1, two each of the x
  and dd tiles [64][68] (zeros past n and from c_in, c_dec), dz^T
  [128][72], the db2 sums;
- warp w owns j = 16 w .. 16 w + 15: per pass of 32 rows and k-step, the
  A words of W1^T and W2 (one float4 each) and the B words of x^T and
  dd^T (x[row 8 nt + g][c 8 k + q], [+ 4]) split into TF32 halves, z^T and
  W2 dd^T as C tiles (j g, g + 8 by rows 2q, 2q + 1); dz = W2 dd where z +
  b1 > 0 and h = relu(z + b1), whose C words (c0, c2, c1, c3) are the A
  words of dW1^T += dz^T x and dW2 += h^T dd, B = x, dd at rows 2q, 2q + 1
  (the k order of a dot product is free); dz^T to shared memory as float2;
  each tile's weight-gradient products in fresh sums, added to the running
  sums;
- phase C, after a barrier: warp w computes rows 16 (w % 4) .. + 15 by
  channels 32 (w / 4) .. + 31 of the chunk's part of dx over its 128 j (A
  from dz^T, B from the phase-C plane, one float2 a lane), stored as
  float32 into dxp[chunk][row][ldp] (ldp = c_in rounded up to 8);
- dx_sum_kernel<float>: block b of G sums rows [b per, (b + 1) per): dx =
  (part_0 + part_1 + ...) + gy in float32, thread t the four channels
  4 (t % 16) .. of rows t / 16 + 16 k, and dbc: each thread's gy sums in
  row order, then the 16 row lanes in order, into slot b.

The twin models shared memory as one flat array with the kernel's offsets
(NaN where nothing was written: a read of an unwritten word shows), gathers
every fragment word by lane from it, splits it as common.cuh's split_tf32
(``test_torch_tf32_split.py``) and runs each mma term from the lanes'
registers, exact in float64 and rounded to float32 per mma (the tensor
cores' truncating sums are not emulated).  It is held to ``blk_bwd_plain``
on the dyadic inputs of ``tools/dyadic.py`` at the float32 tolerances of
``tests/test_torch_kernels.py`` (dx 2e-5, the gradients 1e-4 of max|ref|),
and to the JAX package's Pallas ``blk_bwd`` in interpret mode at float32;
a twin without the C -> A permutation, or with one TF32 product instead of
three (dd is on a 2**-10 grid, not TF32's), is not.  The kernels run only
on the card; this pins what they address.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probav_tpu.ops import pallas_tstack as jts
from probav_tpu_torch.ops import _build
from probav_tpu_torch.ops import tstack as ts
from test_torch_kernels import BWD_NAMES, blk_bwd_tolerances
from test_torch_seg_bwd_mma_layout import plain_dd
from test_torch_tf32_split import split_tf32, tf32_read

torch.set_num_threads(1)

ROWS, WARPS, PASS, JC, CH = 64, 8, 4, 128, 64   # blk_bwd.cu's STS_*
XS, ZS = CH + 4, ROWS + 8
KS = CH // 8                                    # k-steps over the channels
PLANE = JC * CH                                 # floats of a weight plane
DXS = 256                                       # dx_sum_kernel's threads
H100_SLOTS = 264
OPTIN = 232_448
LANE = np.arange(32)
G_, Q_ = LANE // 4, LANE % 4
W_ = np.arange(WARPS)[:, None]
F32 = np.float32


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
    """common.cuh's mma_term: c += term 0 (hi hi), 1 (lo hi) or 2 (hi lo)
    of a b, the product exact in float64, rounded into the float32
    registers."""
    pa, pb = ((a[0], b[0]), (a[1], b[0]), (a[0], b[1]))[term]
    return c_regs(c_mat(c) + a_mat(pa) @ b_mat(pb)).astype(F32)


def shfl_sum(v, masks):
    """v += __shfl_xor_sync(v, m) for each m in order, over the lanes."""
    for m in masks:
        v = (v + v[..., LANE ^ m]).astype(F32)
    return v


class Smem:
    """seg_bwd_tf32_split_kernel's shared memory in floats, NaN where
    nothing was written."""

    def __init__(self):
        self.wa1 = 0                            # [W][KS][32][4]
        self.wa2 = PLANE                        # [W][KS][32][4]
        self.wb1 = 2 * PLANE                    # [JC/8][8][32][2]
        self.b1s = 3 * PLANE                    # [JC]
        self.xb = self.b1s + JC                 # [2][ROWS][XS]
        self.db = self.xb + 2 * ROWS * XS       # [2][ROWS][XS]
        self.zt = self.db + 2 * ROWS * XS       # [JC][ZS]
        self.red = self.zt + JC * ZS            # [W][64]
        self.m = np.full(self.red + WARPS * CH, np.nan, F32)

    def read(self, addr):
        """Words at addr (any shape); every one must have been written."""
        v = self.m[addr]
        assert not np.isnan(v).any(), "a word read before it was written"
        return v


def split_plan(c_in, c_mid):
    """(chunks, ldp) as seg_bwd_tf32_split_chunks and seg_bwd_split_ldp
    give them."""
    return -(-c_mid // JC), -(-c_in // 8) * 8


def stage_weights(S, w1, b1, w2, j0):
    """The chunk's three planes and b1, by the kernel's word maps."""
    c_in, c_mid = w1.shape
    c_dec = w2.shape[1]
    w1p = np.zeros((CH, JC), F32)   # [c][j] of the chunk, zero-padded
    jn = max(0, min(JC, c_mid - j0))
    w1p[:c_in, :jn] = w1[:, j0:j0 + jn]
    w2p = np.zeros((JC, CH), F32)   # [j][c]
    w2p[:jn, :c_dec] = w2[j0:j0 + jn]
    e = np.arange(PLANE)
    i, ln, k, w = e % 4, (e // 4) % 32, (e // 128) % KS, e // 128 // KS
    j, c = 16 * w + ln // 4 + 8 * (i & 1), 8 * k + ln % 4 + 4 * (i >> 1)
    S.m[S.wa1 + e] = w1p[c, j]
    S.m[S.wa2 + e] = w2p[j, c]
    u, lb, t, s = e % 2, (e // 2) % 32, (e // 64) % 8, e // 512
    S.m[S.wb1 + e] = w1p[8 * t + lb // 4, 8 * s + lb % 4 + 4 * u]
    b1p = np.zeros(JC, F32)
    b1p[:jn] = b1[j0:j0 + jn]
    S.m[S.b1s:S.b1s + JC] = b1p


def stage_tile(S, base, rows, nr, cols):
    """copy_rows: rows [0, nr) of a [*, cols] tile at base (row stride XS),
    zeros for rows from nr on; the columns from cols on keep their zeros."""
    t = np.zeros((ROWS, cols), F32)
    t[:nr] = rows
    S.m[base + np.arange(ROWS)[:, None] * XS + np.arange(cols)] = t


def split_block(S, blk, x, dd, w1, b1, w2, groups, dxp, slots, permute=True,
                terms=3):
    """One block of seg_bwd_tf32_split_kernel: its tiles' products and
    phase C into dxp, its part of its slot into slots."""
    n, c_in = x.shape
    c_mid, c_dec = w2.shape
    chunks, ldp = split_plan(c_in, c_mid)
    chunk, slot_i = blk % chunks, blk // chunks
    j0 = chunk * JC
    J0 = 16 * W_
    tiles = -(-n // ROWS)
    stage_weights(S, w1, b1, w2, j0)
    S.m[S.xb:S.zt] = 0.0                        # the tiles, zeroed once
    bias0, bias1 = S.read(S.b1s + J0 + G_), S.read(S.b1s + J0 + G_ + 8)
    zero = lambda *s: np.zeros(s + (WARPS, 32), F32)
    acc1, acc2 = zero(8, 4), zero(8, 4)
    db1a, db2a = zero(2), zero(8)
    pr0, ct0 = 16 * (W_ % 4), 4 * (W_ // 4)    # phase C's rows, c-tiles
    for k_, tile in enumerate(range(slot_i, tiles, groups)):
        buf = k_ % 2
        xt, dt = S.xb + buf * ROWS * XS, S.db + buf * ROWS * XS
        row0, nr = tile * ROWS, min(ROWS, n - tile * ROWS)
        stage_tile(S, xt, x[row0:row0 + nr], nr, c_in)
        stage_tile(S, dt, dd[row0:row0 + nr], nr, c_dec)
        S.m[S.zt:S.red] = np.nan                # dz^T: this tile's alone
        f1, f2 = zero(8, 4), zero(8, 4)
        for r0 in range(0, ROWS, 8 * PASS):
            z, gg = zero(PASS, 4), zero(PASS, 4)
            for k in range(KS):
                wa = lambda base: S.read(base + ((W_ * KS + k) * 32 + LANE) *
                                         4 + np.arange(4)[:, None, None])
                a1, a2 = frag(*wa(S.wa1)), frag(*wa(S.wa2))
                o = [(r0 + 8 * nt + G_) * XS + 8 * k + Q_
                     for nt in range(PASS)]
                bx = [frag(S.read(xt + a), S.read(xt + a + 4)) for a in o]
                bd = [frag(S.read(dt + a), S.read(dt + a + 4)) for a in o]
                for term in range(terms):
                    for nt in range(PASS):
                        z[nt] = mma_term(z[nt], a1, bx[nt], term)
                        gg[nt] = mma_term(gg[nt], a2, bd[nt], term)
            for nt in range(PASS):
                rb = r0 + 8 * nt
                zz = [(z[nt][i] + (bias0 if i < 2 else bias1)).astype(F32)
                      for i in range(4)]
                dz = [np.where(zz[i] > 0, gg[nt][i], F32(0)) for i in range(4)]
                h = [np.fmax(zz[i], F32(0)) for i in range(4)]
                db1a[0] = (db1a[0] + (dz[0] + dz[1]).astype(F32)).astype(F32)
                db1a[1] = (db1a[1] + (dz[2] + dz[3]).astype(F32)).astype(F32)
                for hh in range(2):                   # float2 stores
                    at = S.zt + (J0 + G_ + 8 * hh) * ZS + rb + 2 * Q_
                    S.m[at], S.m[at + 1] = dz[2 * hh], dz[2 * hh + 1]
                order = (0, 2, 1, 3) if permute else (0, 1, 2, 3)
                az = frag(*(dz[i] for i in order))
                ah = frag(*(h[i] for i in order))
                on = rb == 8 * W_                      # db2: row group w
                for ct in range(8):
                    o = (rb + 2 * Q_) * XS + 8 * ct + G_
                    bx = frag(S.read(xt + o), S.read(xt + o + XS))
                    dv = (S.read(dt + o), S.read(dt + o + XS))
                    bd = frag(*dv)
                    db2a[ct] = np.where(on, (db2a[ct] + (dv[0] + dv[1])
                                             .astype(F32)).astype(F32),
                                        db2a[ct])
                    for term in range(terms):
                        f1[ct] = mma_term(f1[ct], az, bx, term)
                        f2[ct] = mma_term(f2[ct], ah, bd, term)
        acc1 = (acc1 + f1).astype(F32)
        acc2 = (acc2 + f2).astype(F32)

        # Phase C: warp w's rows and c-tiles over the chunk's 128 j.
        dxc = zero(4, 4)
        for s in range(JC // 8):
            za = S.zt + (8 * s + Q_) * ZS + pr0 + G_
            a = frag(S.read(za), S.read(za + 8), S.read(za + 4 * ZS),
                     S.read(za + 4 * ZS + 8))
            for t in range(4):
                wb = S.wb1 + ((8 * s + ct0 + t) * 32 + LANE) * 2
                b = frag(S.read(wb), S.read(wb + 1))
                for term in range(terms):
                    dxc[t] = mma_term(dxc[t], a, b, term)
        for hh in range(2):
            row = row0 + pr0 + G_ + 8 * hh                     # [W, 32]
            for t in range(4):
                c = 8 * (ct0 + t) + 2 * Q_ + 0 * row
                ok = (row < n) & (c < ldp)
                for u in range(2):
                    dxp[chunk, row[ok], c[ok] + u] = dxc[t][2 * hh + u][ok]

    # The block's part of its slot (no dWc): dW1 [c][j0..], dW2 [j0..][c],
    # db1 [j0..], db2 from the chunk-0 block.
    slot = slots[slot_i]
    o2, ob1 = c_in * c_mid, c_in * c_mid + c_mid * c_dec
    ob2 = ob1 + c_mid
    for ct in range(8):
        for i in range(4):
            j = j0 + J0 + G_ + 8 * (i // 2)                     # [W, 32]
            c = 8 * ct + 2 * Q_ + (i & 1) + 0 * j
            for at, ok, v in ((c * c_mid + j, c < c_in, acc1),
                              (o2 + j * c_dec + c, c < c_dec, acc2)):
                ok = ok & (j < c_mid)
                assert np.isnan(slot[at[ok]]).all(), "written twice"
                slot[at[ok]] = v[ct, i][ok]
    for hh in range(2):
        v = shfl_sum(db1a[hh], (1, 2))
        j = j0 + J0 + G_ + 8 * hh
        ok = (Q_ == 0) & (j < c_mid)
        slot[(ob1 + j)[ok]] = v[ok]
    if chunk == 0:
        db2w = shfl_sum(db2a, (1, 2))                      # [8, W, 32]
        red = np.zeros((WARPS, CH), F32)
        for ct in range(8):
            for q0 in np.flatnonzero(Q_ == 0):
                red[:, 8 * ct + G_[q0]] = db2w[ct, :, q0]
        s2 = np.zeros(CH, F32)
        for w in range(WARPS):
            s2 = (s2 + red[w]).astype(F32)
        slot[ob2:ob2 + c_dec] = s2[:c_dec]


def dx_sum(dxp, gy, groups, slots):
    """dx_sum_kernel<float>: dx rows and each block's dbc into its slot."""
    n, c_in = gy.shape
    dx = np.full((n, c_in), np.nan, F32)
    per = -(-n // groups)
    obc = slots.shape[1] - c_in
    for b in range(groups):
        r0, r1 = min(n, b * per), min(n, b * per + per)
        v = np.zeros((r1 - r0, c_in), F32)
        for k in range(dxp.shape[0]):          # the chunks in order
            v = (v + dxp[k, r0:r1, :c_in]).astype(F32)
        g = gy[r0:r1]
        dx[r0:r1] = (v + g).astype(F32)
        red = np.zeros((DXS // 16, c_in), F32)
        for rl in range(DXS // 16):            # each lane's rows in order
            rows = g[rl::DXS // 16]
            if len(rows):
                red[rl] = np.cumsum(rows, 0, dtype=F32)[-1]
        slots[b, obc:] = np.cumsum(red, 0, dtype=F32)[-1]
    return dx


def twin(x, dd, gy, w1, b1, w2, groups, **kw):
    """(dx, dw1, db1, dw2, db2, dbc, slots) as the two kernels address and
    sum them, and the reduce (the slots in order)."""
    n, c_in = x.shape
    c_mid, c_dec = w2.shape
    chunks, ldp = split_plan(c_in, c_mid)
    slot_len = c_in * c_mid + c_mid * c_dec + c_mid + c_dec + c_in
    slots = np.full((groups, slot_len), np.nan, F32)
    dxp = np.full((chunks, n, ldp), np.nan, F32)
    for blk in range(groups * chunks):
        split_block(Smem(), blk, x, dd, w1, b1, w2, groups, dxp, slots, **kw)
    assert not np.isnan(dxp[:, :, :c_in]).any(), "a part of dx unwritten"
    dx = dx_sum(dxp, gy, groups, slots)
    assert not np.isnan(slots).any(), "a slot entry unwritten"
    total = np.zeros(slot_len, F32)
    for g in range(groups):
        total = (total + slots[g]).astype(F32)
    o2, ob1 = c_in * c_mid, c_in * c_mid + c_mid * c_dec
    return (dx, total[:o2].reshape(c_in, c_mid), total[ob1:ob1 + c_mid],
            total[o2:ob1].reshape(c_mid, c_dec),
            total[ob1 + c_mid:ob1 + c_mid + c_dec],
            total[ob1 + c_mid + c_dec:], slots)


def case(shape, c, cmid, cdec, seed):
    """float32 dyadic inputs, the twin's rows (dd from the plain conv
    transpose) and the plain reference's arguments."""
    from probav_tpu_torch.tools.dyadic import blk_bwd_inputs
    args = blk_bwd_inputs(shape, c, cmid, cdec, seed=seed)
    gy, x, d, w1, b1, w2, wc = args
    rows = lambda t, k: t.float().reshape(-1, k).numpy()
    feed = (rows(x, c), rows(plain_dd(gy, wc), cdec), rows(gy, c),
            w1.numpy(), b1.numpy(), w2.numpy())
    return args, feed


def max_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def check(got, want):
    """The float32 tolerances, dx and the weight gradients in order."""
    tol = blk_bwd_tolerances(torch.float32)
    names = ("dx",) + BWD_NAMES[2:]
    want = (want[0],) + tuple(want[2:])
    for name, a, r in zip(names, got, want):
        r = np.asarray(r, F32).reshape(a.shape)
        assert max_rel(a, r) < tol[name], (name, max_rel(a, r))


SHAPES = [((1, 2, 11, 9), 64, 512, 51, 2),
          ((1, 2, 11, 9), 48, 384, 38, 3),
          ((1, 1, 7, 9), 64, 512, 51, H100_SLOTS)]
IDS = ["c64_cmid512_198rows_g2", "c48_cmid384_198rows_g3",
       "c64_63rows_g264"]


@pytest.mark.parametrize("shape,c,cmid,cdec,groups", SHAPES, ids=IDS)
def test_tf32_split_twin_matches_blk_bwd_plain(shape, c, cmid, cdec, groups):
    """The 64-filter widths over four tiles (a partial last) in two slots
    (each slot's four chunks), the 48-filter widths (three chunks) in three
    slots, and 63 rows (less than a tile) in 264 slots: every slot past the
    first zero in its weight gradients, dbc's rows cut per block."""
    args, feed = case(shape, c, cmid, cdec, seed=sum(shape) + cmid)
    got = twin(*feed, groups)
    check(got[:6], ts.blk_bwd_plain(*args))
    tiles = -(-feed[0].shape[0] // ROWS)
    if groups > tiles:   # slots past the tiles hold zeros (dbc: past rows)
        assert (got[6][tiles:, :-c] == 0).all()


def jax_pallas_blk_bwd_f32(args, monkeypatch):
    """(dx, dwc, dw1, db1, dw2, db2, dbc) of the JAX package's Pallas
    blk_bwd in interpret mode at float32, on the block's [C, ext]
    layout."""
    monkeypatch.setattr(jts, "INTERPRET", True)
    gy, x, d, w1, b1, w2, wc = (jnp.asarray(t.numpy(), jnp.float32)
                                for t in args)
    b, h, w, t, c = x.shape
    s = h * (w + 2) * (t + 2)   # one grid step: interpret mode runs fast
    g = jts.make_geom(h, w, t, b, target_rows=s, target_ch=s, itemsize=4,
                      width=c)
    im = jts.interior_mask(g, jnp.float32)
    out = jts.blk_bwd(g, jts.to_t(gy, g) * im, jts.to_t(d, g),
                      jts.to_t(x, g), wc, w1, b1, w2, im)
    return (np.asarray(jts.from_t(out[0], g, b, h, w, t), np.float32),) + \
        tuple(np.asarray(o, np.float32) for o in out[1:])


def test_tf32_split_twin_matches_jax_pallas_blk_bwd(monkeypatch):
    """The 64-filter widths at float32, on 15 rows (interpret mode takes
    ~7x as long on a tile of 198), against the JAX package's Pallas
    kernel."""
    args, feed = case((1, 1, 5, 3), 64, 512, 51, seed=6)
    check(twin(*feed, 2)[:6], jax_pallas_blk_bwd_f32(args, monkeypatch))


@pytest.mark.parametrize("kw,name", [(dict(permute=False), "dw1"),
                                     (dict(terms=1), "dx")],
                         ids=["no_k_permutation", "one_tf32_product"])
def test_tf32_split_twin_variants_are_wrong(kw, name):
    """dz's C words fed to the weight-gradient products in their own order
    pair dz with the wrong rows of x (dW1 far off); one TF32 product (hi
    hi) drops dd's low bits, which TF32 does not hold: dx beyond 2e-5."""
    args, feed = case((1, 1, 7, 9), 64, 256, 51, seed=4)
    got = twin(*feed, 1, **kw)
    want = ts.blk_bwd_plain(*args)
    i = ("dx",) + BWD_NAMES[2:]
    ref = np.asarray(want[BWD_NAMES.index(name)], F32)
    a = got[i.index(name)]
    assert max_rel(a, ref.reshape(a.shape)) > \
        blk_bwd_tolerances(torch.float32)[name]


def sts_smem():
    """blk_bwd.cu's seg_bwd_tf32_split_smem: three weight planes, b1, two
    each of the x and dd tiles, dz^T, the db2 sums (floats)."""
    return 4 * (3 * PLANE + JC + 4 * ROWS * XS + JC * ZS + WARPS * CH)


def test_tf32_split_mirror_matches_the_source():
    """The constants above are the kernel's."""
    src = (_build.SRC_DIR / "blk_bwd.cu").read_text()
    got = {k: int(v) for k, v in re.findall(
        r"constexpr int STS_(\w+) = (\d+);", src)}
    assert got == dict(WARPS=WARPS, ROWS=ROWS, PASS=PASS, JC=JC, CH=CH)
    for name, want in (("XS", "STS_CH + 4"), ("ZS", "STS_ROWS + 8"),
                       ("PLANE", "STS_JC * STS_CH")):
        assert f"constexpr int STS_{name} = {want};" in src, name
    assert "constexpr int DXS_THREADS = 256;" in src


def test_tf32_split_layout_fits_and_its_loads_are_conflict_free():
    """207,360 of a block's 232,448 bytes at every width it is routed (it
    does not depend on them); every 32-lane fragment load and dz^T store
    falls in distinct banks (a 64-bit access in two half-warp phases);
    dx's parts take 4 x N x 64 floats at 64/512 (3 x N x 48 at 48/384)."""
    assert sts_smem() == 207_360 <= OPTIN
    S = Smem()
    for off in (S.wa1, S.wa2, S.wb1, S.xb, S.db, S.zt):
        assert off % 4 == 0              # 16-byte aligned regions
    banks = lambda a: len(set(np.asarray(a) % 32))
    assert banks(4 * G_ + Q_) == 32                 # x^T, dd^T B words: XS
    assert banks(((2 * Q_) * XS + G_)) == 32        # x, dd at rows 2q
    assert banks((8 * 3 + Q_) * ZS + G_) == 32       # phase C's A words
    for half in (LANE < 16, LANE >= 16):             # float2 dz^T stores
        a = (G_ * ZS + 2 * Q_)[half]
        assert len(set(np.concatenate([a, a + 1]) % 32)) == 32
    assert split_plan(64, 512) == (4, 64) and split_plan(48, 384) == (3, 48)
    assert split_plan(33, 256) == (2, 40) and split_plan(36, 300) == (3, 40)


def test_tf32_split_variants_tool_applies_to_the_kernel_source():
    """tools/seg_bwd_variants.py --section tf32_split builds its variants
    by substitution in the float32 split section of blk_bwd.cu: every
    substitution still finds its text, each variant gets its own copy of
    the kernel and a launch case, and the cluster variant launches one
    cluster a slot with no dx_sum_kernel.  Its prelude holds the pieces of
    the bf16 split section the float32 one calls."""
    from probav_tpu_torch.tools import seg_bwd_variants as sv
    names = list(sv.TF32_SPLIT_VARIANTS)
    src = sv.source(names, "tf32_split")
    assert src.count("\nseg_bwd_tf32_split_kernel(const float* __restrict__ "
                     "x,") == len(names)
    for i in range(len(names)):
        assert f"if (v == {i}) return v{i}::launch_seg_bwd_tf32_split(" in src
    cluster = sv.source(["cluster"], "tf32_split")
    assert "cudaLaunchAttributeClusterDimension" in cluster
    assert "cluster.map_shared_rank(dxs, k)" in cluster
    assert "return launch_dx_sum(" not in cluster
    assert "return cudaSuccess;" in sv.source(["no_dx_sum"], "tf32_split")
    assert "constexpr int STS_PASS = 2;" in sv.source(["pass2"], "tf32_split")
    assert "fake_mma_tf32(" in sv.source(["no_mma"], "tf32_split")
    for piece in ("int seg_bwd_split_ldp(int c_in)",
                  "dx_sum_kernel(const float* __restrict__ dxp",
                  "cudaError_t launch_dx_sum(", "constexpr int DXS_THREADS"):
        assert src.count(piece) == 1, piece
