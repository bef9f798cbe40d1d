"""The decomposition of the shift-table kernels (csrc/shift_loss.cu),
emulated on the CPU in float32 numpy: the launch plan (``launch_plan``,
tests/shift_plan.py),
row bands a cluster's block and tiles of a band, the warp units (shift
column, group of shift rows, part) with their lanes' items walked as the
kernel walks them, the lanes' sums met by the butterfly, the parts, tiles
and bands reduced in their fixed order, and phases A (sums of m, hr and
p m), B (sum |r|, r^2 or phi m) and C (d/dp per item, the shifts in shift
order) with the kernel's formulas (fmaf as one rounding).  Held to the
plain twins of ``ops/shift_table.py`` and, at one size, to the JAX
package's Pallas kernels in interpret mode.  The CUDA kernels themselves
run only on the card (tests/test_torch_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probav_tpu.ops import pallas_shift_loss as psl
from probav_tpu_torch.ops import shift_table as st
from probav_tpu_torch.tools.dyadic import shift_table_inputs
from shift_plan import QR, SR, launch_plan

torch.set_num_threads(1)

KC, SJ = 7, 7
F32 = np.float32


def fma(a, b, c):
    """fmaf: the float32 product exact in float64, one rounding."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def times_sign(v, r):
    """v with its sign bit flipped where r's is set (the kernel's v sign(r)
    for r != 0)."""
    v, r = np.broadcast_arrays(np.asarray(v, F32), np.asarray(r, F32))
    bits = v.view(np.uint32) ^ (r.view(np.uint32) & np.uint32(0x80000000))
    return bits.view(F32)


def butterfly(v):
    """warp_sum over the last axis (32 lanes): lane 0's value."""
    v = v.copy()
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(F32)
    return v[..., 0]


def tiles(q, band0, band1, cw):
    ntx = -(-cw // q["CT"])
    nty = -(-(band1 - band0) // q["RT"])
    for t in range(nty * ntx):
        y0 = band0 + (t // ntx) * q["RT"]
        x0 = (t % ntx) * q["CT"]
        yield y0, x0, min(q["RT"], band1 - y0), min(q["CT"], cw - x0)


def sweep(phase, bwd, sq, q, tile, hr, m, pc, n, cst, part):
    """Phase A (0) or B (1) over one tile, the warp units and their lanes
    as a [unit, lane] array, each lane's items walked in the kernel's
    order; adds each unit's sums into part[part][quantity][shift]."""
    y0, x0, rt, ct = tile
    b = (n - 1) // 2
    sh = hr[y0:y0 + rt + 2 * b, x0:x0 + ct + 2 * b]
    sm = m[y0:y0 + rt + 2 * b, x0:x0 + ct + 2 * b]
    nqty = 3 if phase == 0 else 1
    g = -(-n // SR)
    nq = -(-rt // QR)
    step = 32 * q["P"]
    dc, dx = divmod(step, ct)
    unit = np.arange(n * g * q["P"])
    j, i0, pt = unit % n, (unit // n) % g * SR, unit // (n * g)
    ni = np.minimum(SR, n - i0)
    j, i0, ni1 = j[:, None], i0[:, None], ni[:, None]
    acc = np.zeros((nqty, SR, len(unit), 32), F32)
    chunk, xl = divmod(pt[:, None] * 32 + np.arange(32), ct)
    while (chunk < nq).any():
        live = chunk < nq
        yl = chunk * QR
        nqv = np.minimum(QR, rt - yl)
        # Items of 8 rows and 7 shift rows take the totals as sliding
        # sums down their 14 rows.
        full = live & (nqv == QR) & (ni1 == SR)
        if phase == 0 and full.any():
            yy = np.where(full, yl, 0) + i0
            xx = np.where(full, xl, 0) + j
            w = [(sh[yy + k, xx], sm[yy + k, xx]) for k in range(QR + SR - 1)]
            t, h = F32(0), F32(0)
            for r in range(QR):
                t = (t + w[r][1]).astype(F32)
                h = (h + w[r][0]).astype(F32)
            for i in range(SR):
                if i:
                    t = ((t + w[i + QR - 1][1]).astype(F32)
                         - w[i - 1][1]).astype(F32)
                    h = ((h + w[i + QR - 1][0]).astype(F32)
                         - w[i - 1][0]).astype(F32)
                acc[0, i] = np.where(full, acc[0, i] + t, acc[0, i])
                acc[1, i] = np.where(full, acc[1, i] + h, acc[1, i])
        for r in range(QR):
            on_r = live & (r < nqv)
            if not on_r.any():
                continue
            yy = np.where(on_r, yl + r, 0)
            xx = np.where(on_r, xl, 0)
            pv = pc[y0 + yy, x0 + xx]
            for i in range(ni.max()):
                on = on_r & (i < ni1)
                row = np.where(on, yy + i0 + i, 0)
                hv = sh[row, xx + j]
                mv = sm[row, xx + j]
                if phase == 0:
                    part_on = on & ~full
                    new = (np.where(part_on, acc[0, i] + mv, acc[0, i]),
                           np.where(part_on, acc[1, i] + hv, acc[1, i]),
                           fma(pv, mv, acc[2, i]))
                else:
                    s = np.minimum(i0 + i, n - 1) * n + j
                    bias = cst[s, 0]
                    res = fma(-(pv + bias).astype(F32), mv, hv)
                    if bwd and sq:
                        val = fma(res, mv, acc[0, i])
                    elif bwd:
                        val = (acc[0, i] + np.where(
                            res == 0, F32(0), times_sign(mv, res))
                        ).astype(F32)
                    elif sq:
                        val = fma(res, res, acc[0, i])
                    else:
                        val = (acc[0, i] + np.abs(res)).astype(F32)
                    new = (val,)
                for k, v in enumerate(new):
                    acc[k, i] = np.where(on, v, acc[k, i])
        xl = xl + dx
        chunk = chunk + dc
        wrap = xl >= ct
        xl = np.where(wrap, xl - ct, xl)
        chunk = np.where(wrap, chunk + 1, chunk)
    sums = butterfly(acc)
    for u in unit:
        for i in range(ni[u]):
            s = (i0[u, 0] + i) * n + j[u, 0]
            for k in range(nqty):
                part[pt[u], k, s] = F32(part[pt[u], k, s] + sums[k, i, u])


def sweep_dp(sq, q, tile, hr, m, pc, n, cst, dpc):
    """Phase C over one tile: items of one row and KC columns, the window
    of 13 columns a shift row, the shifts in shift order."""
    y0, x0, rt, ct = tile
    nseg = -(-ct // KC)
    yl, xs = np.meshgrid(np.arange(rt), np.arange(nseg), indexing="ij")
    yl, xl = yl.ravel(), xs.ravel() * KC
    nkv = np.minimum(KC, ct - xl)
    kk = np.arange(KC)
    col_on = kk[None, :] < nkv[:, None]
    pv = np.where(col_on, pc[y0 + yl[:, None],
                             x0 + np.minimum(xl[:, None] + kk, ct - 1)], 0)
    acc = np.zeros((len(yl), KC), F32)
    for i in range(n):
        for j0 in range(0, n, SJ):
            nj = min(SJ, n - j0)
            ncol = nkv + nj - 1
            c = np.arange(KC + SJ - 1)
            c_on = c[None, :] < ncol[:, None]
            cols = np.where(c_on, x0 + xl[:, None] + j0 + c, 0)
            rows = (y0 + yl + i)[:, None]
            hw = np.where(c_on, hr[rows, cols], F32(0))
            mw = np.where(c_on, m[rows, cols], F32(0))
            for jj in range(nj):
                bias, v, a, _ = cst[i * n + j0 + jj]
                mv, hv = mw[:, jj:jj + KC], hw[:, jj:jj + KC]
                res = fma(-(pv + bias).astype(F32), mv, hv)
                e = fma(a, res, v) if sq else np.where(
                    res == 0, v, (v - times_sign(a, res)).astype(F32))
                acc = fma(mv, e, acc)
    for k in range(KC):
        on = col_on[:, k]
        dpc[y0 + yl[on], x0 + xl[on] + k] = acc[on, k]


@np.errstate(divide="ignore", invalid="ignore")
def emulate(hr, m, p, g, border, sq, bwd, nb, optin=232448):
    """The kernels' result, sample by sample, as their blocks compute it
    (a window with no clear pixel divides by 0, as the kernel does)."""
    hr, m, p = (np.asarray(a, F32) for a in (hr, m, p))
    bsz, h, w = p.shape
    q = launch_plan(bsz, h, w, border, nb, optin)
    n = 2 * border + 1
    s_n = n * n
    ch, cw = h - 2 * border, w - 2 * border
    out = np.zeros((bsz, h, w) if bwd else (bsz, s_n), F32)
    for b in range(bsz):
        pc = p[b, border:, border:]
        bands = [(k * q["R"], min((k + 1) * q["R"], ch))
                 for k in range(q["nb"])]
        assert bands[-1][1] == ch and all(b1 > b0 for b0, b1 in bands)
        cst = np.zeros((s_n, 4), F32)
        band_a = []
        for b0, b1 in bands:
            part = np.zeros((q["P"], 3, s_n), F32)
            for t in tiles(q, b0, b1, cw):
                sweep(0, bwd, sq, q, t, hr[b], m[b], pc, n, cst, part)
            band_a.append(rank_sum(part))
        tot = rank_sum(np.stack(band_a))
        cst[:, 0] = (tot[1] - tot[2]) / tot[0]
        band_b = []
        for b0, b1 in bands:
            part = np.zeros((q["P"], 1, s_n), F32)
            for t in tiles(q, b0, b1, cw):
                sweep(1, bwd, sq, q, t, hr[b], m[b], pc, n, cst, part)
            band_b.append(rank_sum(part)[0])
        v = rank_sum(np.stack(band_b))
        if not bwd:
            out[b] = v / tot[0]
            continue
        if sq:
            v = (v * F32(2)).astype(F32)
        c = (v / tot[0]).astype(F32)
        k = (np.asarray(g, F32)[b] / tot[0]).astype(F32)
        ck = (c * k).astype(F32)
        cst[:, 1] = ck
        cst[:, 2] = (F32(-2) * k) if sq else k
        dpc = out[b, border:border + ch, border:border + cw]
        for b0, b1 in bands:
            for t in tiles(q, b0, b1, cw):
                sweep_dp(sq, q, t, hr[b], m[b], pc, n, cst, dpc)
    return out


def rank_sum(a):
    """Sum over the first axis in its order, from 0.f, in float32."""
    v = np.zeros(a.shape[1:], F32)
    for x in a:
        v = (v + x).astype(F32)
    return v


CASES = [  # (b, size, border, blocks a cluster, optin): plan
    (2, 48, 3, 1, 232448),    # one band a sample, 42 rows in 6 items
    (2, 48, 3, 8, 232448),    # clusters of 7 bands of 6 rows
    (1, 131, 3, 4, 232448),   # 4 bands of 32 rows, the last 29
    (3, 7, 3, 16, 232448),    # one crop pixel
    (2, 20, 0, 10, 232448),   # one shift
    (2, 20, 1, 9, 232448),
    (2, 20, 2, 16, 232448),
    (1, 40, 5, 15, 232448),   # 11 shift rows: two groups
    (1, 48, 3, 1, 6000),      # row tiles and column tiles of a band
]


@pytest.mark.parametrize("b,size,border,nb,optin", CASES)
def test_emulated_tables_match_the_plain_twins(b, size, border, nb, optin):
    """Table rtol 3e-5, d/dpred rtol 1e-4 (atol 1e-6 max|ref|), the card
    tests' bounds, for L1 and L2, on the integer planes of tools/dyadic."""
    hr, m, p, g = shift_table_inputs(b, size, border, seed=size + border)
    for sq in (False, True):
        got = emulate(hr, m, p, g, border, sq, bwd=False, nb=nb,
                      optin=optin)
        np.testing.assert_allclose(
            got, st.shift_table_fwd_plain(hr, m, p, border, sq).numpy(),
            rtol=3e-5, atol=0)
        got = emulate(hr, m, p, g, border, sq, bwd=True, nb=nb,
                      optin=optin)
        want = st.shift_table_bwd_plain(hr, m, p, g, border, sq).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())


def test_the_case_plans_take_what_they_name():
    """The plans of CASES: one band and several, a ragged last band, the
    groups of shift rows, and tiles."""
    plans = [launch_plan(b, s, s, bd, nb, o) for b, s, bd, nb, o in
             CASES]
    assert plans[0]["nb"] == 1 and (plans[1]["nb"], plans[1]["R"]) == (7, 6)
    assert (plans[2]["nb"], plans[2]["R"]) == (4, 32)
    assert plans[7]["NW"] == 16 and -(-11 // SR) == 2
    assert plans[8]["RT"] < plans[8]["R"] and plans[8]["CT"] < 42


@pytest.mark.parametrize("b,size,nb,plan", [
    (128, 48, 1, dict(nb=1, R=42, RT=42, CT=42, NW=14, P=2, smem=21568)),
    (16, 384, 6, dict(nb=6, R=63, RT=63, CT=378, NW=14, P=2, smem=215272)),
    (16, 384, 8, dict(nb=8, R=48, RT=48, CT=378, NW=14, P=2, smem=169072)),
])
def test_launch_plan_at_the_main_paths_shapes(b, size, nb, plan):
    """The train step's 128 patches of 48^2 take a block a sample; 16
    scenes of 384^2 take clusters of 6 bands of 63 rows (an H100 holds 17
    such clusters at once and 15 of 8), each band staged whole."""
    assert launch_plan(b, size, size, 3, nb) == plan


def test_launch_plan_refuses_only_what_cannot_fit():
    """Every square plane that supports lets through launches up to the
    int32 index limit; a border too wide for the per-shift sums in shared
    memory is refused."""
    for size in (7, 48, 130, 131, 384, 1024, 4096, 46340):
        assert launch_plan(2, size, size, 3, 16) is not None
    assert launch_plan(1, 46341, 46341, 3, 16) is None
    assert launch_plan(2, 200, 200, 32, 16) is not None
    assert launch_plan(2, 200, 200, 33, 16) is None


@pytest.mark.parametrize("sq", [False, True], ids=["l1", "l2"])
def test_emulated_tables_match_jax_pallas(sq):
    """The emulation against _pallas_table_2d / _pallas_table_bwd_2d, the
    TPU kernels in interpret mode, at 8 samples of 24^2 in clusters of 6
    bands of 3 rows: table rtol 3e-5, d/dpred rtol 1e-4 (atol 1e-6 max|ref|)."""
    old, psl.INTERPRET = psl.INTERPRET, True
    try:
        hr, m, p, g = shift_table_inputs(8, 24, 3, seed=31)
        j = [jnp.asarray(t.numpy()) for t in (hr, m, p, g)]
        want = np.asarray(psl._pallas_table_2d(*j[:3], 3, sq))
        got = emulate(hr, m, p, g, 3, sq, bwd=False, nb=6)
        np.testing.assert_allclose(got, want, rtol=3e-5, atol=0)
        want = np.asarray(psl._pallas_table_bwd_2d(*j, 3, sq))
        got = emulate(hr, m, p, g, 3, sq, bwd=True, nb=6)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())
    finally:
        psl.INTERPRET = old
