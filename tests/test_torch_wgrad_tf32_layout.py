"""The addressing of the float32 tensor-core wgrad (dWc of ``blk_bwd``), in
numpy.

``wgrad_tf32_kernel`` (probav_tpu_torch/csrc/blk_bwd.cu) computes
dWc[tap] = sum_q d(q + off(tap)) gy(q)^T as 3xTF32 on mma.sync m16n8k8 from
staged tiles:

- each row of d as a zero-padded (W+2) x (T+2) halo grid of cells of
  CS = 40 floats, each w-row of cells followed by 16 floats (row stride
  WS = 40 (T+2) + 16); gy position k = w T + t has its centre cell at
  prow[k] = (w+1) WS + (t+1) CS and reads tap (dw, dt) at prow[k] +
  (dw-1) WS + (dt-1) CS; K is rounded up to 8, and past the row prow
  repeats position 0 against a zero gy;
- the row of gy as [position][32], channel o of position p at
  o ^ 8 (p % 4);
- fragments: with g = lane // 4 and q = lane % 4, A = d^T holds
  (c = g, g+8; position q, q+4) and B = gy (position q, q+4; o = g); C
  (16 x 8) holds rows g, g+8 at columns 2q, 2q+1 (common.cuh, mma_tf32);
- 12 warps: warp w takes the h tap dh = w // 4, channels 16 (w % 2) ..,
  outputs 16 ((w // 2) % 2) .. and the nine taps (dw, dt);
- G blocks each walk a contiguous run of (b, h) items; global row
  r = b H + h of d sits in ring slot r % 4, gy in slot (item - i0) % 2; a
  block stages rows i0 - 1 .. i0 + 1 and gy row i0 first, then at each
  item i row i + 2 and gy row i + 1 for the next; a warp skips a tap row
  outside its image;
- each item's products of one dw go to fresh sums, added to the running
  sums, which are written once to the block's slot; the slots are summed
  in order.

The twin below repeats that index math, fragment map and schedule, word
by word, and is held to ``blk_bwd_plain``'s dWc.  On the dyadic inputs of
``tools/dyadic.py`` (TF32 values, so lo = 0, on a 2**-4 grid) every
product and partial sum is exact in float32, so the twin must equal the
plain dWc bit for bit: a wrong word, shift, slot or swizzle moves whole
products.  The kernel runs only on the card; this pins what it addresses.
"""

import numpy as np
import pytest
import torch

from probav_tpu_torch.ops import tstack as ts
from probav_tpu_torch.tools.dyadic import blk_bwd_inputs

torch.set_num_threads(1)

CS, WPAD, WARPS = 40, 16, 12   # WGT_CS, WGT_WPAD, WGT_WARPS
H100_SLOTS = 264               # partial_slots on an H100 up to 64 channels
OPTIN = 232_448                # an H100's shared memory a block may opt in to
LANE = np.arange(32)
G_, Q_ = LANE // 4, LANE % 4


def ws_of(t):
    return (t + 2) * CS + WPAD


def npk_of(w, t):
    return (w * t + 7) // 8 * 8


def prow_of(w, t):
    """The centre cell (float offset in a slot) of each gy position."""
    k = np.arange(npk_of(w, t))
    p = np.where(k < w * t, k, 0)
    return (p // t + 1) * ws_of(t) + (p % t + 1) * CS


def wgrad_tf32_smem(w, t):
    """Shared-memory bytes (blk_bwd.cu's wgrad_tf32_smem): four d slots,
    two gy slots, prow."""
    npk = npk_of(w, t)
    return 4 * (4 * (w + 2) * ws_of(t) + 2 * npk * 32) + 4 * npk


def stage_d(row, prow):
    """One row [W, T, c_dec] of d as its slot: channel c of position p at
    prow[p] + c, zeros elsewhere."""
    w, t, c_dec = row.shape
    slot = np.zeros((w + 2) * ws_of(t), np.float32)
    idx = prow[:w * t, None] + np.arange(c_dec)
    slot[idx] = row.reshape(w * t, c_dec)
    return slot


def stage_g(row, npk):
    """One row [W, T, c_out] of gy as its slot, swizzled."""
    w, t, c_out = row.shape
    slot = np.zeros(npk * 32, np.float32)
    p = np.arange(w * t)[:, None]
    slot[p * 32 + (np.arange(c_out) ^ ((p & 3) << 3))] = \
        row.reshape(w * t, c_out)
    return slot


def a_addrs(prow, kk, mi, dw, dt, t):
    """The four A words' slot offsets [4, 32] of k-step kk, tap (dw, dt)."""
    arow = 16 * mi + G_ - ws_of(t) - CS + dw * ws_of(t) + dt * CS
    a0 = prow[kk * 8 + Q_] + arow
    a4 = prow[kk * 8 + Q_ + 4] + arow
    return np.stack([a0, a0 + 8, a4, a4 + 8])


def b_addrs(kk, np_, n):
    """The two B words' slot offsets [2, 32] of k-step kk, n-tile n."""
    boff = Q_ * 32 + ((16 * np_ + 8 * n + G_) ^ (8 * Q_))
    return np.stack([kk * 256 + boff, kk * 256 + boff + 128])


def a_tile(words):
    """[nk, 4, 32] A words -> [nk, 16, 8] tiles (rows c, columns k)."""
    tile = np.zeros((words.shape[0], 16, 8), np.float32)
    for j, (r, c) in enumerate([(G_, Q_), (G_ + 8, Q_), (G_, Q_ + 4),
                                (G_ + 8, Q_ + 4)]):
        tile[:, r, c] = words[:, j]
    return tile


def b_tile(words):
    """[nk, 2, 32] B words -> [nk, 8, 8] tiles (rows k, columns o)."""
    tile = np.zeros((words.shape[0], 8, 8), np.float32)
    tile[:, Q_, G_] = words[:, 0]
    tile[:, Q_ + 4, G_] = words[:, 1]
    return tile


def c_words(tile):
    """[16, 8] C tile -> [4, 32] words of the lanes."""
    return np.stack([tile[G_, 2 * Q_], tile[G_, 2 * Q_ + 1],
                     tile[G_ + 8, 2 * Q_], tile[G_ + 8, 2 * Q_ + 1]])


def wgrad_tf32_twin(d, gy, groups):
    """dWc [27, c_dec, c_out] as the kernel's G blocks compute it, their
    float32 slots summed in order; also the rows of d each block staged."""
    b_n, h_n, w, t, c_dec = d.shape
    c_out = gy.shape[-1]
    prow = prow_of(w, t)
    npk = len(prow)
    nk = npk // 8
    items = b_n * h_n
    d_rows = d.reshape(items, w, t, c_dec)
    g_rows = gy.reshape(items, w, t, c_out)
    per = -(-items // groups)
    part = np.zeros((groups, 27, c_dec, c_out), np.float32)
    staged = []
    for blk in range(groups):
        i0 = min(items, blk * per)
        i1 = min(items, i0 + per)
        ring, held, gsl = [None] * 4, [None] * 4, [None] * 2
        rows = []

        def copy_d(r):
            ring[r % 4], held[r % 4] = stage_d(d_rows[r], prow), r
            rows.append(r)

        if i0 < i1:
            for r in range(max(i0 - 1, 0), min(i0 + 1, items - 1) + 1):
                copy_d(r)
            gsl[0] = stage_g(g_rows[i0], npk)
        # acc[warp][dw][dt][n] holds the lanes' 4 C words: [4, 32].
        acc = np.zeros((WARPS, 3, 3, 2, 4, 32), np.float32)
        for item in range(i0, i1):
            h = item % h_n
            buf = (item - i0) & 1
            if item + 1 < i1:   # the next item's copies, before compute
                if item + 2 < items:
                    copy_d(item + 2)
                gsl[buf ^ 1] = stage_g(g_rows[item + 1], npk)
            for warp in range(WARPS):
                dh, mi, np_ = warp // 4, warp % 2, (warp // 2) % 2
                if not 0 <= h + dh - 1 < h_n:
                    continue   # a zero row of d
                r = item + dh - 1
                assert held[r % 4] == r, (item, warp, held)
                slot = ring[r % 4]
                bt = [b_tile(gsl[buf][np.stack(
                    [b_addrs(kk, np_, n) for kk in range(nk)])])
                    for n in range(2)]
                for dw in range(3):
                    for dt in range(3):
                        at = a_tile(slot[np.stack(
                            [a_addrs(prow, kk, mi, dw, dt, t)
                             for kk in range(nk)])])
                        for n in range(2):
                            fresh = np.einsum("kij,kjl->il", at, bt[n])
                            acc[warp, dw, dt, n] += c_words(fresh)
        for warp in range(WARPS):
            dh, mi, np_ = warp // 4, warp % 2, (warp // 2) % 2
            for dw in range(3):
                for dt in range(3):
                    for n in range(2):
                        for i in range(4):
                            c = 16 * mi + G_ + (8 if i >= 2 else 0)
                            o = 16 * np_ + 8 * n + 2 * Q_ + (i & 1)
                            ok = (c < c_dec) & (o < c_out)
                            part[blk, dh * 9 + dw * 3 + dt, c[ok], o[ok]] = \
                                acc[warp, dw, dt, n, i][ok]
        staged.append((i0, i1, rows))
    out = np.zeros((27, c_dec, c_out), np.float32)
    for g in range(groups):
        out += part[g]
    return out, staged


@pytest.mark.parametrize("shape,c,cmid,cdec,groups", [
    ((3, 7, 6, 5), 8, 64, 6, H100_SLOTS),
    ((3, 7, 6, 5), 8, 64, 6, 4),
    ((2, 3, 22, 9), 32, 256, 25, 4),
    ((2, 5, 22, 9), 32, 256, 32, 3),
    ((2, 3, 6, 5), 32, 256, 25, H100_SLOTS),
    ((3, 4, 5, 1), 20, 64, 17, 5)],
    ids=["small", "small_g4", "flagship_row", "cdec32", "bh_below_g",
         "t1"])
def test_wgrad_tf32_twin_matches_plain_dwc(shape, c, cmid, cdec, groups):
    """Every item its own block, runs that start mid-image (G = 4: blocks
    start at h = 6, 5, 4 ...) and cross images, the flagship's 22 x 9 rows
    and 32/25 channels (K = 198 rounded to 200), c_dec = c_out = 32 (no
    zero channels), fewer items than blocks (the rest write zeros), and
    T = 1 (every position step crosses a w-row)."""
    gy, x, d, w1, b1, w2, wc = blk_bwd_inputs(shape, c, cmid, cdec, seed=4)
    want = ts.blk_bwd_plain(gy, x, d, w1, b1, w2, wc)[1]
    got, staged = wgrad_tf32_twin(d.numpy(), gy.numpy(), groups)
    np.testing.assert_array_equal(got.reshape(3, 3, 3, cdec, c),
                                  want.numpy())
    # Each block stages the rows of d it reads, each once: rows i0 - 1 ..
    # i1 within the volume, across images too.
    items = shape[0] * shape[1]
    for i0, i1, rows in staged:
        if i0 < i1:
            assert rows == list(range(max(i0 - 1, 0), min(i1, items - 1) + 1))
        else:
            assert rows == []


def conflicts(addrs):
    """The most distinct words one bank serves in a 32-lane load (1: none)."""
    banks = {}
    for a in np.unique(addrs):
        banks[a % 32] = banks.get(a % 32, 0) + 1
    return max(banks.values())


@pytest.mark.parametrize("w,t", [(22, 9), (6, 5), (7, 3), (9, 1), (5, 19),
                                 (3, 8)])
def test_wgrad_tf32_loads_are_bank_conflict_free(w, t):
    """Every A load (4 positions q x 8 channels g of a tap) and every B load
    (4 positions x 8 outputs) falls in 32 distinct banks in each k-step,
    whichever w-rows its positions cross.  The one conflict allowed: in a
    k-step past the row's end the positions k >= W*T repeat position 0's
    cell (against a zero gy), which may share banks."""
    prow = prow_of(w, t)
    nk = len(prow) // 8
    slot_f = (w + 2) * ws_of(t)
    for kk in range(nk):
        past = (kk + 1) * 8 > w * t
        for slot in range(4):       # the slot base moves every lane alike
            for mi in range(2):
                for dw in range(3):
                    for dt in range(3):
                        for a in a_addrs(prow, kk, mi, dw, dt, t):
                            a = a + slot * slot_f
                            assert 0 <= a.min() and a.max() < 4 * slot_f
                            if not past:
                                assert conflicts(a) == 1, (kk, mi, dw, dt)
        for np_ in range(2):
            for n in range(2):
                for b in b_addrs(kk, np_, n):
                    assert conflicts(b) == 1, (kk, np_, n)


def test_wgrad_tf32_layout_fits_only_the_routed_rows():
    """The flagship's 22 x 9 rows fit an H100's 232,448 bytes a block, as
    do smaller ones; W = 23 and W = 48 at T = 9 and T = 19 at W = 22 do
    not, and wgrad_route sends them to the CUDA-core wgrad.  K is rounded
    up to 8 and the centre cells are those of the halo grid."""
    assert wgrad_tf32_smem(22, 9) == 227_104 <= OPTIN
    assert wgrad_tf32_smem(6, 5) <= OPTIN and wgrad_tf32_smem(5, 19) <= OPTIN
    for w, t in ((23, 9), (48, 9), (22, 19)):
        assert wgrad_tf32_smem(w, t) > OPTIN, (w, t)
    assert wgrad_tf32_smem(48, 9) == 477_120
    assert wgrad_tf32_smem(22, 19) == 438_944
    assert npk_of(22, 9) == 200 and npk_of(6, 5) == 32 and npk_of(9, 1) == 16
    prow = prow_of(22, 9)
    assert prow[0] == ws_of(9) + CS and prow[197] == 22 * 456 + 9 * 40
    assert (prow[198:] == prow[0]).all()
    # A step of one position is 40 floats in a w-row and 136 across one:
    # both 8 (mod 32).
    steps = np.diff(prow[:198]) % 32
    assert set(np.diff(prow[:198])) == {40, 136} and set(steps) == {8}


def test_wgrad_variants_tool_applies_to_the_kernel_source():
    """tools/wgrad_variants.py builds its variants by text substitution in
    the kernel's section of blk_bwd.cu: every substitution still finds its
    text, and each variant gets its own copy of the kernel and a launch
    case."""
    from probav_tpu_torch.tools import wgrad_variants as wv
    names = list(wv.VARIANTS)
    src = wv.source(names)
    assert src.count("wgrad_tf32_kernel(const float* __restrict__ d") == \
        len(names)
    for i in range(len(names)):
        assert f"if (v == {i}) return v{i}::launch_wgrad_tf32(" in src
    assert "mma_term(acc[dw][dt][n]" in wv.source(["no_fresh_sums"])
