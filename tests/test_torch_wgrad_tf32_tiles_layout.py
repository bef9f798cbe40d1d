"""The tiles of the float32 tensor-core wgrad beyond 32 channels (dWc of
``blk_bwd`` at the 64- and 48-filter models' widths), in numpy.

``wgrad_tf32_tiles_kernel`` (probav_tpu_torch/csrc/blk_bwd.cu) runs the body
of ``wgrad_tf32_kernel`` (``test_torch_wgrad_tf32_layout.py`` pins its
layout: halo cells of 40 floats, gy swizzled by o ^ 8 (p % 4), the ring of
four d slots and two gy slots, 12 warps of nine taps each) on 32 x 32
channel tiles over the grid, at c_dec, c_out <= 64:

- block s * tiles + t takes channel tile t, c's from c0 = 32 (t % tc) and
  o's from o0 = 32 (t / tc) (tc = the c tiles: 2 x 2 at 51 -> 64), of the
  items of slot s, the B*H items cut into G runs as the flagship's blocks
  cut them;
- its copies put channel c0 + c of a row of d at cell offset c of each
  position (c < cw = min(32, c_dec - c0)) and output o0 + o of gy at o ^ 8
  (p % 4) (o < ow): lane c of warp w copies positions w, w + 12, ...; the
  channels from cw and ow on keep the zeros laid once;
- it writes its tile of dWc, [tap][c0 + c][o0 + o], into slot s: each entry
  of a slot has one writer, the slots are summed in order.

The twin below stages each tile's rows by those maps, gathers every A and B
word by lane from the staged slots (the flagship twin's addresses), splits
them as common.cuh's split_tf32 and takes the three TF32 products (hi hi,
lo hi, hi lo; lo read at TF32) of each item's k-steps in float64, added in
float32 to the running sums.  It is held to ``blk_bwd_plain``'s dWc on the
dyadic inputs of ``tools/dyadic.py`` (TF32 values: lo = 0, every product
and partial sum exact, so bit for bit), to the JAX package's Pallas
``blk_bwd`` in interpret mode at float32, and on random-normal d and gy
within 2e-5 of a float64 dWc, which one TF32 product misses.  The kernel
runs only on the card; this pins what it addresses.
"""

import re

import numpy as np
import pytest
import torch

from probav_tpu_torch.ops import _build
from probav_tpu_torch.ops import tstack as ts
from probav_tpu_torch.tools.dyadic import blk_bwd_inputs
from test_torch_seg_bwd_tf32_split_layout import jax_pallas_blk_bwd_f32
from test_torch_tf32_split import split_tf32, tf32_read
from test_torch_wgrad_tf32_layout import (CS, OPTIN, WARPS, WPAD, a_addrs,
                                          a_tile, b_addrs, b_tile, c_words,
                                          npk_of, prow_of, stage_d, stage_g,
                                          wgrad_tf32_smem)

torch.set_num_threads(1)

TILE = 32                     # channels a tile, each way


def tiles_of(c_dec, c_out):
    """(tc, tiles): the c tiles and all tiles of the grid's channel cut."""
    tc = -(-c_dec // TILE)
    return tc, tc * -(-c_out // TILE)


def tile_box(t, c_dec, c_out):
    """(c0, cw, o0, ow) of channel tile t."""
    tc, _ = tiles_of(c_dec, c_out)
    c0, o0 = TILE * (t % tc), TILE * (t // tc)
    return c0, min(TILE, c_dec - c0), o0, min(TILE, c_out - o0)


def copy_map(wt, cw):
    """The (position, channel) each (warp, lane) copies in one row: lane c
    < cw of warp w at positions w, w + 12, ...; every pair once."""
    return [(p, lane) for w in range(WARPS) for lane in range(cw)
            for p in range(w, wt, WARPS)]


def split_einsum(at, bt, terms):
    """sum_k at[k] bt[k] of [nk, 16, 8] A and [nk, 8, 8] B tiles as the
    3xTF32 products (``terms`` of hi hi, lo hi, hi lo), in float64."""
    ah, al = split_tf32(at)
    bh, bl = split_tf32(bt)
    pairs = ((ah, bh), (tf32_read(al), bh), (ah, tf32_read(bl)))[:terms]
    return sum(np.einsum("kij,kjl->il", a.astype(np.float64),
                         b.astype(np.float64)) for a, b in pairs)


def tiles_twin(d, gy, groups, terms=3):
    """dWc [27, c_dec, c_out] as the G x tiles blocks compute it, their
    slots summed in order."""
    b_n, h_n, w, t, c_dec = d.shape
    c_out = gy.shape[-1]
    prow = prow_of(w, t)
    npk = len(prow)
    nk = npk // 8
    items = b_n * h_n
    d_rows = d.reshape(items, w, t, c_dec)
    g_rows = gy.reshape(items, w, t, c_out)
    _, tiles = tiles_of(c_dec, c_out)
    per = -(-items // groups)
    part = np.full((groups, 27, c_dec, c_out), np.nan, np.float32)
    for blk in range(groups * tiles):
        tile, slot = blk % tiles, blk // tiles
        c0, cw, o0, ow = tile_box(tile, c_dec, c_out)
        i0 = min(items, slot * per)
        i1 = min(items, i0 + per)
        acc = np.zeros((WARPS, 3, 3, 2, 4, 32), np.float32)
        for item in range(i0, i1):
            h = item % h_n
            gs = stage_g(g_rows[item][..., o0:o0 + ow], npk)
            for warp in range(WARPS):
                dh, mi, np_ = warp // 4, warp % 2, (warp // 2) % 2
                if not 0 <= h + dh - 1 < h_n:
                    continue   # a zero row of d
                ds = stage_d(d_rows[item + dh - 1][..., c0:c0 + cw], prow)
                bt = [b_tile(gs[np.stack([b_addrs(kk, np_, n)
                                          for kk in range(nk)])])
                      for n in range(2)]
                for dw in range(3):
                    for dt in range(3):
                        at = a_tile(ds[np.stack(
                            [a_addrs(prow, kk, mi, dw, dt, t)
                             for kk in range(nk)])])
                        for n in range(2):
                            fresh = split_einsum(at, bt[n], terms)
                            acc[warp, dw, dt, n] += c_words(fresh)
        for warp in range(WARPS):
            dh, mi, np_ = warp // 4, warp % 2, (warp // 2) % 2
            for dw in range(3):
                for dt in range(3):
                    for n in range(2):
                        for i in range(4):
                            c = 16 * mi + np.arange(32) // 4 + \
                                (8 if i >= 2 else 0)
                            o = 16 * np_ + 8 * n + 2 * (np.arange(32) % 4) + \
                                (i & 1)
                            ok = (c < cw) & (o < ow)
                            at = (slot, dh * 9 + dw * 3 + dt, c0 + c[ok],
                                  o0 + o[ok])
                            assert np.isnan(part[at]).all(), "written twice"
                            part[at] = acc[warp, dw, dt, n, i][ok]
    assert not np.isnan(part).any(), "a slot entry unwritten"
    out = np.zeros((27, c_dec, c_out), np.float32)
    for g in range(groups):
        out += part[g]
    return out


@pytest.mark.parametrize("shape,c,cmid,cdec,groups", [
    ((1, 2, 22, 9), 64, 512, 51, 2),
    ((1, 2, 22, 9), 48, 384, 38, 1),
    ((2, 3, 6, 5), 64, 512, 51, 8),
    ((3, 4, 5, 1), 33, 64, 40, 5)],
    ids=["c64_row_g2", "c48_row", "c64_bh_below_g8", "c33_t1_g5"])
def test_tiles_twin_matches_plain_dwc(shape, c, cmid, cdec, groups):
    """The 64-filter widths on two 22 x 9 rows (2 x 2 tiles, the second c
    tile 19 channels), the 48-filter widths (38 -> 48: tiles of 32 and 6,
    32 and 16), six items for eight slots (the rest write zeros), and
    40 -> 33 at T = 1 in five slots (runs that start mid-image)."""
    gy, x, d, w1, b1, w2, wc = blk_bwd_inputs(shape, c, cmid, cdec, seed=4)
    want = ts.blk_bwd_plain(gy, x, d, w1, b1, w2, wc)[1]
    got = tiles_twin(d.numpy(), gy.numpy(), groups)
    np.testing.assert_array_equal(got.reshape(3, 3, 3, cdec, c),
                                  want.numpy())


def test_tiles_twin_matches_jax_pallas_blk_bwd(monkeypatch):
    """The 64-filter widths at float32 on 15 rows against the JAX
    package's Pallas kernel's dWc."""
    args = blk_bwd_inputs((1, 1, 5, 3), 64, 512, 51, seed=6)
    ref = jax_pallas_blk_bwd_f32(args, monkeypatch)[1]
    got = tiles_twin(args[2].numpy(), args[0].numpy(), 2)
    np.testing.assert_allclose(got.reshape(ref.shape), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_three_tf32_products_hold_random_normal_dwc():
    """On random-normal d and gy (not TF32 values) the three products put
    dWc within 2e-5 of max|ref| of float64, where hi hi alone does not."""
    r = np.random.default_rng(2)
    d = r.normal(size=(1, 2, 6, 5, 51)).astype(np.float32)
    gy = r.normal(size=(1, 2, 6, 5, 64)).astype(np.float32)
    dp = np.pad(d.astype(np.float64), ((0, 0), (1, 1), (1, 1), (1, 1),
                                       (0, 0)))
    ref = np.stack([np.einsum("bhwtc,bhwto->co",
                              dp[:, i:i + 2, j:j + 6, k:k + 5], gy)
                    for i in range(3) for j in range(3) for k in range(3)])
    scale = np.abs(ref).max()
    err = lambda terms: np.abs(tiles_twin(d, gy, 2, terms) - ref).max() / scale
    assert err(3) <= 2e-5
    assert err(1) > 2e-5


def test_tiles_copy_every_channel_once_and_fit_the_flagship_layout():
    """Each (position, channel) of a tile's row is copied by exactly one
    lane; the tile's layout is wgrad_tf32_smem's (227,104 B at 22 x 9,
    whatever the widths), so the routes take rows up to 22 x 9 and send
    W = 48 and T = 19 at 64/51 to the CUDA cores; the 64- and 48-filter
    widths cut into 2 x 2 tiles."""
    for wt, cw in ((198, 32), (198, 19), (30, 6), (5, 32)):
        got = copy_map(wt, cw)
        assert len(got) == len(set(got)) == wt * cw
    assert wgrad_tf32_smem(22, 9) == 227_104 <= OPTIN
    assert wgrad_tf32_smem(48, 9) > OPTIN and wgrad_tf32_smem(22, 19) > OPTIN
    assert tiles_of(51, 64) == (2, 4) and tiles_of(38, 48) == (2, 4)
    assert tiles_of(40, 33) == (2, 4) and tiles_of(25, 64) == (1, 2)
    assert [tile_box(t, 51, 64) for t in range(4)] == [
        (0, 32, 0, 32), (32, 19, 0, 32), (0, 32, 32, 32), (32, 19, 32, 32)]
    assert npk_of(22, 9) == 200


def test_tiles_mirror_matches_the_source():
    """The flagship layout's constants the tiles reuse, and the tiles'
    32-channel cut, are the kernel's."""
    src = (_build.SRC_DIR / "blk_bwd.cu").read_text()
    got = {k: int(v) for k, v in re.findall(
        r"constexpr int WGT_(\w+) = (\d+);", src)}
    assert got == dict(WARPS=WARPS, CS=CS, WPAD=WPAD)
    body = src[src.index("void wgrad_tf32_body("):
               src.index("wgrad_tf32_tiles_kernel(const float*")]
    assert "const int tc = (c_dec + 31) / 32, tiles = tc * ((c_out + 31) / " \
        "32);" in body
    assert "for (int p = warp; p < WT; p += WGT_WARPS)" in body
    assert "(lane ^ ((p & 3) << 3))" in body
