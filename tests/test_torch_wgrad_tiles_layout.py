"""The channel tiles, slots and hand-over of the bf16 tensor-core wgrad (dWc
of ``blk_bwd``) beyond 32 channels, in numpy.

``wgrad_tiles_kernel`` (probav_tpu_torch/csrc/blk_bwd.cu) takes c_dec,
c_out up to 64 (the 64-filter model's 51 -> 64, the 48-filter model's 38
-> 48) in 32 x 32 tiles of (c, o) over the grid: block s * tiles + t takes
tile t = (c-tile t % ceil(c_dec / 32), o-tile t / ceil(c_dec / 32)) of the
(b, h) items of slot s, the items cut into G runs as in
``wgrad_ring_kernel`` (``tests/test_torch_wgrad_layout.py``); its sums
land in dWc[tap][c0 + c][o0 + o] of its slot, c0 + c < c_dec and o0 + o <
c_out, so every entry of every slot has one writer, and the G slots are
summed in order.

Three producer warps stage the items one ahead of nine consumer warps:
the rows of d go to a ring of five slots by the count of rows staged (the
block's first item up to three rows, every later one at most two, an
image's rows 0 and 1), gy to one of two slots by item parity, and
``tbl[parity][dh]`` names the ring slot of row h + dh - 1 (-1 outside the
image).  Each position's 32 channels of the tile are repacked from the raw
row by 32-bit words, realigned by a byte permute where they start on an
odd element.  Named barriers hand the items over (FULL by parity: the
producers arrive, the consumers sync; EMPTY by parity: the other way; the
producers sync EMPTY of item j - 1 after handing over item j, before they
write item j + 1's gy slot, and of the last two at the end).

The twins below repeat the split, the ring and its slot table, the slot
offsets, the word repack and the barrier protocol, and are held to
``blk_bwd_plain``'s dWc bit for bit on the dyadic inputs of
``tools/dyadic.py`` (every product on a 2**-8 grid, every partial sum
below 2**14: exact in any order); the ring never overwrites a row that
the item in flight reads, and the protocol neither deadlocks nor leaves a
barrier phase open.
"""

import numpy as np
import pytest
import torch

from probav_tpu_torch.ops import tstack as ts
from probav_tpu_torch.tools.dyadic import blk_bwd_inputs
from test_torch_wgrad_layout import (CSP, H100_SLOTS, first_row, npk_of,
                                     prow_of, wgrad_ring_smem)

torch.set_num_threads(1)

OPTIN = 232_448
RING, RAW = 5, 2                     # blk_bwd.cu's WTL_RING, WTL_RAW


def stage_tile(row, ch0, prow, rows):
    """Channels ch0 .. ch0 + 32 of one row [W, T, cn] of d (into halo rows
    prow) or of gy (into rows 0..W*T-1), zero from cn; the rest zero."""
    w, t, cn = row.shape
    slot = np.zeros((rows, CSP), np.float32)
    idx = prow[:w * t] if prow is not None else np.arange(w * t)
    take = row.reshape(w * t, cn)[:, ch0:ch0 + 32]
    slot[idx, :take.shape[1]] = take
    return slot


def producer_schedule(i0, i1, h_n):
    """Per item of a run: (its parity, the rows it stages, the ring slot
    of each, tbl's three slots), as the producer warps count them."""
    out, rs, staged = [], [-1, -1, -1], 0
    for item in range(i0, i1):
        h = item % h_n
        lo, hi = first_row(item, i0, h_n), min(h + 1, h_n - 1)
        rs = [-1, -1, -1] if item == i0 or h == 0 else [rs[1], rs[2], -1]
        rows = list(range(lo, hi + 1)) if lo >= 0 else []
        slots = []
        for r in rows:
            slots.append(staged % RING)
            rs[r - h + 1] = staged % RING
            staged += 1
        out.append(((item - i0) % 2, rows, slots, list(rs)))
    return out


def wgrad_tiles_twin(d, gy, groups, offsets=True):
    """(dWc [27, c_dec, c_out], the G slots [G, 27, c_dec, c_out]) as the
    kernel's G x tiles blocks compute them, the slots summed in order.
    ``offsets=False`` stages every tile's slices from channel 0."""
    b_n, h_n, w, t, c_dec = d.shape
    c_out = gy.shape[-1]
    tc = -(-c_dec // 32)
    tiles = tc * -(-c_out // 32)
    prow = prow_of(w, t)
    halo = (w + 2) * (t + 2)
    items = b_n * h_n
    per = -(-items // groups)
    part = np.full((groups, 27, c_dec, c_out), np.nan, np.float32)
    for blk in range(groups * tiles):
        tile, s = blk % tiles, blk // tiles
        c0, o0 = (32 * (tile % tc), 32 * (tile // tc)) if offsets else (0, 0)
        i0 = min(items, s * per)
        i1 = min(items, i0 + per)
        ring = [np.zeros((halo, CSP), np.float32) for _ in range(RING)]
        held = [None] * RING
        gsl = [None, None]
        acc = np.zeros((27, 32, 32), np.float32)
        sched = producer_schedule(i0, i1, h_n)
        for k, item in enumerate(range(i0, i1)):
            b, h = divmod(item, h_n)
            par, rows, slots, tbl = sched[k]
            assert len(rows) <= (3 if item == i0 else RAW)
            if k > 0:   # the item in flight reads its rows: never restaged
                busy = {sl for sl in sched[k - 1][3] if sl >= 0}
                assert not busy & set(slots), (item, busy, slots)
            for r, sl in zip(rows, slots):
                ring[sl] = stage_tile(d[b, r], c0, prow, halo)
                held[sl] = (b, r)
            gsl[par] = stage_tile(gy[b, h], o0, None, len(prow))
            for dh in range(3):
                hh, sl = h + dh - 1, tbl[dh]
                if not 0 <= hh < h_n:
                    assert sl == -1
                    continue
                assert held[sl] == (b, hh), (item, dh, held, tbl)
                for dw in range(3):
                    for dt in range(3):
                        at = prow + (dw - 1) * (t + 2) + dt - 1
                        a = ring[sl][at, :32]
                        acc[dh * 9 + dw * 3 + dt] += a.T @ gsl[par][:, :32]
        c0, o0 = 32 * (tile % tc), 32 * (tile // tc)
        cw, ow = min(32, c_dec - c0), min(32, c_out - o0)
        dst = part[s, :, c0:c0 + cw, o0:o0 + ow]
        assert np.isnan(dst).all(), (blk, "a slot entry written twice")
        dst[...] = acc[:, :cw, :ow]
    assert not np.isnan(part).any(), "a slot entry unwritten"
    out = np.zeros((27, c_dec, c_out), np.float32)
    for g in range(groups):
        out += part[g]
    return out, part


@pytest.mark.parametrize("shape,c,cmid,cdec,groups", [
    ((1, 4, 11, 9), 64, 512, 51, 3),
    ((2, 2, 11, 9), 48, 384, 38, 2),
    ((2, 3, 6, 5), 64, 512, 51, H100_SLOTS),
    ((3, 7, 6, 5), 33, 64, 40, 4)],
    ids=["c64_cdec51_396rows_g3", "c48_cdec38_396rows_g2", "bh_below_g",
         "c33_cdec40_g4"])
def test_wgrad_tiles_twin_matches_plain_dwc(shape, c, cmid, cdec, groups):
    """The 64- and 48-filter widths (2 x 2 tiles; a c-tile of 19 or 6 and
    an o-tile of 32 or 16 real channels) on a few hundred rows, in runs
    that start mid-image and cross an image's row 0; fewer items than
    slots (B*H = 6 of 264: the other slots' tiles hold zeros); 33 -> 40
    channels with runs of 6 items over images of 7 rows."""
    gy, x, d, w1, b1, w2, wc = blk_bwd_inputs(shape, c, cmid, cdec, seed=6)
    want = ts.blk_bwd_plain(gy, x, d, w1, b1, w2, wc)[1]
    got, part = wgrad_tiles_twin(d.numpy(), gy.numpy(), groups)
    np.testing.assert_array_equal(got.reshape(3, 3, 3, cdec, c),
                                  want.numpy())
    items = shape[0] * shape[1]
    if groups > items:
        assert (part[items:] == 0).all()


def test_wgrad_tiles_without_channel_offsets_are_wrong():
    """Tiles that staged their slices of d and gy from channel 0, not from
    c0 and o0, put the first tile's sums in every tile's place: dWc far
    from plain."""
    gy, x, d, w1, b1, w2, wc = blk_bwd_inputs((1, 4, 11, 9), 64, 512, 51,
                                              seed=7)
    want = ts.blk_bwd_plain(gy, x, d, w1, b1, w2, wc)[1].numpy()
    got, _ = wgrad_tiles_twin(d.numpy(), gy.numpy(), 3, offsets=False)
    assert np.abs(got.reshape(want.shape) - want).max() > 1.0


def barrier_ops(i0, i1):
    """Each role's named-barrier operations over a run, in order: (kind,
    barrier, parity) with kind "arrive" or "sync"."""
    prod, cons = [], []
    for item in range(i0, i1):
        par = (item - i0) % 2
        prod.append(("arrive", "FULL", par))
        if item + 1 < i1 and item + 1 - i0 >= 2:
            prod.append(("sync", "EMPTY", (item - 1 - i0) % 2))
        cons += [("sync", "FULL", par), ("arrive", "EMPTY", par)]
    for item in range(max(i0, i1 - 2), i1):
        prod.append(("sync", "EMPTY", (item - i0) % 2))
    return prod, cons


def run_protocol(prod, cons):
    """Step two roles through their barrier operations as the hardware
    does: a phase of a barrier completes when both roles have reached it
    (an arrive goes on at once, a sync waits for its phase to complete).
    Returns the phases completed per barrier; raises on a deadlock, on a
    role reaching an open phase twice, or on a phase left open."""
    done, pending = {}, {}
    ops = {"p": prod, "c": cons}
    pos = {"p": 0, "c": 0}
    waiting = {"p": None, "c": None}
    while any(pos[r] < len(ops[r]) or waiting[r] for r in ops):
        moved = False
        for role in ops:
            if waiting[role] is not None:
                key, phase = waiting[role]
                if done.get(key, 0) > phase:
                    waiting[role] = None
                    moved = True
                continue
            if pos[role] == len(ops[role]):
                continue
            kind, bar, par = ops[role][pos[role]]
            key = (bar, par)
            arrived = pending.setdefault(key, set())
            assert role not in arrived, (role, key, "reached an open phase "
                                         "twice")
            arrived.add(role)
            phase = done.get(key, 0)
            if arrived == set(ops):
                done[key] = phase + 1
                pending[key] = set()
            pos[role] += 1
            if kind == "sync":
                waiting[role] = (key, phase)
            moved = True
        if not moved:
            raise AssertionError(f"deadlock at {pos}, {waiting}, {pending}")
    assert not any(pending.values()), f"phases left open: {pending}"
    return done


@pytest.mark.parametrize("n", [0, 1, 2, 3, 11, 12])
def test_barrier_protocol_completes_every_phase(n):
    """Runs of 0 to 12 items: every FULL and EMPTY phase completes, one an
    item, and neither role waits forever."""
    prod, cons = barrier_ops(5, 5 + n)
    done = run_protocol(prod, cons)
    for bar in ("FULL", "EMPTY"):
        assert done.get((bar, 0), 0) == (n + 1) // 2
        assert done.get((bar, 1), 0) == n // 2


def test_barrier_protocol_without_the_tail_leaves_phases_open():
    """Without the producers' EMPTY syncs of the last two items the
    consumers' last arrivals stay pending: the tail is what closes them."""
    prod, cons = barrier_ops(0, 5)
    with pytest.raises(AssertionError, match="left open"):
        run_protocol(prod[:-2], cons)


def test_producer_ring_at_the_train_steps_rows():
    """The 64-filter step's runs (128 x 22 items over 264 slots: 11 items
    from h = 0 or 11): the first item stages up to three rows, a run
    crossing an image stages rows 0 and 1 at once, and no item restages a
    slot that the item before reads."""
    h_n, items = 22, 128 * 22
    per = -(-items // H100_SLOTS)
    for i0 in range(0, items, per):
        sched = producer_schedule(i0, min(i0 + per, items), h_n)
        for k, (_, rows, slots, _) in enumerate(sched):
            assert len(rows) <= (3 if k == 0 else RAW)
            if k:
                assert not {s for s in sched[k - 1][3] if s >= 0} & \
                    set(slots)


def repack_words(raw, skew, cn, ch0, wt):
    """The producers' repack of a raw row: ``raw`` the buffer's bf16
    elements as uint16 (the row from element ``skew`` on, [wt][cn]), read
    as 32-bit words; per (position p, 8 channels from c = ch0 + 8 j) five
    words from word e // 2 (e = skew + p cn + c, or 0 where c >= cn),
    realigned by byte_perm(w[k], w[k + 1], 0x5432) where e is odd, masked
    from cn.  Returns the slot's [wt][32] channels and the highest element
    read."""
    words = raw[0::2].astype(np.uint32) | (raw[1::2].astype(np.uint32) << 16)
    out = np.zeros((wt, 32), np.uint16)
    top = 0
    for p in range(wt):
        for j in range(4):
            c = ch0 + 8 * j
            left = cn - c
            e = skew + p * cn + c if left > 0 else 0
            w = words[e // 2:e // 2 + 5]
            top = max(top, 2 * (e // 2 + 4) + 1)
            for k in range(4):
                v = w[k] if e % 2 == 0 else (w[k] >> 16) | (w[k + 1] << 16)
                lo = v & 0xffff if 2 * k < left else 0
                hi = v >> 16 if 2 * k + 1 < left else 0
                out[p, 8 * j + 2 * k], out[p, 8 * j + 2 * k + 1] = lo, hi
    return out, top


@pytest.mark.parametrize("cn,ch0", [(51, 0), (51, 32), (38, 32), (64, 32),
                                    (25, 0), (7, 0)])
def test_word_repack_takes_each_tiles_channels(cn, ch0):
    """Each position's channels ch0 .. ch0 + 32 of a raw row at every
    16-byte skew (0 .. 7 elements), zeros from cn: odd starts realigned,
    and no read past the raw buffer's last element but four bytes, which
    land in the next region of shared memory (the next raw row, gy's raw
    row, prow) and are masked."""
    r = np.random.default_rng(cn + ch0)
    wt = 22 * 9
    for skew in range(8):
        n = skew + wt * cn
        size = -(-(2 * n + 43) // 16) * 8 + 8
        raw = r.integers(1, 1 << 16, size).astype(np.uint16)
        got, top = repack_words(raw, skew, cn, ch0, wt)
        want = np.zeros((wt, 32), np.uint16)
        row = raw[skew:n].reshape(wt, cn)[:, ch0:ch0 + 32]
        want[:, :row.shape[1]] = row
        np.testing.assert_array_equal(got, want)
        assert 2 * (top + 1) <= (2 * (wt * cn) + 43) // 16 * 16 + 4


def wgrad_tiles_smem(w, t, c_dec, c_out):
    """Shared-memory bytes of wgrad_tiles_kernel (blk_bwd.cu's
    wgrad_tiles_smem): five d slots, two gy slots, two raw rows of d and
    one of gy, prow and tbl."""
    run_buf = lambda n: (n + 43) // 16 * 16
    wt = w * t
    return (2 * CSP * (RING * (w + 2) * (t + 2) + 2 * npk_of(w, t)) +
            RAW * run_buf(2 * wt * c_dec) + run_buf(2 * wt * c_out) +
            4 * (npk_of(w, t) + 8))


def test_wgrad_tiles_layout_fits_the_routed_rows():
    """At 22 x 9 the 64- and 48-filter widths and 64 -> 64 fit a block's
    232,448 bytes; W = 48 and T = 19 at 64/51 do not and take the
    CUDA-core wgrad, as beyond 64 channels; the flagship's
    wgrad_ring_kernel keeps 103,472."""
    assert wgrad_tiles_smem(22, 9, 51, 64) == 205_568 <= OPTIN
    assert wgrad_tiles_smem(22, 9, 38, 48) == 188_960 <= OPTIN
    assert wgrad_tiles_smem(22, 9, 64, 64) == 215_872 <= OPTIN
    assert wgrad_tiles_smem(48, 9, 51, 64) > OPTIN
    assert wgrad_tiles_smem(22, 19, 51, 64) > OPTIN
    assert wgrad_ring_smem(22, 9, 25, 32) == 103_472
