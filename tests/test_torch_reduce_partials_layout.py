"""The schedule of ``reduce_partials_kernel`` (the last launch of
``blk_bwd`` and ``wide_bwd``), in numpy.

The kernel (probav_tpu_torch/csrc/blk_bwd.cu) sums G float32 partial
slots, ``stride`` floats apart (``tstack.slot_stride``: the slot's length
rounded up to 32), into out[i] = sum over g of part[g][i], i < len.  A
lane owns one float4 column; a column tile is a warp's 32 of them (128
floats).  ``reduce_plan`` (restated in tests/reduce_plan.py) gives the
tiles, the blocks of a cluster (ranks) and the warps of a block; a tile's
G slots are cut into ranks x warps contiguous segments, segment rank *
warps + warp covering slots [seg G / segs, (seg + 1) G / segs).  Each warp
sums its segment in slot order (RED_AHEAD loads issued before their adds),
the warps of a block combine in warp order, the ranks in rank order, and
rank 0 stores the tile's columns below len.  The twin below repeats that
index math and that order, records every load and store, and is held to
``part[:, :len].sum(0)``.  The kernel runs only on the card; this pins
what it reads, what it writes and in which order it sums.

The partials are small integers in float32, so every sum is exact in any
order and the twin must equal the plain sum bit for bit; pad columns (len
up to the stride) and slots the twin must not read hold NaN, so a read of
one that reached a stored value would show.
"""

import re

import numpy as np
import pytest
import torch

import reduce_plan as rp
from probav_tpu_torch.ops import _build
from probav_tpu_torch.ops import tstack as ts

torch.set_num_threads(1)

GROUPS = (1, 7, 132, 264)
LENGTHS = (1, 31, 14_873, 36_505, 147_635)
WIDE_G, WIDE_G1 = 264, 132   # wide_bwd's scratch and its one wave on an H100


def twin(part, length, groups=None, sms=rp.H100_SMS):
    """(out, reads, stores) of the reduce of the first ``groups`` slots of
    part [G, stride] (all by default): out float32 [len] (NaN where never
    stored), reads [G, stride] and stores [stride] the count of loads and
    stores of each float."""
    g_all, stride = part.shape
    groups = g_all if groups is None else groups
    tiles, ranks, warps = rp.plan(groups, length, sms)
    assert stride % 4 == 0 and stride >= length
    p4 = part.reshape(g_all, stride // 4, 4)
    col = np.arange(tiles * 32)                 # float4 columns, tile-major
    live = col < -(-length // 4)
    lcol = col[live]
    reads = np.zeros((g_all, stride // 4), np.uint8)
    segs = ranks * warps
    bsum = []
    for rank in range(ranks):
        wsum = []
        for warp in range(warps):
            seg = rank * warps + warp
            g0, g1 = seg * groups // segs, (seg + 1) * groups // segs
            s = np.zeros((len(lcol), 4), np.float32)
            for g in range(g0, g1, rp.RED_AHEAD):
                batch = range(g, min(g + rp.RED_AHEAD, g1))
                v = [p4[k, lcol] for k in batch]     # issued together
                for k, vk in zip(batch, v):          # added in slot order
                    reads[k, lcol] += 1
                    s += vk
            wsum.append(s)
        t = wsum[0].copy()
        for s in wsum[1:]:
            t += s
        bsum.append(t)
    t = bsum[0].copy()
    for s in bsum[1:]:
        t += s
    idx = (4 * lcol[:, None] + np.arange(4)).reshape(-1)
    keep = idx < length
    out = np.full(length, np.nan, np.float32)
    out[idx[keep]] = t.reshape(-1)[keep]
    stores = np.zeros(stride, np.uint16)
    np.add.at(stores, idx[keep], 1)
    return out, np.repeat(reads, 4, axis=1), stores


def partials(groups, length, seed, written=None):
    """float32 [G, slot_stride(len)]: integers in [-8, 8] in the first
    ``written`` slots' first len columns, NaN elsewhere."""
    written = groups if written is None else written
    part = np.full((groups, ts.slot_stride(length)), np.nan, np.float32)
    r = np.random.default_rng(seed)
    part[:written, :length] = r.integers(-8, 9, (written, length))
    return part


def source_constants():
    text = (_build.SRC_DIR / "blk_bwd.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (RED_\w+) = (\d+);", text)}


def test_the_mirror_holds_the_source_constants():
    assert source_constants() == {
        "RED_TILE": rp.RED_TILE, "RED_AHEAD": rp.RED_AHEAD,
        "RED_MAX_WARPS": rp.RED_MAX_WARPS, "RED_MAX_RANKS": rp.RED_MAX_RANKS,
        "RED_FILL": rp.RED_FILL, "RED_MIN_WARPS": rp.RED_MIN_WARPS,
        "RED_MIN_SEG": rp.RED_MIN_SEG}


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("groups", GROUPS)
def test_twin_sums_every_slot_once_and_stores_only_real_columns(groups,
                                                                length):
    """Bit for bit the plain sum; every float below len of every slot read
    once (those of a straddling float4 up to the next multiple of 4 too,
    none beyond); every column below len stored once, no pad column."""
    part = partials(groups, length, seed=groups + length)
    out, reads, stores = twin(part, length)
    want = ts.reduce_partials_plain(torch.from_numpy(part), length).numpy()
    np.testing.assert_array_equal(out, want)
    cols = -(-length // 4) * 4
    assert (reads[:, :cols] == 1).all()
    assert not reads[:, cols:].any()
    assert (stores[:length] == 1).all() and not stores[length:].any()


@pytest.mark.parametrize("length", (14_873, 36_505))
def test_the_plan_sums_only_the_slots_the_wide_launchers_wrote(length):
    """wide_bwd's tensor-core launchers write G1 = 132 of the 264 slots of
    their scratch (one wave, one block an SM) and hand the reduce G1: it
    reads slots 0..G1-1 alone, and the rest (NaN here) never."""
    part = partials(WIDE_G, length, seed=length, written=WIDE_G1)
    out, reads, _ = twin(part, length, groups=WIDE_G1)
    want = ts.reduce_partials_plain(torch.from_numpy(part[:WIDE_G1]),
                                    length).numpy()
    np.testing.assert_array_equal(out, want)
    assert (reads[:WIDE_G1, :length] == 1).all()
    assert not reads[WIDE_G1:].any()


@pytest.mark.parametrize("groups,length,want", [
    (264, 36_505, (286, 2, 7)),      # blk_bwd at the flagship
    (132, 14_873, (117, 5, 6)),      # wide_bwd's one wave at the flagship
    (132, 589_286, (4604, 1, 4)),    # a slot at 128/1024/102
    (264, 31, (1, 8, 8)), (1, 31, (1, 1, 1)), (7, 1, (1, 1, 1))])
def test_the_plan_at_the_main_paths_shapes(groups, length, want):
    """Tiles x ranks x warps: ~RED_FILL warps an SM where the slots allow
    it, at least RED_MIN_WARPS segments a tile, and at least RED_MIN_SEG
    slots a warp where G does."""
    tiles, ranks, warps = rp.plan(groups, length)
    assert (tiles, ranks, warps) == want
    assert ranks <= rp.RED_MAX_RANKS and warps <= rp.RED_MAX_WARPS
    assert groups < rp.RED_MIN_SEG or groups // (ranks * warps) >= \
        rp.RED_MIN_SEG


def test_slot_stride_is_a_multiple_of_32_at_least_the_length():
    for n in (1, 31, 32, 33, 14_873, 36_505, 147_635, 589_286):
        s = ts.slot_stride(n)
        assert s % 32 == 0 and n <= s < n + 32


def test_reduce_partials_on_cpu_is_the_plain_twin_uncounted():
    part = torch.from_numpy(partials(7, 31, seed=1))
    before = dict(ts.LAUNCHES)
    got = ts.reduce_partials(part, 31)
    assert torch.equal(got, part[:, :31].sum(0))
    assert ts.LAUNCHES == before


def test_the_variants_tool_applies_to_the_source():
    """tools/reduce_variants.py cuts the reduce's section out of
    blk_bwd.cu: every substitution still finds its text, and each variant
    gets its own copy of the kernel and a launch case."""
    from probav_tpu_torch.tools import reduce_variants as rv
    names = list(rv.VARIANTS)
    src = rv.source(names)
    assert src.count("reduce_partials_kernel(const float* __restrict__ "
                     "part,") == len(names)
    for i in range(len(names)):
        assert f"if (v == {i}) {{" in src
    assert "return __ldg(p);" in rv.source(["ldg"])
    assert "RED_AHEAD = 16;" in rv.source(["ahead16"])
    assert "column_kernel<<<" in src
