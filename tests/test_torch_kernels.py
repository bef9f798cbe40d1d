"""The kernel wrappers (probav_tpu_torch/ops/tstack.py, wide_block.py,
shift_table.py): dispatch on the CPU, and the CUDA kernels against their
plain versions on a card; on a card also the cPSNR scorer
(evaluation/compare.py) against itself on the CPU.

This file imports neither JAX nor the JAX package, so the ``cuda`` tests
also run on a machine without them:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from probav_tpu_torch.evaluation.compare import per_scene_cpsnr
from probav_tpu_torch.ops import block_stack as bs
from probav_tpu_torch.ops import shift_table as st
from probav_tpu_torch.ops import tstack as ts
from probav_tpu_torch.ops import wide_block as wb
from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
from probav_tpu_torch.tools.dyadic import (blk_bwd_inputs, shift_table_inputs,
                                           wide_bwd_inputs)
from probav_tpu_torch.tools.time_conv import dwc_float64, seg_fwd_f64
from reduce_plan import plan as reduce_plan
from shift_plan import launch_plan
from test_torch_wgrad_layout import wgrad_ring_smem
from test_torch_wgrad_tiles_layout import wgrad_tiles_smem
from test_torch_wgrad_tf32_layout import wgrad_tf32_smem

torch.set_num_threads(1)

B, H, W, T, C = 4, 5, 6, 3, 8
CMID, CDEC = 16, 7


def params(c, cmid, cdec, seed=3, device="cpu", dtype=torch.float32):
    r = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: torch.from_numpy(
        r.normal(0, sc, s).astype(np.float32)).to(device, dtype)
    return (mk(c, cmid, sc=c ** -0.5), mk(cmid, sc=0.1),
            mk(cmid, cdec, sc=cmid ** -0.5), mk(cdec, sc=0.1),
            mk(3, 3, 3, cdec, c, sc=(27 * cdec) ** -0.5), mk(c, sc=0.1))


def max_rel(got, ref):
    got, ref = got.float().cpu(), ref.float().cpu()
    return float((got - ref).abs().max() / ref.abs().max())


def blk_bwd_routes(dtype, shape, c, cmid, cdec):
    """(seg_bwd route, wgrad route) that blk_bwd's C entry must give for
    rows of shape [B, H, W, T] at these widths: the flagship's tensor-core
    kernels at C, C_dec <= 32 (and C_mid <= 256 for seg_bwd); up to C,
    C_dec <= 64 (C_mid <= 512) seg_bwd_split_kernel and wgrad_tiles_kernel
    at bf16, seg_bwd_tf32_split_kernel and wgrad_tf32_tiles_kernel at
    float32; the wgrads where their rows fit 232,448 bytes; elsewhere the
    CUDA cores."""
    bf = dtype == torch.bfloat16
    w, t = shape[2], shape[3]
    if c <= 32 and cdec <= 32 and cmid <= 256:
        seg = 1 if bf else 2
    elif max(c, cdec) <= 64 and cmid <= 512:
        seg = 3 if bf else 4
    else:
        seg = 0
    if bf and max(c, cdec) <= 32:
        wgrad = 1 if wgrad_ring_smem(w, t, cdec, c) <= 232_448 else 0
    elif bf and max(c, cdec) <= 64:
        wgrad = 3 if wgrad_tiles_smem(w, t, cdec, c) <= 232_448 else 0
    elif not bf and max(c, cdec) <= 64 and wgrad_tf32_smem(w, t) <= 232_448:
        wgrad = 2 if max(c, cdec) <= 32 else 4
    else:
        wgrad = 0
    return ts.SEG_BWD_ROUTES[seg], ts.WGRAD_ROUTES[wgrad]


def assert_blk_bwd_routes(dtype, shape, c, cmid, cdec):
    assert (ts.seg_bwd_route(dtype, c, cmid, cdec),
            ts.wgrad_route(dtype, c, cdec, shape[2], shape[3])) == \
        blk_bwd_routes(dtype, shape, c, cmid, cdec), (dtype, shape, c, cmid,
                                                      cdec)


def test_cpu_tensors_take_the_plain_path_uncounted():
    blocks = [params(C, CMID, CDEC, s) for s in (3, 4)]
    x = torch.randn(B, H, W, T, C, generator=torch.Generator().manual_seed(0))
    before = dict(ts.LAUNCHES)
    got = ts.stack_apply_5d(x, blocks)
    want = x
    for w1, b1, w2, b2, wc, bc in blocks:
        d = ts.seg_fwd_plain(want.reshape(-1, C), w1, b1, w2, b2)
        want = ts.conv_fwd_plain(d.reshape(B, H, W, T, -1), want, wc, bc)
    assert torch.equal(got, want)
    assert ts.LAUNCHES == before


def test_wrappers_refuse_other_devices_without_fallback():
    """A tensor that is neither on the CPU nor on a card raises; it is not
    quietly computed by the plain version."""
    w1, b1, w2, b2, wc, bc = params(C, CMID, CDEC)
    with pytest.raises(ValueError, match="CUDA"):
        ts.seg_fwd(torch.empty((10, C), device="meta"), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="CUDA"):
        ts.conv_fwd(torch.empty((B, H, W, T, CDEC), device="meta"),
                    torch.empty((B, H, W, T, C), device="meta"), wc, bc)
    meta = lambda c: torch.empty((B, H, W, T, c), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ts.blk_bwd(meta(C), meta(C), meta(CDEC), w1, b1, w2, wc)
    rows = lambda c: torch.empty((10, c), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        wb.wide_bwd(rows(C), w1, b1, w2, rows(CDEC))
    plane = torch.empty((2, 12, 12), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        st.shift_table_fwd(plane, plane, plane, 2, False)
    with pytest.raises(ValueError, match="CUDA"):
        st.shift_table_bwd(plane, plane, plane,
                           torch.empty((2, 25), device="meta"), 2, True)


def test_blk_bwd_on_cpu_is_the_plain_twin_uncounted():
    w1, b1, w2, b2, wc, bc = params(C, CMID, CDEC)
    g = torch.Generator().manual_seed(1)
    gy, x = (torch.randn(B, H, W, T, C, generator=g) for _ in range(2))
    d = torch.randn(B, H, W, T, CDEC, generator=g)
    before = dict(ts.LAUNCHES)
    got = ts.blk_bwd(gy, x, d, w1, b1, w2, wc)
    want = ts.blk_bwd_plain(gy, x, d, w1, b1, w2, wc)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ts.LAUNCHES == before


def test_wide_bwd_and_shift_tables_on_cpu_are_the_plain_twins_uncounted():
    x, w1, b1, w2, dy = wide_bwd_inputs(50, C, CMID, CDEC, seed=2)
    hr, m, p, g = shift_table_inputs(3, size=12, border=2, seed=2)
    before = (dict(wb.LAUNCHES), dict(st.LAUNCHES))
    got = wb.wide_bwd(x, w1, b1, w2, dy)
    assert all(torch.equal(a, b) for a, b in
               zip(got, wb.wide_bwd_plain(x, w1, b1, w2, dy)))
    for sq in (False, True):
        assert torch.equal(st.shift_table_fwd(hr, m, p, 2, sq),
                           st.shift_table_fwd_plain(hr, m, p, 2, sq))
        assert torch.equal(st.shift_table_bwd(hr, m, p, g, 2, sq),
                           st.shift_table_bwd_plain(hr, m, p, g, 2, sq))
    assert (dict(wb.LAUNCHES), dict(st.LAUNCHES)) == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,c,cmid,cdec", [
    ((3, 7, 6, 5), 32, 256, 25), ((3, 7, 6, 5), 64, 512, 51),
    ((3, 7, 6, 5), C, CMID, CDEC), ((3, 7, 6, 5), 32, 100, 40),
    ((3, 7, 6, 5), 64, 128, 64), ((3, 7, 6, 5), 25, 100, 32),
    ((2, 1, 6, 5), 32, 256, 25), ((2, 2, 6, 5), 32, 256, 25),
    ((1, 7, 6, 5), 32, 256, 25), ((2, 4, 30, 9), 32, 256, 25),
    ((2, 4, 40, 9), 32, 256, 25), ((1, 3, 48, 9), 32, 256, 25),
    ((1, 3, 100, 9), 32, 256, 25), ((2, 4, 47, 9), 32, 256, 25),
    ((2, 5, 22, 19), 32, 256, 25), ((2, 5, 22, 19), 64, 512, 51),
    ((3, 7, 6, 5), 48, 384, 38), ((3, 7, 6, 5), 72, 576, 57),
    ((3, 7, 6, 5), 128, 1024, 102), ((2, 3, 22, 9), 128, 1024, 102),
    ((2, 5, 22, 19), 128, 1024, 102), ((2, 3, 22, 9), 100, 130, 128)],
    ids=["flagship", "wide", "small", "cmid100", "c64_cdec64", "c25_cdec32",
         "h1", "h2", "b1", "long_row", "longer_row", "w48", "w100",
         "seam_w47", "t19", "wide_t19", "c48", "c72", "c128", "c128_w22",
         "c128_t19", "c100_cdec128"])
def test_kernels_match_plain_on_card(cuda, dtype, tol, shape, c, cmid, cdec):
    """Flagship and 64-filter widths, the CPU tests' small widths, a c_mid
    that is not a multiple of the staging chunk, and every width bucket of
    the conv (c_dec -> C: 25 -> 32, 51 -> 64, 64 -> 64, 32 -> 25, 40 -> 32);
    a ragged volume (7x6x5) and a row count that is not a multiple of the
    tile.  At the flagship widths also the conv ring's edges: one and two h
    rows, one patch, whole rows of 270 positions (17 m-tiles: two passes of
    the block's warps at bf16), and rows cut into column runs: W = 40, 48
    and 100 (float32 from W = 22 on), W = 47, whose runs leave a shorter
    one at the row's end at both dtypes, and T = 19, where the 64-filter
    widths stage their weights 3 taps at a time.  Beyond 64 channels: the
    48-, 72- and 128-filter widths (C_mid = 8 C, C_dec = 0.8 C; seg_fwd
    in bf16 stages C_mid in chunks at 128/1024, the conv's outputs beyond
    64 take a second tile, in float32 at T = 19 tiles of 32), and a C that
    is no multiple of 32 with 128 decay channels.  The backward's routes
    at the same widths and rows are those ``blk_bwd_routes`` gives (at bf16
    the 64- and 48-filter widths on the tensor cores)."""
    assert_blk_bwd_routes(dtype, shape, c, cmid, cdec)
    w1, b1, w2, b2, wc, bc = params(c, cmid, cdec, device=cuda, dtype=dtype)
    x = torch.randn(*shape, c, device=cuda).to(dtype)
    x2 = x.reshape(-1, c)
    before = dict(ts.LAUNCHES)
    d = ts.seg_fwd(x2, w1, b1, w2, b2)
    assert max_rel(d, ts.seg_fwd_plain(x2, w1, b1, w2, b2)) < tol
    d5 = d.reshape(x.shape[:-1] + (cdec,))
    out = ts.conv_fwd(d5, x, wc, bc)
    assert out.dtype == dtype
    assert max_rel(out, ts.conv_fwd_plain(d5, x, wc, bc)) < tol
    assert ts.LAUNCHES["seg_fwd"] == before["seg_fwd"] + 1
    assert ts.LAUNCHES["conv_fwd"] == before["conv_fwd"] + 1


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs_on_card(cuda):
    from probav_tpu_torch.ops import _build
    w1, b1, w2, b2, wc, bc = params(C, CMID, CDEC, device=cuda)
    x = torch.randn(20, C, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ts.seg_fwd(x.t().contiguous().t(), w1, b1, w2, b2)
    with pytest.raises(TypeError):
        ts.seg_fwd(x.half(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="shapes"):
        ts.seg_fwd(x, w1[:4], b1, w2, b2)
    # 72 channels, beyond the kernels' former limit of 64, launch and match
    # plain.
    big = params(72, CMID, CDEC, device=cuda)
    x72 = torch.randn(20, 72, device=cuda)
    assert max_rel(ts.seg_fwd(x72, *big[:4]),
                   ts.seg_fwd_plain(x72, *big[:4])) < 2e-5
    # 48 channels, which do not divide 128: blk_bwd launches and matches.
    args = blk_bwd_inputs((1, 2, 3, 5), 48, CMID, 38, seed=2, device=cuda)
    before = ts.LAUNCHES["blk_bwd"]
    got = ts.blk_bwd(*args)
    assert ts.LAUNCHES["blk_bwd"] == before + 1
    for name, a, b in zip(BWD_NAMES, got, ts.blk_bwd_plain(*args)):
        assert max_rel(a, b) < blk_bwd_tolerances(torch.float32)[name], name
    # A bf16 conv with c_dec 72 > 64 runs every channel.
    wide = params(32, CMID, 72, device=cuda, dtype=torch.bfloat16)
    xb = torch.randn(1, 3, 6, 5, 32, device=cuda).bfloat16()
    db = torch.randn(1, 3, 6, 5, 72, device=cuda).bfloat16()
    assert max_rel(ts.conv_fwd(db, xb, wide[4], wide[5]),
                   ts.conv_fwd_plain(db, xb, wide[4], wide[5])) < 2e-2
    # A row of 100x9 positions, refused before the conv ring took column
    # runs, runs at both dtypes.
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        flag = params(32, 256, 25, device=cuda, dtype=dtype)
        xb = torch.randn(1, 3, 100, 9, 32, device=cuda).to(dtype)
        db = torch.randn(1, 3, 100, 9, 25, device=cuda).to(dtype)
        assert max_rel(ts.conv_fwd(db, xb, flag[4], flag[5]),
                       ts.conv_fwd_plain(db, xb, flag[4], flag[5])) < tol
    # 136 channels, beyond the envelope: refused by each wrapper before it
    # launches, and by each C entry point (which never launches).
    before = dict(ts.LAUNCHES), dict(wb.LAUNCHES)
    w136 = params(136, CMID, 108, device=cuda)
    v136 = torch.randn(1, 2, 3, 5, 136, device=cuda)
    d108 = torch.randn(1, 2, 3, 5, 108, device=cuda)
    with pytest.raises(ValueError, match="from 1 to 128"):
        ts.seg_fwd(v136.reshape(-1, 136), *w136[:4])
    with pytest.raises(ValueError, match="from 1 to 128"):
        ts.conv_fwd(d108, v136, w136[4], w136[5])
    with pytest.raises(ValueError, match="from 1 to 128"):
        ts.blk_bwd(v136, v136, d108, *w136[:3], w136[4])
    with pytest.raises(ValueError, match="from 1 to 128"):
        wb.wide_bwd(v136.reshape(-1, 136), *w136[:3], d108.reshape(-1, 108))
    assert (dict(ts.LAUNCHES), dict(wb.LAUNCHES)) == before
    lib, p, s = _build.library(), v136.data_ptr(), ts._stream(v136)
    n = 30
    assert lib.probav_seg_fwd(0, p, p, p, p, p, p, n, 136, CMID, 108, s) != 0
    assert lib.probav_conv_fwd(0, p, p, p, p, p, 1, 2, 3, 5, 108, 136,
                               s) != 0
    stride = ts.slot_stride(27 * 108 * 136 + 136 * CMID + CMID * 108 + CMID
                            + 108 + 136)
    assert lib.probav_blk_bwd(0, *[p] * 12, 1, stride, 1, 2, 3, 5, 136, CMID,
                              108, s) != 0
    stride = ts.slot_stride(136 * CMID + CMID * 108 + CMID + 108)
    assert lib.probav_wide_bwd(0, *[p] * 8, 1, stride, n, 136, CMID, 108,
                               s) != 0
    torch.cuda.synchronize()
    # Beyond the T envelope of the widest bucket (one column at T = 21 over
    # shared memory in float32 at 128 -> 128 channels) the launch is
    # refused, never run; T = 20 runs.
    deep = params(128, CMID, 128, device=cuda)
    for t in (20, 21):
        d5 = torch.randn(1, 2, 3, t, 128, device=cuda)
        x5 = torch.randn(1, 2, 3, t, 128, device=cuda)
        if t == 20:
            assert max_rel(ts.conv_fwd(d5, x5, deep[4], deep[5]),
                           ts.conv_fwd_plain(d5, x5, deep[4], deep[5])) < 2e-5
            continue
        before = ts.LAUNCHES["conv_fwd"]
        with pytest.raises(RuntimeError, match="conv_fwd"):
            ts.conv_fwd(d5, x5, deep[4], deep[5])
        assert ts.LAUNCHES["conv_fwd"] == before


@pytest.mark.cuda
def test_bf16_conv_fwd_on_card_takes_views_at_any_alignment(cuda):
    """d and x as contiguous views 1 and 3 elements into larger buffers:
    their rows start off the 16-byte grid and x's lines up with no chunk
    of out's, so the copies start below the rows and out is stored
    element by element."""
    w1, b1, w2, b2, wc, bc = params(32, 256, 25, device=cuda,
                                    dtype=torch.bfloat16)
    shape = (2, 5, 22, 9)
    n = 2 * 5 * 22 * 9
    d = torch.randn(n * 25 + 1, device=cuda).bfloat16()[1:].view(*shape, 25)
    x = torch.randn(n * 32 + 3, device=cuda).bfloat16()[3:].view(*shape, 32)
    out = ts.conv_fwd(d, x, wc, bc)
    assert max_rel(out, ts.conv_fwd_plain(d, x, wc, bc)) < 2e-2


@pytest.mark.cuda
def test_f32_conv_fwd_on_card_takes_views_at_any_alignment(cuda):
    """float32 d and x as contiguous views 1 and 3 elements into larger
    buffers, on rows cut into column runs (W = 48: runs of 10 and 8
    columns): every run's span starts off the 16-byte grid, and x's lines
    up with no chunk of out's, so out is stored element by element."""
    w1, b1, w2, b2, wc, bc = params(32, 256, 25, device=cuda)
    shape = (2, 5, 48, 9)
    n = 2 * 5 * 48 * 9
    d = torch.randn(n * 25 + 1, device=cuda)[1:].view(*shape, 25)
    x = torch.randn(n * 32 + 3, device=cuda)[3:].view(*shape, 32)
    out = ts.conv_fwd(d, x, wc, bc)
    assert max_rel(out, ts.conv_fwd_plain(d, x, wc, bc)) < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128 * 4356, 1, 127, 129, 1000],
                         ids=["n557568", "n1", "n127", "n129", "n1000"])
@pytest.mark.parametrize("c,cmid,cdec,route", [
    (32, 256, 25, "seg_fwd_tf32_kernel"), (7, 100, 12, "seg_fwd_tf32_kernel"),
    (32, 257, 25, "seg_fwd_tf32_wide_kernel"),
    (48, 384, 38, "seg_fwd_tf32_wide_kernel"),
    (64, 512, 51, "seg_fwd_tf32_wide_kernel"),
    (65, 512, 51, "seg_fwd_kernel"), (64, 520, 51, "seg_fwd_kernel")],
    ids=["flagship", "c7", "cmid257", "c48", "c64", "c65", "cmid520"])
def test_f32_seg_fwd_routes_match_plain_on_card(cuda, n, c, cmid, cdec,
                                                route):
    """float32 seg_fwd within the tensor cores' widths (C, C_dec <= 32,
    C_mid <= 256) takes the 3xTF32 kernel, C_mid 257 and 48 and 64
    channels (up to C, C_dec <= 64 and C_mid <= 512) the 3xTF32 kernel
    with C_mid in chunks, 65 channels and C_mid 520 the CUDA-core one: all
    within 2e-5 of max|ref| of plain, at the flagship's N, one row, rows
    either side of a 128-row tile and a ragged count; each call counted
    once, and two calls bit for bit equal."""
    assert ts.seg_fwd_route(torch.float32, c, cmid, cdec).startswith(route)
    w1, b1, w2, b2, _, _ = params(c, cmid, cdec, seed=n % 7, device=cuda)
    x = torch.from_numpy(np.random.default_rng(n).normal(
        size=(n, c)).astype(np.float32)).to(cuda)
    before = ts.LAUNCHES["seg_fwd"]
    d = ts.seg_fwd(x, w1, b1, w2, b2)
    again = ts.seg_fwd(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert ts.LAUNCHES["seg_fwd"] == before + 2
    assert d.shape == (n, cdec) and d.dtype == torch.float32
    assert max_rel(d, ts.seg_fwd_plain(x, w1, b1, w2, b2)) < 2e-5
    assert torch.equal(d, again)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128 * 4356, 1, 127, 129, 1000],
                         ids=["n557568", "n1", "n127", "n129", "n1000"])
@pytest.mark.parametrize("c,cmid,cdec,route", [
    (32, 256, 25, "seg_fwd_bf16_kernel"), (7, 100, 12, "seg_fwd_bf16_kernel"),
    (32, 256, 32, "seg_fwd_bf16_kernel"),
    (32, 257, 25, "seg_fwd_bf16_wide_kernel"),
    (48, 384, 38, "seg_fwd_bf16_wide_kernel"),
    (64, 512, 51, "seg_fwd_bf16_wide_kernel"),
    (37, 300, 45, "seg_fwd_bf16_wide_kernel"),
    (33, 100, 57, "seg_fwd_bf16_wide_kernel"),
    (65, 512, 51, "seg_fwd_mma_kernel"), (64, 520, 51, "seg_fwd_mma_kernel")],
    ids=["flagship", "c7", "cdec32", "cmid257", "c48", "c64", "c37", "cdec57",
         "c65", "cmid520"])
def test_bf16_seg_fwd_routes_match_plain_on_card(cuda, n, c, cmid, cdec,
                                                 route):
    """bf16 seg_fwd within the tensor-core tiles' widths (C, C_dec <= 32,
    C_mid <= 256) takes seg_fwd_bf16_kernel (at C = 7 on plain copies of
    x); up to C, C_dec <= 64 and C_mid <= 512 seg_fwd_bf16_wide_kernel
    (C_mid 257, the 48- and 64-filter widths, C = 37 on plain copies with
    C_mid 300 cut inside a step, C_dec 57 on eight n-tiles); 65 channels
    and C_mid 520 seg_fwd_mma_kernel: all within 2e-2 of max|ref| of
    plain, the bf16 tolerance, at the flagship's N, one row, rows either
    side of a 128-row tile and a ragged count (ragged 256- and 384-row
    tiles and warps with no row); each call counted once, and two calls
    bit for bit equal."""
    assert ts.seg_fwd_route(torch.bfloat16, c, cmid, cdec).startswith(route)
    w1, b1, w2, b2, _, _ = params(c, cmid, cdec, seed=n % 7, device=cuda,
                                  dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(n).normal(
        size=(n, c)).astype(np.float32)).to(cuda, torch.bfloat16)
    before = ts.LAUNCHES["seg_fwd"]
    d = ts.seg_fwd(x, w1, b1, w2, b2)
    again = ts.seg_fwd(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert ts.LAUNCHES["seg_fwd"] == before + 2
    assert d.shape == (n, cdec) and d.dtype == torch.bfloat16
    assert max_rel(d, ts.seg_fwd_plain(x, w1, b1, w2, b2)) < 2e-2
    assert torch.equal(d, again)


@pytest.mark.cuda
def test_seg_fwd_routes_on_card(cuda):
    """Up to 32/256/32 bf16 takes seg_fwd_bf16_kernel and float32 the
    3xTF32 kernel; beyond any of those widths, up to 64/512/64, bf16 takes
    seg_fwd_bf16_wide_kernel and float32 the 3xTF32 kernel with C_mid in
    chunks; beyond that bf16 seg_fwd_mma_kernel and float32 the CUDA-core
    kernel."""
    for widths in ((32, 256, 25), (1, 1, 1), (32, 256, 32), (33, 256, 25),
                   (32, 257, 25), (32, 256, 33), (64, 512, 64),
                   (65, 512, 51), (64, 513, 51), (64, 512, 65),
                   (128, 1024, 102)):
        tc = widths[0] <= 32 and widths[1] <= 256 and widths[2] <= 32
        wide = widths[0] <= 64 and widths[1] <= 512 and widths[2] <= 64
        assert ts.seg_fwd_route(torch.bfloat16, *widths) == \
            ts.SEG_FWD_ROUTES[3 if tc else 5 if wide else 1], widths
        assert ts.seg_fwd_route(torch.float32, *widths) == \
            ts.SEG_FWD_ROUTES[2 if tc else 4 if wide else 0], widths


@pytest.mark.cuda
@pytest.mark.parametrize("c,offset", [(32, 1), (32, 4), (7, 3), (25, 2),
                                      (64, 1), (64, 4), (37, 3)],
                         ids=["c32_off1", "c32_off4", "c7_off3", "c25_off2",
                              "c64_off1", "c64_off4", "c37_off3"])
def test_f32_seg_fwd_on_card_takes_views_at_any_alignment(cuda, c, offset):
    """x as a contiguous view `offset` floats into a larger buffer: off
    the 16-byte grid (4-byte copies) or on it (16-byte copies where C is a
    multiple of 4), at 1,000 rows; at C = 37 and 64 on the kernel that
    stages C_mid in chunks."""
    n = 1000
    w1, b1, w2, b2, _, _ = params(c, 256, 25, device=cuda)
    x = torch.randn(n * c + offset, device=cuda)[offset:].view(n, c)
    d = ts.seg_fwd(x, w1, b1, w2, b2)
    assert max_rel(d, ts.seg_fwd_plain(x, w1, b1, w2, b2)) < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("c,offset", [(32, 1), (32, 4), (32, 8), (8, 1),
                                      (7, 3), (64, 1), (64, 8), (48, 5),
                                      (37, 3)],
                         ids=["c32_off1", "c32_off4", "c32_off8", "c8_off1",
                              "c7_off3", "c64_off1", "c64_off8", "c48_off5",
                              "c37_off3"])
def test_bf16_seg_fwd_on_card_takes_views_at_any_alignment(cuda, c, offset):
    """bf16 x as a contiguous view `offset` elements into a larger buffer:
    off the 16-byte grid (plain copies) or on it (16-byte cp.async where C
    is a multiple of 8), at 1,000 rows: on seg_fwd_bf16_kernel up to 32
    channels (32/256/25), on seg_fwd_bf16_wide_kernel beyond (C/512/51)."""
    cmid, cdec = (256, 25) if c <= 32 else (512, 51)
    assert ts.seg_fwd_route(torch.bfloat16, c, cmid, cdec).startswith(
        "seg_fwd_bf16_kernel" if c <= 32 else "seg_fwd_bf16_wide_kernel")
    n = 1000
    w1, b1, w2, b2, _, _ = params(c, cmid, cdec, device=cuda,
                                  dtype=torch.bfloat16)
    x = torch.randn(n * c + offset, device=cuda).bfloat16()[offset:] \
        .view(n, c)
    d = ts.seg_fwd(x, w1, b1, w2, b2)
    assert max_rel(d, ts.seg_fwd_plain(x, w1, b1, w2, b2)) < 2e-2


@pytest.mark.cuda
def test_f32_seg_fwd_on_random_normal_inputs_is_within_1e5_of_float64(cuda):
    """The 3xTF32 seg_fwd at the flagship's N and widths on random-normal
    x and weights (numpy seed 12): within 1e-5 of max|ref| of float64.  The
    products drop lo_a lo_b (~2**-22 each) and the tensor cores sum each
    64-channel chunk's decay products with truncation before the float32
    running sums."""
    assert ts.seg_fwd_route(torch.float32, 32, 256, 25).startswith(
        "seg_fwd_tf32_kernel")
    w1, b1, w2, b2, _, _ = params(32, 256, 25, seed=12, device=cuda)
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(128 * 4356, 32)).astype(np.float32)).to(cuda)
    ref = seg_fwd_f64(x, w1, b1, w2, b2)
    got = ts.seg_fwd(x, w1, b1, w2, b2).double()
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= 1e-5, err


# blk_bwd outputs: dx, dwc, dw1, db1, dw2, db2, dbc.
BWD_NAMES = ("dx", "dwc", "dw1", "db1", "dw2", "db2", "dbc")


def blk_bwd_tolerances(dtype):
    """On the dyadic inputs (probav_tpu_torch/tools/dyadic.py) both
    versions take the same relu and bf16-rounding decisions, so what
    differs is summation order: dx 2e-5 of max|ref| at float32, one bf16
    step (2**-8) plus margin at bf16, where dx is stored in bf16; the
    weight grads, float32 sums of identical operands over every row in
    another order, 1e-4 at both dtypes."""
    dx = 2e-5 if dtype == torch.float32 else 8e-3
    return {n: (dx if n == "dx" else 1e-4) for n in BWD_NAMES}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,c,cmid,cdec", [
    ((3, 7, 6, 5), C, CMID, CDEC), ((3, 7, 6, 5), 32, 100, 40),
    ((2, 22, 22, 9), 32, 256, 25), ((2, 22, 22, 9), 64, 512, 51),
    ((128, 22, 22, 9), 32, 256, 25), ((3, 7, 6, 5), 48, 384, 38),
    ((3, 7, 6, 5), 72, 576, 57), ((3, 7, 6, 5), 128, 1024, 102),
    ((2, 4, 48, 9), 128, 1024, 102), ((2, 3, 22, 9), 100, 130, 128)],
    ids=["small", "cmid100", "flagship_b2", "wide_b2", "flagship_b128",
         "c48", "c72", "c128", "c128_w48", "c100_cdec128"])
def test_blk_bwd_matches_plain_on_card(cuda, dtype, shape, c, cmid, cdec):
    """Beyond 64 channels the CUDA-core kernels at both dtypes, dWc in
    tiles of 64 x 64 channels, and at W = 48 (128/1024/102) in runs of
    columns; the 64- and 48-filter widths take seg_bwd_split_kernel and
    wgrad_tiles_kernel at bf16, seg_bwd_tf32_split_kernel and
    wgrad_tf32_tiles_kernel at float32 (``blk_bwd_routes``)."""
    assert_blk_bwd_routes(dtype, shape, c, cmid, cdec)
    gy, x, d, w1, b1, w2, wc = blk_bwd_inputs(shape, c, cmid, cdec, seed=5,
                                              device=cuda, dtype=dtype)
    before = ts.LAUNCHES["blk_bwd"]
    got = ts.blk_bwd(gy, x, d, w1, b1, w2, wc)
    torch.cuda.synchronize()
    assert ts.LAUNCHES["blk_bwd"] == before + 1
    want = ts.blk_bwd_plain(gy, x, d, w1, b1, w2, wc)
    tol = blk_bwd_tolerances(dtype)
    assert got[0].dtype == dtype
    for name, a, b in zip(BWD_NAMES, got, want):
        assert a.shape == b.shape, name
        assert max_rel(a, b) < tol[name], (name, max_rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,cmid,cdec,route", [
    ((2, 22, 22, 9), 32, 256, 25, "seg_bwd_tf32_kernel"),
    ((3, 7, 6, 5), 8, 64, 6, "seg_bwd_tf32_kernel"),
    ((3, 7, 6, 5), 24, 200, 19, "seg_bwd_tf32_kernel"),
    ((2, 22, 22, 9), 32, 256, 32, "seg_bwd_tf32_kernel"),
    ((1, 3, 5, 7), 32, 256, 25, "seg_bwd_tf32_kernel"),
    ((3, 7, 6, 5), 33, 256, 25, "seg_bwd_tf32_split_kernel"),
    ((128, 22, 22, 9), 64, 512, 51, "seg_bwd_tf32_split_kernel"),
    ((3, 7, 6, 5), 48, 384, 38, "seg_bwd_tf32_split_kernel"),
    ((3, 7, 6, 5), 36, 300, 64, "seg_bwd_tf32_split_kernel"),
    ((2, 3, 6, 5), 64, 512, 51, "seg_bwd_tf32_split_kernel"),
    ((3, 7, 6, 5), 65, 256, 25, "seg_bwd_kernel"),
    ((3, 7, 6, 5), 64, 520, 51, "seg_bwd_kernel")],
    ids=["flagship", "c8", "cmid200", "cdec32", "rows105", "c33",
         "c64_b128", "c48", "c36_cdec64", "bh_below_g_c64", "c65",
         "cmid520"])
def test_f32_blk_bwd_seg_bwd_routes_match_plain_on_card(cuda, shape, c, cmid,
                                                        cdec, route):
    """float32 within the flagship's widths takes the 3xTF32 seg_bwd (c_mid
    200: a chunk of 64 cut short; 105 rows: less than a tile); beyond, up
    to C, C_dec <= 64 and C_mid <= 512, seg_bwd_tf32_split_kernel: 33
    channels, the 64-filter widths at batch 128 and on 180 rows (three
    tiles for 264 slots), the 48-filter widths (three chunks of 128),
    36/300/64 (x copied by 4-byte copies, a last chunk of 44 j); 65
    channels and C_mid 520 the CUDA-core one.  All match plain on the
    dyadic inputs to the float32 tolerances, and two calls agree bit for
    bit."""
    assert ts.seg_bwd_route(torch.float32, c, cmid, cdec).startswith(route)
    args = blk_bwd_inputs(shape, c, cmid, cdec, seed=7, device=cuda)
    got = ts.blk_bwd(*args)
    again = ts.blk_bwd(*args)
    torch.cuda.synchronize()
    want = ts.blk_bwd_plain(*args)
    tol = blk_bwd_tolerances(torch.float32)
    for name, a, a2, b in zip(BWD_NAMES, got, again, want):
        assert a.shape == b.shape, name
        assert max_rel(a, b) < tol[name], (name, max_rel(a, b))
        assert torch.equal(a, a2), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,cmid,cdec,route", [
    ((128, 22, 22, 9), 32, 256, 25, "seg_bwd_bf16_kernel"),
    ((3, 7, 6, 5), 8, 64, 6, "seg_bwd_bf16_kernel"),
    ((3, 7, 6, 5), 24, 200, 19, "seg_bwd_bf16_kernel"),
    ((2, 22, 22, 9), 32, 256, 32, "seg_bwd_bf16_kernel"),
    ((1, 3, 5, 7), 32, 256, 25, "seg_bwd_bf16_kernel"),
    ((3, 7, 6, 5), 33, 256, 25, "seg_bwd_split_kernel"),
    ((128, 22, 22, 9), 64, 512, 51, "seg_bwd_split_kernel"),
    ((3, 7, 6, 5), 48, 384, 38, "seg_bwd_split_kernel"),
    ((3, 7, 6, 5), 36, 300, 64, "seg_bwd_split_kernel"),
    ((2, 3, 6, 5), 64, 512, 51, "seg_bwd_split_kernel"),
    ((3, 7, 6, 5), 65, 256, 25, "seg_bwd_kernel"),
    ((3, 7, 6, 5), 64, 520, 51, "seg_bwd_kernel")],
    ids=["flagship_b128", "c8", "cmid200", "cdec32", "rows105", "c33",
         "c64_b128", "c48", "c36_cdec64", "bh_below_g_c64", "c65",
         "cmid520"])
def test_bf16_blk_bwd_seg_bwd_routes_match_plain_on_card(cuda, shape, c, cmid,
                                                         cdec, route):
    """bf16 within the tensor cores' widths takes seg_bwd_bf16_kernel: the
    flagship at batch 128, 8/64/6 (two warps' middle channels real, six
    warps' all padding), c_mid 200 (a warp's channels cut short), c_dec 32
    (dd rows of 64 bytes), 105 rows (less than a tile); beyond, up to C,
    C_dec <= 64 and C_mid <= 512, seg_bwd_split_kernel: 33 channels, the
    64-filter widths at batch 128 and on 180 rows (three tiles for 264
    slots), the 48-filter widths (a second chunk half padding), 36/300/64
    (x copied by elements, 64 decay channels); 65 channels and C_mid 520
    take the CUDA-core seg_bwd.  All match plain on the dyadic inputs to
    the bf16 tolerances, and two calls agree bit for bit."""
    assert ts.seg_bwd_route(torch.bfloat16, c, cmid, cdec).startswith(route)
    args = blk_bwd_inputs(shape, c, cmid, cdec, seed=9, device=cuda,
                          dtype=torch.bfloat16)
    got = ts.blk_bwd(*args)
    again = ts.blk_bwd(*args)
    torch.cuda.synchronize()
    want = ts.blk_bwd_plain(*args)
    tol = blk_bwd_tolerances(torch.bfloat16)
    for name, a, a2, b in zip(BWD_NAMES, got, again, want):
        assert a.shape == b.shape, name
        assert max_rel(a, b) < tol[name], (name, max_rel(a, b))
        assert torch.equal(a, a2), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,cmid,cdec,route", [
    ((128, 22, 22, 9), 32, 256, 25, "wgrad_ring_kernel (bf16 mma)"),
    ((3, 7, 6, 5), 8, 64, 6, "wgrad_ring_kernel (bf16 mma)"),
    ((2, 4, 48, 9), 32, 256, 25, "wgrad_ring_kernel (bf16 mma)"),
    ((2, 5, 22, 19), 32, 256, 25, "wgrad_ring_kernel (bf16 mma)"),
    ((2, 3, 6, 5), 32, 256, 25, "wgrad_ring_kernel (bf16 mma)"),
    ((2, 22, 22, 9), 32, 256, 32, "wgrad_ring_kernel (bf16 mma)"),
    ((3, 7, 6, 5), 33, 256, 25, "wgrad_tiles_kernel"),
    ((128, 22, 22, 9), 64, 512, 51, "wgrad_tiles_kernel"),
    ((2, 4, 22, 9), 48, 384, 38, "wgrad_tiles_kernel"),
    ((2, 3, 6, 5), 64, 512, 51, "wgrad_tiles_kernel"),
    ((2, 2, 48, 9), 64, 512, 51, "wgrad_kernel"),
    ((3, 7, 6, 5), 65, 256, 25, "wgrad_kernel")],
    ids=["flagship_b128", "small", "w48", "t19", "bh_below_g", "cdec32",
         "c33", "c64_b128", "c48", "bh_below_g_c64", "c64_w48", "c65"])
def test_bf16_blk_bwd_wgrad_routes_match_plain_on_card(cuda, shape, c, cmid,
                                                       cdec, route):
    """bf16 dWc at C, C_dec <= 32 takes the tensor-core wgrad: the
    flagship at batch 128, 8/64/6, W = 48 and T = 19 (the largest layouts
    it holds), B*H = 6 items for the partial slots' 264 or more blocks
    (every slot written), c_dec = c_out = 32; up to 64 channels
    wgrad_tiles_kernel: 33 channels, the 64-filter widths at batch 128 and
    on 6 items, the 48-filter widths; W = 48 at 64/51 (rows beyond its
    layout) and 65 channels take the CUDA-core wgrad.  All match plain on the
    dyadic inputs to the bf16 tolerances, and two calls agree bit for
    bit."""
    assert ts.wgrad_route(torch.bfloat16, c, cdec, shape[2],
                          shape[3]).startswith(route)
    args = blk_bwd_inputs(shape, c, cmid, cdec, seed=8, device=cuda,
                          dtype=torch.bfloat16)
    got = ts.blk_bwd(*args)
    again = ts.blk_bwd(*args)
    torch.cuda.synchronize()
    want = ts.blk_bwd_plain(*args)
    tol = blk_bwd_tolerances(torch.bfloat16)
    for name, a, a2, b in zip(BWD_NAMES, got, again, want):
        assert a.shape == b.shape, name
        assert max_rel(a, b) < tol[name], (name, max_rel(a, b))
        assert torch.equal(a, a2), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,cmid,cdec,route", [
    ((128, 22, 22, 9), 32, 256, 25, "wgrad_tf32_kernel"),
    ((3, 7, 6, 5), 8, 64, 6, "wgrad_tf32_kernel"),
    ((2, 4, 48, 9), 32, 256, 25, "wgrad_kernel"),
    ((2, 5, 22, 19), 32, 256, 25, "wgrad_kernel"),
    ((2, 3, 6, 5), 32, 256, 25, "wgrad_tf32_kernel"),
    ((2, 22, 22, 9), 32, 256, 32, "wgrad_tf32_kernel"),
    ((3, 7, 6, 5), 30, 64, 6, "wgrad_tf32_kernel"),
    ((3, 7, 6, 5), 33, 256, 25, "wgrad_tf32_tiles_kernel"),
    ((128, 22, 22, 9), 64, 512, 51, "wgrad_tf32_tiles_kernel"),
    ((2, 4, 22, 9), 48, 384, 38, "wgrad_tf32_tiles_kernel"),
    ((2, 3, 6, 5), 64, 512, 51, "wgrad_tf32_tiles_kernel"),
    ((2, 2, 48, 9), 64, 512, 51, "wgrad_kernel"),
    ((3, 7, 6, 5), 65, 256, 25, "wgrad_kernel")],
    ids=["flagship_b128", "small", "w48", "t19", "bh_below_g", "cdec32",
         "c30", "c33", "c64_b128", "c48", "bh_below_g_c64", "c64_w48",
         "c65"])
def test_f32_blk_bwd_wgrad_routes_match_plain_on_card(cuda, shape, c, cmid,
                                                      cdec, route):
    """float32 dWc at C, C_dec <= 32 takes the 3xTF32 wgrad where its rows
    fit shared memory: the flagship at batch 128, 8/64/6, B*H = 6 items
    for the partial slots' 264 or more blocks (every slot written), c_dec
    = c_out = 32, 30 channels (4-byte copies of gy); W = 48, T = 19 (rows
    beyond its layout) take the CUDA-core wgrad.  Up to 64 channels
    wgrad_tf32_tiles_kernel: 33 channels, the 64-filter widths at batch 128
    and on 6 items, the 48-filter widths; W = 48 at 64/51 (rows beyond its
    layout) and 65 channels take the CUDA-core wgrad.  All match plain on
    the dyadic inputs to the float32 tolerances, and two calls agree bit
    for bit."""
    assert ts.wgrad_route(torch.float32, c, cdec, shape[2],
                          shape[3]).startswith(route)
    args = blk_bwd_inputs(shape, c, cmid, cdec, seed=8, device=cuda)
    got = ts.blk_bwd(*args)
    again = ts.blk_bwd(*args)
    torch.cuda.synchronize()
    want = ts.blk_bwd_plain(*args)
    tol = blk_bwd_tolerances(torch.float32)
    for name, a, a2, b in zip(BWD_NAMES, got, again, want):
        assert a.shape == b.shape, name
        assert max_rel(a, b) < tol[name], (name, max_rel(a, b))
        assert torch.equal(a, a2), name


@pytest.mark.cuda
def test_f32_wgrad_on_random_normal_inputs_is_within_1e5_of_float64(cuda):
    """The 3xTF32 wgrad at the flagship, batch 128, on random-normal d and
    gy (numpy seed 12): dWc within 1e-5 of max|ref| of a float64 dWc.  The
    products drop lo_a lo_b (~2**-22 each) and the tensor cores sum each
    item's products with truncation before the float32 running sums."""
    assert ts.wgrad_route(torch.float32, 32, 25, 22, 9).startswith(
        "wgrad_tf32_kernel")
    r = np.random.default_rng(12)
    shape = (128, 22, 22, 9)
    mk = lambda *s, sc=1.0: torch.from_numpy(
        (r.normal(size=s) * sc).astype(np.float32)).to(cuda)
    gy, x, d = mk(*shape, 32), mk(*shape, 32), mk(*shape, 25)
    w1, b1, w2, b2, wc, bc = params(32, 256, 25, seed=12, device=cuda)
    got = ts.blk_bwd(gy, x, d, w1, b1, w2, wc)[1]
    ref = dwc_float64(d, gy)
    err = float((got.double() - ref).abs().max() / ref.abs().max())
    assert err <= 1e-5, err


@pytest.mark.cuda
def test_stack_autograd_on_card_matches_plain_stack(cuda):
    """Gradients through the kernel stack's autograd node against autograd
    through the plain blocks, float32, 3 blocks, on inputs drawn from a
    seeded numpy generator.  Compared leaf by leaf norm-wise, as the flat
    stack's test below: past the first block z is no dyadic value, and a
    relu derivative that flips between the two forwards' summation orders
    moves one element by a whole dz, which an elementwise bound reads as a
    failure and a norm does not."""
    blocks = [tuple(t.requires_grad_() for t in params(
        32, 256, 25, seed=s, device=cuda)) for s in (3, 4, 5)]
    r = np.random.default_rng(8)
    x = torch.from_numpy(r.normal(size=(2, 9, 8, 9, 32)).astype(
        np.float32)).to(cuda).requires_grad_()
    y = ts.stack_apply_5d(x, blocks)
    gy = torch.from_numpy(r.normal(size=tuple(y.shape)).astype(
        np.float32)).to(cuda)
    leaves = [x] + [t for blk in blocks for t in blk]
    got = torch.autograd.grad(y, leaves, gy)
    ref = x
    for w1, b1, w2, b2, wc, bc in blocks:
        d = ts.seg_fwd_plain(ref.reshape(-1, 32), w1, b1, w2, b2)
        ref = ts.conv_fwd_plain(d.reshape(ref.shape[:-1] + (25,)), ref, wc,
                                bc)
    want = torch.autograd.grad(ref, leaves, gy)
    for a, b in zip(got, want):
        assert rel_l2(a, b) < 1e-4


def wide_bwd_tolerance(dtype, i):
    """On the dyadic inputs both versions take the same relu decisions:
    output i = 0 (dx) 2e-5 of max|ref| at float32, one bf16 step plus
    margin at bf16 (dx is stored in bf16); the weight grads, float32 sums
    over every row in another order, 1e-4."""
    if i:
        return 1e-4
    return 2e-5 if dtype == torch.float32 else 8e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,c,cmid,cdec", [
    (300, C, CMID, CDEC), (1000, 32, 100, 40), (2 * 4356, 32, 256, 25),
    (2 * 4356, 64, 512, 51), (128 * 4356, 32, 256, 25),
    (300, 48, 384, 38), (1000, 72, 576, 57), (2 * 4356, 128, 1024, 102),
    (1, 32, 256, 25), (127, 32, 256, 25), (129, 32, 256, 25),
    (128 * 4356, 32, 128, 25), (128 * 4356, 32, 64, 25)],
    ids=["small", "cmid100", "flagship_b2", "wide_b2", "flagship_b128",
         "c48", "c72", "c128_b2", "n1", "n127", "n129", "tp2_b128",
         "tp4_b128"])
def test_wide_bwd_matches_plain_on_card(cuda, dtype, n, c, cmid, cdec):
    """The tolerances of ``wide_bwd_tolerance``; 1, 127 and 129 rows cut
    the tensor-core kernels' 128-row tiles short; tp2 and tp4 are the
    flagship's rows at a rank's C_mid on a model axis of 2 and 4."""
    args = wide_bwd_inputs(n, c, cmid, cdec, seed=6, device=cuda,
                           dtype=dtype)
    before = wb.LAUNCHES["wide_bwd"]
    got = wb.wide_bwd(*args)
    torch.cuda.synchronize()
    assert wb.LAUNCHES["wide_bwd"] == before + 1
    want = wb.wide_bwd_plain(*args)
    assert got[0].dtype == dtype
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        tol = wide_bwd_tolerance(dtype, i)
        assert max_rel(a, b) < tol, (i, max_rel(a, b))


@pytest.mark.cuda
def test_wide_bwd_routes_on_card(cuda):
    """At C, C_dec <= 32 and C_mid <= 256 both dtypes take the tensor
    cores (bf16 wide_bwd_bf16_kernel, float32 wide_bwd_tf32_kernel);
    beyond, the CUDA cores (seg_bwd_kernel with WIDE)."""
    for widths in ((32, 256, 25), (7, 256, 25), (32, 256, 32), (1, 1, 1),
                   (32, 257, 25), (33, 256, 25), (32, 256, 33),
                   (48, 384, 38), (64, 512, 51), (128, 1024, 102),
                   (32, 128, 25), (32, 64, 25)):
        tc = widths[0] <= 32 and widths[1] <= 256 and widths[2] <= 32
        assert wb.wide_bwd_route(torch.bfloat16, *widths) == \
            wb.WIDE_BWD_ROUTES[1 if tc else 0], widths
        assert wb.wide_bwd_route(torch.float32, *widths) == \
            wb.WIDE_BWD_ROUTES[2 if tc else 0], widths


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,cmid,cdec,seed,route", [
    (128 * 4356, 32, 256, 25, 10, "wide_bwd_bf16_kernel"),
    (1000, 7, 100, 12, 10, "wide_bwd_bf16_kernel"),
    (385, 8, 64, 7, 10, "wide_bwd_bf16_kernel"),
    (300, 8, 16, 7, 10, "wide_bwd_bf16_kernel"),
    (2000, 1, 1, 1, 11, "wide_bwd_bf16_kernel"),
    (2000, 1, 1, 1, 10, "wide_bwd_bf16_kernel"),
    (1000, 32, 256, 32, 10, "wide_bwd_bf16_kernel"),
    (1000, 32, 257, 25, 10, "seg_bwd_kernel"),
    (300, 48, 384, 38, 10, "seg_bwd_kernel"),
    (128 * 4356, 32, 128, 25, 10, "wide_bwd_bf16_kernel"),
    (128 * 4356, 32, 64, 25, 10, "wide_bwd_bf16_kernel")],
    ids=["flagship_b128", "c7", "c8_cmid64", "c8_cmid16", "c1", "c1_dz0",
         "cdec32", "cmid257", "c48", "tp2_b128", "tp4_b128"])
def test_bf16_wide_bwd_routes_match_plain_on_card(cuda, n, c, cmid, cdec,
                                                  seed, route):
    """bf16 within the tensor cores' widths takes wide_bwd_bf16_kernel: the
    flagship at batch 128, 7/100/12 (x by plain copies, a warp's channels
    cut short), 8/64/7 (six warps' channels all padding), 8/16/7 (seven
    warps' channels and half of the first's padding), 1/1/1 (one middle
    channel; at seed 10 w2's one draw is 0, so dz is 0 and dx, dW1 and db1
    are all zeros, compared exactly), c_dec 32 (dy rows of 64 bytes);
    c_mid 257 and 48 channels take seg_bwd_kernel.  All match plain on the
    dyadic inputs, and two calls agree bit for bit."""
    assert wb.wide_bwd_route(torch.bfloat16, c, cmid, cdec).startswith(route)
    args = wide_bwd_inputs(n, c, cmid, cdec, seed=seed, device=cuda,
                           dtype=torch.bfloat16)
    got = wb.wide_bwd(*args)
    again = wb.wide_bwd(*args)
    torch.cuda.synchronize()
    want = wb.wide_bwd_plain(*args)
    zeros = [i for i, b in enumerate(want) if not b.abs().max()]
    assert zeros == ([0, 1, 2] if (c, seed) == (1, 10) else []), zeros
    for i, (a, a2, b) in enumerate(zip(got, again, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if i in zeros:   # max|ref| = 0: no relative error, exact zeros
            assert torch.equal(a, b), i
        else:
            tol = wide_bwd_tolerance(torch.bfloat16, i)
            assert max_rel(a, b) < tol, (i, max_rel(a, b))
        assert torch.equal(a, a2), i


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,cmid,cdec,seed,route", [
    (128 * 4356, 32, 256, 25, 10, "wide_bwd_tf32_kernel"),
    (1000, 7, 100, 12, 10, "wide_bwd_tf32_kernel"),
    (385, 8, 64, 7, 10, "wide_bwd_tf32_kernel"),
    (2000, 1, 1, 1, 11, "wide_bwd_tf32_kernel"),
    (2000, 1, 1, 1, 10, "wide_bwd_tf32_kernel"),
    (1000, 32, 256, 32, 10, "wide_bwd_tf32_kernel"),
    (129, 32, 256, 25, 10, "wide_bwd_tf32_kernel"),
    (1000, 32, 257, 25, 10, "seg_bwd_kernel"),
    (300, 48, 384, 38, 10, "seg_bwd_kernel"),
    (128 * 4356, 32, 128, 25, 10, "wide_bwd_tf32_kernel"),
    (128 * 4356, 32, 64, 25, 10, "wide_bwd_tf32_kernel")],
    ids=["flagship_b128", "c7", "c8_cmid64", "c1", "c1_dz0", "cdec32",
         "n129", "cmid257", "c48", "tp2_b128", "tp4_b128"])
def test_f32_wide_bwd_routes_match_plain_on_card(cuda, n, c, cmid, cdec,
                                                 seed, route):
    """float32 within the tensor cores' widths takes wide_bwd_tf32_kernel:
    the flagship at batch 128, 7/100/12 (4-byte copies, two of the four
    64-channel chunks), 8/64/7 (one chunk), 1/1/1 (one middle channel; at
    seed 10 w2's one draw is 0, so dz is 0 and dx, dW1 and db1 are all
    zeros, compared exactly), c_dec 32, 129 rows (a tile of one row);
    c_mid 257 and 48 channels take seg_bwd_kernel.  All match plain on the
    dyadic inputs at ``wide_bwd_tolerance``, and two calls agree bit for
    bit."""
    assert wb.wide_bwd_route(torch.float32, c, cmid, cdec).startswith(route)
    args = wide_bwd_inputs(n, c, cmid, cdec, seed=seed, device=cuda)
    got = wb.wide_bwd(*args)
    again = wb.wide_bwd(*args)
    torch.cuda.synchronize()
    want = wb.wide_bwd_plain(*args)
    zeros = [i for i, b in enumerate(want) if not b.abs().max()]
    assert zeros == ([0, 1, 2] if (c, seed) == (1, 10) else []), zeros
    for i, (a, a2, b) in enumerate(zip(got, again, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if i in zeros:   # max|ref| = 0: no relative error, exact zeros
            assert torch.equal(a, b), i
        else:
            tol = wide_bwd_tolerance(torch.float32, i)
            assert max_rel(a, b) < tol, (i, max_rel(a, b))
        assert torch.equal(a, a2), i


@pytest.mark.cuda
@pytest.mark.parametrize("c,offset", [(32, 1), (32, 4), (7, 1), (25, 2)],
                         ids=["c32_off1", "c32_off4", "c7_off1", "c25_off2"])
def test_f32_wide_bwd_on_card_takes_views_at_any_alignment(cuda, c, offset):
    """float32 x and dy as contiguous views `offset` elements into larger
    buffers: off the 16-byte grid (4-byte copies) or on it (16-byte
    cp.async where C and C_dec are multiples of 4), at 1,000 rows, on
    wide_bwd_tf32_kernel."""
    assert wb.wide_bwd_route(torch.float32, c, 256, 25).startswith(
        "wide_bwd_tf32_kernel")
    x0, w1, b1, w2, dy0 = wide_bwd_inputs(1000, c, 256, 25, seed=11,
                                          device=cuda)

    def view(t):
        buf = torch.zeros(t.numel() + offset, device=cuda)
        buf[offset:] = t.flatten()
        return buf[offset:].view(t.shape)

    got = wb.wide_bwd(view(x0), w1, b1, w2, view(dy0))
    want = wb.wide_bwd_plain(x0, w1, b1, w2, dy0)
    for i, (a, b) in enumerate(zip(got, want)):
        tol = wide_bwd_tolerance(torch.float32, i)
        assert max_rel(a, b) < tol, (i, max_rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("c,offset", [(32, 1), (32, 4), (32, 8), (7, 1)],
                         ids=["c32_off1", "c32_off4", "c32_off8", "c7_off1"])
def test_bf16_wide_bwd_on_card_takes_views_at_any_alignment(cuda, c, offset):
    """bf16 x and dy as contiguous views `offset` elements into larger
    buffers: off the 16-byte grid (plain copies of x and dx, dy's spans
    from any skew) or on it (16-byte cp.async where C is a multiple of 8),
    at 1,000 rows, on wide_bwd_bf16_kernel."""
    assert wb.wide_bwd_route(torch.bfloat16, c, 256, 25).startswith(
        "wide_bwd_bf16_kernel")
    n = 1000
    x0, w1, b1, w2, dy0 = wide_bwd_inputs(n, c, 256, 25, seed=11,
                                          device=cuda, dtype=torch.bfloat16)

    def view(t):
        buf = torch.zeros(t.numel() + offset, device=cuda,
                          dtype=torch.bfloat16)
        buf[offset:] = t.flatten()
        return buf[offset:].view(t.shape)

    x, dy = view(x0), view(dy0)
    got = wb.wide_bwd(x, w1, b1, w2, dy)
    want = wb.wide_bwd_plain(x0, w1, b1, w2, dy0)
    for i, (a, b) in enumerate(zip(got, want)):
        tol = wide_bwd_tolerance(torch.bfloat16, i)
        assert max_rel(a, b) < tol, (i, max_rel(a, b))


def assert_table_close(got, want, rtol, atol_frac=0.0):
    """Elementwise rtol, atol of max|ref| over the finite values, NaN where
    the plain twin has NaN (a window with no clear pixel)."""
    atol = atol_frac * float(want[want.isfinite()].abs().max())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("squared", [False, True], ids=["l1", "l2"])
@pytest.mark.parametrize("b,size,border", [
    (5, 48, 3), (128, 48, 3), (3, 20, 2), (3, 7, 3), (4, 48, 0),
    (2, 131, 3), (2, 384, 3), (16, 384, 3)])
def test_shift_tables_match_plain_on_card(cuda, squared, b, size, border):
    """Table rtol 3e-5, d/dpred rtol 1e-4 (atol 1e-6 max|ref|), as
    tests/test_pallas.py holds the TPU kernels; on integer planes both
    versions compute the same residuals, so the L1 signs agree.  7^2 at
    border 3 has one crop pixel, so some windows have no clear pixel and
    give NaN in both."""
    hr, m, p, g = shift_table_inputs(b, size, border, seed=7, device=cuda)
    before = dict(st.LAUNCHES)
    tab = st.shift_table_fwd(hr, m, p, border, squared)
    dp = st.shift_table_bwd(hr, m, p, g, border, squared)
    torch.cuda.synchronize()
    assert st.LAUNCHES == {k: v + 1 for k, v in before.items()}
    assert_table_close(tab, st.shift_table_fwd_plain(hr, m, p, border,
                                                     squared), 3e-5)
    assert_table_close(dp, st.shift_table_bwd_plain(hr, m, p, g, border,
                                                    squared), 1e-4, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b,size,border", [(1, 1024, 3), (1, 2100, 3),
                                           (2, 48, 8), (2, 40, 5)],
                         ids=["row-tiles", "column-tiles", "border-8",
                              "border-5"])
def test_shift_tables_in_tiles_and_shift_row_groups_on_card(cuda, b, size,
                                                            border):
    """Bands staged in row tiles (1024^2) and in column tiles too
    (2100^2), and borders whose shift rows take several groups of 7, L2,
    with the bounds above."""
    hr, m, p, g = shift_table_inputs(b, size, border, seed=9, device=cuda)
    plan = st.card_plan(b, size, size, border)
    if size == 1024:
        assert plan["RT"] < plan["R"] and plan["CT"] == size - 2 * border
    if size == 2100:
        assert plan["CT"] < size - 2 * border
    assert_table_close(st.shift_table_fwd(hr, m, p, border, True),
                       st.shift_table_fwd_plain(hr, m, p, border, True),
                       3e-5)
    assert_table_close(st.shift_table_bwd(hr, m, p, g, border, True),
                       st.shift_table_bwd_plain(hr, m, p, g, border, True),
                       1e-4, 1e-6)


@pytest.mark.cuda
def test_shift_tables_take_a_fractional_mask_on_card(cuda):
    """The mask is not assumed binary: weights 0, 1/4, 1/2 and 1 (powers
    of two, so both versions round (p + bias) m alike), with the same
    bounds against the plain twins."""
    hr, m, p, g = shift_table_inputs(4, 48, 3, seed=10, device=cuda)
    r = np.random.default_rng(10)
    m = torch.from_numpy(r.choice(np.float32([0, 0.25, 0.5, 1]), m.shape)
                         ).to(cuda)
    for sq in (False, True):
        assert_table_close(st.shift_table_fwd(hr, m, p, 3, sq),
                           st.shift_table_fwd_plain(hr, m, p, 3, sq), 3e-5)
        assert_table_close(st.shift_table_bwd(hr, m, p, g, 3, sq),
                           st.shift_table_bwd_plain(hr, m, p, g, 3, sq),
                           1e-4, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b,size", [(128, 48), (16, 384)])
def test_shift_tables_are_bitwise_deterministic_on_card(cuda, b, size):
    """Two runs of each table, L1 and L2, are equal bit for bit: the bands
    meet in rank order, with no atomics."""
    hr, m, p, g = shift_table_inputs(b, size, 3, seed=11, device=cuda)
    for sq in (False, True):
        assert torch.equal(st.shift_table_fwd(hr, m, p, 3, sq),
                           st.shift_table_fwd(hr, m, p, 3, sq))
        assert torch.equal(st.shift_table_bwd(hr, m, p, g, 3, sq),
                           st.shift_table_bwd(hr, m, p, g, 3, sq))


@pytest.mark.cuda
def test_launch_plan_matches_the_launcher_on_card(cuda):
    """launch_plan at the cluster size the C entry picks on this card gives
    the C entry's plan, and the card holds that plan's clusters; a refused
    border is refused by both."""
    for b, size, border in [(128, 48, 3), (16, 384, 3), (2, 131, 3),
                            (3, 7, 3), (4, 48, 0), (1, 2100, 3),
                            (2, 48, 8)]:
        got = st.card_plan(b, size, size, border)
        assert got.pop("clusters") >= 1
        assert got == launch_plan(b, size, size, border,
                                     got["nb"]), (b, size, border)
    assert st.card_plan(2, 200, 200, 40) is None
    assert launch_plan(2, 200, 200, 40, 16) is None


@pytest.mark.cuda
@pytest.mark.parametrize("size", [130, 131, 384])
def test_kernel_loss_cpsnr_launches_the_table_on_card(cuda, size):
    """ShiftCompensatedLosses(use_kernel=True).cpsnr of 130^2, 131^2 and
    384^2 planes (a scene's: beyond what one block can stage, so in
    bands): one shift_table_fwd launch, within 1e-5 of the unfold path."""
    hr, mask, pred = cpsnr_planes(size, cuda)
    want = ShiftCompensatedLosses((size, size, 1)).cpsnr(hr, mask, pred)
    before = dict(st.LAUNCHES)
    got = ShiftCompensatedLosses((size, size, 1), use_kernel=True).cpsnr(
        hr, mask, pred)
    torch.cuda.synchronize()
    assert st.LAUNCHES == dict(before, shift_table_fwd=before[
        "shift_table_fwd"] + 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def cpsnr_planes(size, device):
    r = np.random.default_rng(size)
    hr, pred = (torch.from_numpy(r.uniform(0, 65535, (2, size, size, 1))
                                 .astype(np.float32)).to(device)
                for _ in range(2))
    mask = torch.from_numpy(r.uniform(size=(2, size, size, 1)) < 0.9
                            ).float().to(device)
    return hr, mask, pred


@pytest.mark.cuda
@pytest.mark.parametrize("squared", [False, True], ids=["l1", "l2"])
@pytest.mark.parametrize("size", [131, 384])
def test_shift_table_launches_beyond_130_on_card(cuda, size, squared):
    """Both launchers take 131^2 and 384^2 planes, one launch each, and
    match the plain twins with the bounds above."""
    hr, m, p, g = shift_table_inputs(2, size, 3, seed=8, device=cuda)
    before = dict(st.LAUNCHES)
    tab = st.shift_table_fwd(hr, m, p, 3, squared)
    dp = st.shift_table_bwd(hr, m, p, g, 3, squared)
    torch.cuda.synchronize()
    assert st.LAUNCHES == {k: v + 1 for k, v in before.items()}
    assert_table_close(tab, st.shift_table_fwd_plain(hr, m, p, 3, squared),
                       3e-5)
    assert_table_close(dp, st.shift_table_bwd_plain(hr, m, p, g, 3, squared),
                       1e-4, 1e-6)


@pytest.mark.cuda
def test_shift_table_refuses_a_border_beyond_shared_memory_on_card(cuda):
    """A border whose 81^2 shifts' sums leave no shared memory for a tile
    row raises a ValueError before any launch, uncounted, and never runs
    the plain twin in the kernel's place."""
    hr, m, p, g = shift_table_inputs(2, 200, 40, seed=8, device=cuda)
    before = dict(st.LAUNCHES)
    with pytest.raises(ValueError, match="shift_table_fwd.*shared memory"):
        st.shift_table_fwd(hr, m, p, 40, False)
    with pytest.raises(ValueError, match="shift_table_bwd.*shared memory"):
        st.shift_table_bwd(hr, m, p, g, 40, True)
    assert st.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,size,batch", [(5, 24, 2), (3, 384, 2)])
def test_scorer_on_card_equals_scorer_on_cpu(cuda, n, size, batch):
    """per_scene_cpsnr on the card against the same scorer on CPU tensors,
    rtol 1e-5 and atol 1e-4 dB (the JAX scorer's bound), ragged tails
    included, 10% of the truth masked with its data kept."""
    r = np.random.default_rng(n)
    data = r.uniform(0, 60000, (n, size, size, 1)).astype(np.float32)
    hr = np.ma.masked_array(data, mask=r.uniform(size=data.shape) < 0.1)
    pred = np.clip(data + r.normal(0, 300, data.shape), 0, 65535)
    got = per_scene_cpsnr(hr, pred, batch=batch, device=cuda)
    want = per_scene_cpsnr(hr, pred, batch=batch, device="cpu")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def rel_l2(got, ref):
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).norm() / ref.norm())


@pytest.mark.cuda
def test_flat_stack_autograd_on_card_matches_plain_autograd(cuda):
    """Gradients through the flat stack's node (wide_bwd) against autograd
    through the same forward, float32, 3 blocks, on inputs drawn from a
    seeded numpy generator.  Compared leaf by leaf norm-wise: past the
    first block z is no dyadic value, and a relu derivative that flips
    between the two sums' orders moves one element by a whole dz, which
    an elementwise bound reads as a failure and a norm does not."""
    blocks = [tuple(t.requires_grad_() for t in params(
        32, 256, 25, seed=s, device=cuda)) for s in (3, 4, 5)]
    r = np.random.default_rng(9)
    x = torch.from_numpy(r.normal(size=(2, 9, 8, 9, 32)).astype(
        np.float32)).to(cuda).requires_grad_()
    before = wb.LAUNCHES["wide_bwd"]
    y = bs.fused_block_stack(x, blocks)
    gy = torch.from_numpy(r.normal(size=tuple(y.shape)).astype(
        np.float32)).to(cuda)
    leaves = [x] + [t for blk in blocks for t in blk]
    got = torch.autograd.grad(y, leaves, gy)
    assert wb.LAUNCHES["wide_bwd"] == before + 3
    ref = x
    for blk in blocks:
        ref, _ = bs.block_fwd(ref, *blk)
    want = torch.autograd.grad(ref, leaves, gy)
    for a, b in zip(got, want):
        assert rel_l2(a, b) < 1e-4


# reduce_partials (the last launch of blk_bwd and wide_bwd) against
# torch.sum: float32 sums of up to 264 slots in another order, 1e-5 of
# max|ref| (chip_smoke's REDUCE_TOL).
REDUCE_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 31, 14_873, 36_505, 147_635])
@pytest.mark.parametrize("groups", [1, 7, 132, 264])
def test_reduce_partials_matches_torch_sum_on_card(cuda, groups, length):
    """Random normal partials in [G, slot_stride(len)] with NaN pad
    columns (never stored): the kernel against torch.sum of the real
    columns, one launch counted."""
    r = np.random.default_rng(groups * 7 + length)
    part = torch.full((groups, ts.slot_stride(length)), float("nan"),
                      device=cuda)
    part[:, :length] = torch.from_numpy(
        r.normal(size=(groups, length)).astype(np.float32)).to(cuda)
    before = ts.LAUNCHES["reduce_partials"]
    got = ts.reduce_partials(part, length)
    torch.cuda.synchronize()
    assert ts.LAUNCHES["reduce_partials"] == before + 1
    want = torch.sum(part[:, :length], 0)
    assert got.shape == (length,) and bool(torch.isfinite(got).all())
    assert max_rel(got, want) <= REDUCE_TOL, max_rel(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("groups,length", [
    (264, 36_505), (132, 14_873), (132, 589_286), (264, 147_635), (7, 31),
    (1, 1)])
def test_reduce_partials_plan_matches_the_mirror_on_card(cuda, groups,
                                                         length):
    """The C entry's plan is tests/reduce_plan.py's at this card's SM
    count, and the card holds at least one of its clusters."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tiles, ranks, warps, clusters = ts.reduce_plan(groups, length)
    assert (tiles, ranks, warps) == reduce_plan(groups, length, sms)
    assert clusters >= 1


@pytest.mark.cuda
def test_reduce_partials_refuses_bad_slots_on_card(cuda):
    """A stride that is no multiple of 4, a length beyond the stride and a
    part that is not 16-byte aligned: the wrapper raises before any launch
    and the C entry refuses (it never launches)."""
    from probav_tpu_torch.ops import _build
    part = torch.zeros((3, 64), device=cuda)
    before = ts.LAUNCHES["reduce_partials"]
    for bad, length in ((part[:, :62].contiguous(), 40), (part, 65),
                        (part.view(-1)[1:129].view(2, 64), 40)):
        with pytest.raises(ValueError, match="reduce_partials"):
            ts.reduce_partials(bad, length)
    assert ts.LAUNCHES["reduce_partials"] == before
    lib, out = _build.library(), torch.empty(64, device=cuda)
    s = ts._stream(part)
    p, o = part.data_ptr(), out.data_ptr()
    assert lib.probav_reduce_partials(p, o, 3, 40, 62, s) != 0
    assert lib.probav_reduce_partials(p, o, 3, 65, 64, s) != 0
    assert lib.probav_reduce_partials(p + 4, o, 2, 40, 64, s) != 0
    assert lib.probav_reduce_partials(p, o + 4, 3, 40, 64, s) != 0
    assert lib.probav_reduce_partials(p, o, 0, 40, 64, s) != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,c,cmid,cdec", [
    ((128, 22, 22, 9), 32, 256, 25), ((2, 22, 22, 9), 64, 512, 51),
    ((128, 22, 22, 9), 64, 512, 51), ((3, 7, 6, 5), 128, 1024, 102)],
    ids=["flagship_b128", "wide_b2", "wide_b128", "c128"])
def test_blk_bwd_and_wide_bwd_are_bitwise_deterministic_on_card(
        cuda, dtype, shape, c, cmid, cdec):
    """Two calls of each give the same bits in every output, on random
    normal inputs (on dyadic ones any order of summation is exact): the
    partial slots are written by fixed blocks and summed in a fixed order,
    with no atomics.  At 128 channels G is one slot an SM.  At 64/512/51
    (on 2 patches and on the train step's 128) that holds for the split
    seg_bwds (dx's float32 parts summed in chunk order) and the tiled
    wgrads at both dtypes."""
    assert_blk_bwd_routes(dtype, shape, c, cmid, cdec)
    r = np.random.default_rng(c)
    mk = lambda *sz: torch.from_numpy(
        r.normal(size=sz).astype(np.float32)).to(cuda, dtype)
    w1, b1, w2, _, wc, _ = params(c, cmid, cdec, seed=c, device=cuda)
    gy, x, d = mk(*shape, c), mk(*shape, c), mk(*shape, cdec)
    first = ts.blk_bwd(gy, x, d, w1, b1, w2, wc)
    second = ts.blk_bwd(gy, x, d, w1, b1, w2, wc)
    for name, a, b in zip(BWD_NAMES, first, second):
        assert torch.equal(a, b), name
    rows = x.reshape(-1, c)
    dy = mk(rows.shape[0], cdec)
    first = wb.wide_bwd(rows, w1, b1, w2, dy)
    second = wb.wide_bwd(rows, w1, b1, w2, dy)
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), i
