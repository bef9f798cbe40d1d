"""The addressing of the bf16 tensor-core seg_fwd, in numpy.

``seg_fwd_bf16_kernel`` (probav_tpu_torch/csrc/tstack.cu) computes
d = bf16(bf16(relu(x W1 + b1)) W2 + b2), sums in float32, on mma.sync
m16n8k16 (fragment layouts in common.cuh), for C_in, C_dec <= 32 and
C_mid <= 256:

- shared memory, in bf16 elements: W1 as [j][k] (row stride XS = 40), W2
  as [c][j] (stride WS = 264), both zero-padded to 256 x 32; two x tiles
  [ROWS = 256][40]; each warp's d span buffer (DS elements); b1 in
  float32 beside them;
- x rows land by 16-byte copies where C_in % 8 == 0 and x is 16-byte
  aligned, else element by element; zeros past n; columns C_in .. 31 of
  both buffers are zeroed once per block and never written (32 .. 39 are
  never read);
- warp w owns rows 32 w .. 32 w + 31 of a tile, MT = 2 row tiles of 16,
  whose A fragments are plain ldmatrix.x4 of x; per step of 16 middle
  channels two plain ldmatrix.x4 of W1 [j][k] give the expand's B
  fragments and two of W2 [c][j] the decay's, each used for both row
  tiles; z starts from b1 in the mma's C registers; h = bf16(relu(z)) in
  pairs, and the two 8-column C tiles of z are the decay's A fragment;
- epilogue: d = acc + b2, rounded to bf16, staged in the warp's span
  buffer at d's 16-byte skew as the contiguous run of its rows' C_dec
  columns, then stored as whole 16-byte chunks and element by element at
  the run's two ends; nothing past n.

The twin below models shared memory as one flat array with the kernel's
offsets (NaN where nothing was written), performs every ldmatrix by the
lanes' addresses (checking their 16-byte alignment), rebuilds each mma's
A, B and C matrices from the lanes' registers, and writes d through the
same span and chunk stores into a buffer with guard elements.  It is held
to ``seg_fwd_plain`` bit for bit on the bf16 dyadic inputs of
``tools/dyadic.seg_fwd_inputs`` (every sum exact in float32, so the order
of the sums cannot show), and to the JAX package's Pallas ``seg_fwd`` in
interpret mode at bf16 within 2e-2 of max|ref|, the bf16 kernel
tolerance.  A twin that reads W1 with .trans, or that leaves x's pad
columns as they were (NaN here), is not.  The kernel runs only on the
card; this pins what it addresses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probav_tpu.ops.pallas_tstack as jts
import test_torch_seg_bwd_mma_layout as mma_twin
from probav_tpu_torch.ops import tstack as ts
from probav_tpu_torch.tools.dyadic import seg_fwd_inputs
from test_torch_seg_bwd_mma_layout import bf16, mma

torch.set_num_threads(1)

ROWS, WARPS, MT, XS, WS = 256, 8, 2, 40, 264    # tstack.cu's SFB_*
DS = 16 * MT * 32 + 8                           # a warp's d span buffer
LANE = np.arange(32)
G_, Q_ = LANE // 4, LANE % 4
L8, M2, H16, L_8 = LANE % 8, (LANE // 8) % 2, LANE // 16, LANE // 8
TOL = 2e-2
SHAPES = [(372, 32, 256, 25), (129, 7, 100, 12), (300, 32, 256, 32),
          (1, 32, 256, 25)]
IDS = ["flagship_widths_n372", "c7_cmid100_n129", "cdec32_n300",
       "flagship_widths_n1"]


class Smem(mma_twin.Smem):
    """seg_fwd_bf16_kernel's shared memory in bf16 elements (held as
    float32), NaN where nothing was written; b1 apart, in float32."""

    def __init__(self):
        self.w1s = 0                          # [256][XS]
        self.w2s = 256 * XS                   # [32][WS]
        self.xb = self.w2s + 32 * WS          # [2][ROWS][XS]
        self.spans = self.xb + 2 * ROWS * XS  # [WARPS][DS]
        self.m = np.full(self.spans + WARPS * DS, np.nan, np.float32)


def smem_bytes(warps=WARPS, mt=MT):
    """tstack.cu's seg_fwd_bf16_smem: W1, W2, two x tiles and the warps'
    span buffers in bf16, b1 in float32."""
    rows, ds = 16 * mt * warps, 16 * mt * 32 + 8
    return 2 * (256 * XS + 32 * WS + 2 * rows * XS + warps * ds) + 4 * 256


def twin(x, w1, b1, w2, b2, trans_w1=False, zero_pad=True):
    """d [n, c_dec] as seg_fwd_bf16_kernel addresses and sums it, for one
    block walking every tile (x 16-byte aligned: 16-byte copies where
    C_in % 8 == 0).  ``trans_w1`` reads W1's fragments with .trans;
    ``zero_pad=False`` leaves x's pad columns unwritten."""
    n, c_in = x.shape
    c_mid, c_dec = w2.shape
    S = Smem()
    w1p = np.zeros((256, 32), np.float32)
    w1p[:c_mid, :c_in] = w1.T
    w2p = np.zeros((32, 256), np.float32)
    w2p[:c_dec, :c_mid] = w2.T
    S.m[S.w1s + np.arange(256)[:, None] * XS + np.arange(32)] = w1p
    S.m[S.w2s + np.arange(32)[:, None] * WS + np.arange(256)] = w2p
    b1s = np.zeros(256, np.float32)
    b1s[:c_mid] = b1
    bo = np.zeros(32, np.float32)
    bo[:c_dec] = b2
    if zero_pad:
        for r in range(2 * ROWS):
            S.m[S.xb + r * XS + np.arange(c_in, 32)] = 0.0
    guard = 8
    dflat = np.full(n * c_dec + 2 * guard, np.nan, np.float32)
    steps = -(-c_mid // 16)
    W = np.arange(WARPS)[:, None]
    for tile in range(-(-n // ROWS)):
        xt = S.xb + tile % 2 * ROWS * XS
        row0, nr = tile * ROWS, min(ROWS, n - tile * ROWS)
        rows = np.zeros((ROWS, c_in), np.float32)
        rows[:nr] = x[row0:row0 + nr]
        if c_in % 8 == 0:   # 16-byte chunks: both ends 16-byte aligned
            for ch in range(c_in // 8):
                src = (row0 + np.arange(ROWS)) * c_in + 8 * ch
                dst = xt + np.arange(ROWS) * XS + 8 * ch
                assert (src % 8 == 0).all() and (dst % 8 == 0).all()
                S.m[dst[:, None] + np.arange(8)] = rows[:, 8 * ch:8 * ch + 8]
        else:
            S.m[xt + np.arange(ROWS)[:, None] * XS + np.arange(c_in)] = rows

        rw = 16 * MT * W                                      # [W, 1]
        ax = [[S.ldsm(xt + (rw + 16 * m + L8 + 8 * M2) * XS + 16 * ks +
                      8 * H16) for ks in range(2)] for m in range(MT)]
        acc = np.zeros((MT, 4, WARPS, 4, 32), np.float32)
        for s in range(steps):
            fw = [S.ldsm(S.w1s + (16 * s + 8 * t + L8) * XS + 8 * L_8,
                         trans=trans_w1) for t in range(2)]
            fd = [S.ldsm(S.w2s + (16 * p + 8 * H16 + L8) * WS + 16 * s +
                         8 * M2) for p in range(2)]
            bias = [np.stack([b1s[16 * s + 8 * t + 2 * Q_ + i % 2]
                              for i in range(4)]) for t in range(2)]
            for m in range(MT):
                z = [np.broadcast_to(bias[t], (WARPS, 4, 32)).copy()
                     for t in range(2)]
                for t in range(2):
                    for ks in range(2):
                        z[t] = mma(z[t], ax[m][ks], fw[t][2 * ks],
                                   fw[t][2 * ks + 1])
                # relu and bf16 in pairs: (c0, c1) and (c2, c3) of each C
                # tile are a0, a1 (t = 0) and a2, a3 (t = 1).
                ah = np.stack([bf16(np.maximum(
                    np.stack([z[t][:, 2 * h], z[t][:, 2 * h + 1]], -1), 0))
                    for t in range(2) for h in range(2)], 1)
                for ct in range(4):
                    acc[m, ct] = mma(acc[m, ct], ah, fd[ct // 2][2 * (ct % 2)],
                                     fd[ct // 2][2 * (ct % 2) + 1])

        # Epilogue: stage each warp's span at d's skew, store its chunks.
        for w in range(WARPS):
            r0 = row0 + 16 * MT * w
            nrw = max(0, min(16 * MT, n - r0))
            span, skew = S.spans + w * DS, r0 * c_dec % 8
            for m in range(MT):
                for ct in range(4):
                    for i in range(4):
                        r = 16 * m + G_ + 8 * (i // 2)
                        c = 8 * ct + 2 * Q_ + i % 2
                        ok = c < c_dec
                        at = span + skew + r * c_dec + c
                        assert at.max() < span + DS
                        S.m[at[ok]] = bf16(acc[m, ct, w, i] + bo[c])[ok]
            cnt = nrw * c_dec
            for i in range(-(-(skew + cnt) // 8)):
                j0 = 8 * i - skew
                if 0 <= j0 and j0 + 8 <= cnt:
                    assert (r0 * c_dec + j0) % 8 == 0   # a 16-byte store
                    k = np.arange(8)
                else:
                    k = np.arange(8)[(j0 + np.arange(8) >= 0) &
                                     (j0 + np.arange(8) < cnt)]
                dflat[guard + r0 * c_dec + j0 + k] = S.m[span + 8 * i + k]
    assert np.isnan(dflat[:guard]).all() and np.isnan(dflat[-guard:]).all()
    return dflat[guard:-guard].reshape(n, c_dec)


def dyadic(n, c_in, c_mid, c_dec, seed):
    """bf16 dyadic inputs as torch tensors and as the twin's arrays."""
    args = seg_fwd_inputs(n, c_in, c_mid, c_dec, seed=seed,
                          dtype=torch.bfloat16)
    return args, [a.float().numpy() for a in args]


def max_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("n,c_in,c_mid,c_dec", SHAPES, ids=IDS)
def test_twin_matches_seg_fwd_plain_bit_for_bit(n, c_in, c_mid, c_dec):
    """The flagship's widths over two tiles with a ragged second (116
    rows: warp 3 cut at 20 rows, warps 4-7 empty), 7/100/12 (element
    copies, C_mid cut inside a step, C_dec > C_in), 32/256/32 (64-byte d
    rows) and one row."""
    args, feed = dyadic(n, c_in, c_mid, c_dec, seed=n + c_mid)
    got = twin(*feed)
    want = ts.seg_fwd_plain(*args).float().numpy()
    assert got.shape == (n, c_dec)
    np.testing.assert_array_equal(got, want)


def jax_pallas_seg_fwd(x, w1, b1, w2, b2, monkeypatch):
    """The JAX package's Pallas seg_fwd in interpret mode at bf16, its x
    rows laid along the lanes of a one-tile geometry ([C, ext], interior
    mask 1)."""
    monkeypatch.setattr(jts, "INTERPRET", True)
    n = x.shape[0]
    t = 8
    w = max(1, -(-n // (t + 2)) - 2)
    s = (w + 2) * (t + 2)
    g = jts.Geom(1, w, t, 1, s, s)
    xt = np.zeros((x.shape[1], g.ext), np.float32)
    xt[:, :n] = x.T
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    d = jts.seg_fwd(g, bf(xt), jnp.ones((1, g.ext), jnp.bfloat16), bf(w1),
                    jnp.asarray(b1), bf(w2), jnp.asarray(b2))
    return np.asarray(d, np.float32)[:, :n].T


@pytest.mark.parametrize("n,c_in,c_mid,c_dec", SHAPES[:2], ids=IDS[:2])
def test_twin_matches_jax_pallas_seg_fwd(n, c_in, c_mid, c_dec, monkeypatch):
    """Random-normal inputs rounded to bf16: the twin and the port's plain
    version against the Pallas kernel, within the bf16 tolerance."""
    r = np.random.default_rng(n + 1)
    mk = lambda *s, sc=1.0: bf16(r.normal(size=s) * sc)
    x, w1, w2 = (mk(n, c_in), mk(c_in, c_mid, sc=c_in ** -0.5),
                 mk(c_mid, c_dec, sc=c_mid ** -0.5))
    b1, b2 = mk(c_mid, sc=0.1), mk(c_dec, sc=0.1)
    ref = jax_pallas_seg_fwd(x, w1, b1, w2, b2, monkeypatch)
    assert max_rel(twin(x, w1, b1, w2, b2), ref) < TOL
    plain = ts.seg_fwd_plain(torch.from_numpy(x).bfloat16(),
                             *(torch.from_numpy(a) for a in (w1, b1, w2, b2)))
    assert max_rel(plain.float().numpy(), ref) < TOL


def test_twin_reading_w1_with_trans_is_wrong():
    """W1's [j][k] rows read with .trans pair inputs with the wrong middle
    channels: d far beyond the bf16 tolerance."""
    args, feed = dyadic(372, 32, 256, 25, seed=3)
    want = ts.seg_fwd_plain(*args).float().numpy()
    assert max_rel(twin(*feed, trans_w1=True), want) > 0.1


def test_twin_leaving_the_pad_columns_unzeroed_gives_nan():
    """At C_in = 7 the fragments read x's columns 7..31 against zero rows
    of W1: left as they were (NaN in the twin's shared memory), 0 x NaN
    poisons every row; zeroed once per block, every row is finite."""
    args, feed = dyadic(129, 7, 100, 12, seed=4)
    assert np.isnan(twin(*feed, zero_pad=False)).all()
    assert np.isfinite(twin(*feed)).all()


def test_layout_fits_and_accesses_are_conflict_free():
    """95,872 bytes of shared memory at 8 warps of 2 row tiles: two
    blocks an SM (each also holds 1 KB the card reserves, of the SM's
    233,472); 16 warps and 4 row tiles fit one block.  The 8 rows of every
    ldmatrix (x and W1 at 20 words a row, W2 at 132) fall in 32 distinct
    banks; the d staging stores of a warp's lanes meet at most 2 words a
    bank at the flagship's C_dec = 25 (4 at 32); its chunk loads (16 bytes
    a lane, consecutive) at most one."""
    assert smem_bytes() == 95_872
    assert 2 * (smem_bytes() + 1024) <= 233_472
    assert smem_bytes(16) <= 232_448 and smem_bytes(8, 4) <= 232_448
    for stride in (XS, WS):
        banks = (np.arange(8)[:, None] * stride // 2 + np.arange(4)) % 32
        assert len(set(banks.ravel())) == 32
    span0 = (2 * Smem().spans) // 4        # the span buffers' first word
    for c_dec, limit in ((25, 2), (32, 4)):
        worst = 0
        for skew in range(8):
            for ct in range(4):
                for i in range(4):
                    r, c = G_ + 8 * (i // 2), 8 * ct + 2 * Q_ + i % 2
                    words = span0 + (skew + r * c_dec + c)[c < c_dec] // 2
                    for b in set(words % 32):
                        worst = max(worst, len(set(words[words % 32 == b])))
        assert worst == limit, (c_dec, worst)
    chunk_words = span0 + 4 * LANE[:8, None] + np.arange(4)
    assert len(set((chunk_words % 32).ravel())) == 32


def test_seg_fwd_bf16_variants_tool_applies_to_the_kernel_source():
    """tools/seg_fwd_variants.py builds its bf16 variants by substitution
    in the kernel's section of tstack.cu: every substitution still finds
    its text, and each variant gets its own copy of the kernel and a
    launch case."""
    from probav_tpu_torch.tools import seg_fwd_variants as sv
    names = list(sv.BF16_VARIANTS)
    src = sv.source(names, "bfloat16")
    assert src.count("seg_fwd_bf16_kernel(const __nv_bfloat16* __restrict__"
                     " x") == len(names)
    for i in range(len(names)):
        assert f"if (v == {i}) return v{i}::launch_seg_fwd_bf16(" in src
    assert "seg_fwd_tf32_kernel" not in src and "conv_ring" not in src
    assert "constexpr int SFB_MT = 4;" in sv.source(["mt4_blocks1"],
                                                   "bfloat16")
    w12 = sv.source(["warps12_blocks1"], "bfloat16")
    assert "constexpr int SFB_WARPS = 12;" in w12
    assert "constexpr int SFB_MINB = 1;" in w12
    assert "fake_mma(" in sv.source(["no_mma"], "bfloat16")
    assert "const bool xvec = false &&" in sv.source(["sync_x"], "bfloat16")
