"""The index map of the float32 tensor-core seg_fwd, in numpy.

``seg_fwd_tf32_kernel`` (probav_tpu_torch/csrc/tstack.cu) computes
d = relu(x W1 + b1) W2 + b2 as 3xTF32 on mma.sync m16n8k8:

- x is staged in tiles of SFT_ROWS = 192 rows, row stride SFT_XS = 40
  floats, by copy_rows (columns from c_in on are never written; rows past
  n are zeros); warp w owns rows 16 w .. 16 w + 15;
- W1 as a [c][j] plane and W2 transposed to [c][j], zero-padded to
  32 x 256, row stride SFT_WS = 264; b1, b2 zero-padded;
- fragments (g = lane // 4, q = lane % 4; common.cuh, mma_tf32): A (16 x
  8) holds (g, q), (g+8, q), (g, q+4), (g+8, q+4); B (8 x 8) rows q and
  q+4 of column g; C (16 x 8) rows g, g+8 at columns 2q, 2q+1;
- expand: x's A fragments of the four k-steps (zero from column c_in on)
  split once a tile; per pair of 8-column n-tiles, z = x W1 from B rows
  k*8 + q (+4) of column jn + t*8 + g, three products (hi hi, lo hi, hi
  lo);
- decay: h = relu(z + b1) from C columns 2q, 2q+1 fed as A columns q,
  q+4, with W2's B rows in the same order (a float2 at [c][jn + t*8 +
  2q]); each 64-channel chunk's products in fresh sums, added to the
  running sums;
- epilogue: + b2, staged in the warp's own rows of the x tile, stored as
  the contiguous run of its rows' c_dec real columns, nothing past n.

The twin repeats that map register by register: fragments are gathered by
lane from the staged tiles, each mma rebuilds its A, B and C matrices
from the lanes' registers, and the results are read back the same way.
It is held to float64 and to the JAX package's Pallas ``seg_fwd`` (run in
interpret mode) at 2e-5 of max|ref|, the float32 kernel tolerance; a
twin without the C -> A permutation is not.  The products use the numpy
split of ``test_torch_tf32_split.py``, exact in float64 and rounded to
float32 per mma (the tensor cores' truncating sums are not emulated).
The kernel runs only on the card; this pins what it addresses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probav_tpu.ops.pallas_tstack as jts
from probav_tpu_torch.ops import tstack as ts
from test_torch_tf32_split import split_tf32, tf32_read

torch.set_num_threads(1)

ROWS, WARPS, XS, WS, CH = 192, 12, 40, 264, 64  # tstack.cu's SFT_*
LANE = np.arange(32)
G_, Q_ = LANE // 4, LANE % 4
TOL = 2e-5
WIDTHS = [(300, 32, 256, 25), (129, 7, 100, 12), (1, 32, 64, 7)]
IDS = ["flagship_widths_n300", "c7_cmid100_n129", "cdec7_n1"]


def inputs(n, c_in, c_mid, c_dec, seed=0):
    r = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: (r.normal(size=s) * sc).astype(np.float32)
    return (mk(n, c_in), mk(c_in, c_mid, sc=c_in ** -0.5),
            mk(c_mid, sc=0.1), mk(c_mid, c_dec, sc=c_mid ** -0.5),
            mk(c_dec, sc=0.1))


def a_matrix(a):
    """[..., 16, 8] A of mma m16n8k8 from its four registers [..., 32]."""
    m = np.zeros(a[0].shape[:-1] + (16, 8), np.float64)
    m[..., G_, Q_], m[..., G_ + 8, Q_] = a[0], a[1]
    m[..., G_, Q_ + 4], m[..., G_ + 8, Q_ + 4] = a[2], a[3]
    return m


def b_matrix(b):
    """[8, 8] B (k x n) from its two registers [32]."""
    m = np.zeros((8, 8), np.float64)
    m[Q_, G_], m[Q_ + 4, G_] = b[0], b[1]
    return m


def c_regs(m):
    """The four C registers [..., 32] of a [..., 16, 8] C."""
    return (m[..., G_, 2 * Q_], m[..., G_, 2 * Q_ + 1],
            m[..., G_ + 8, 2 * Q_], m[..., G_ + 8, 2 * Q_ + 1])


def mma3(c, a, b):
    """c (four float32 registers) += a b as 3xTF32 (hi hi, lo hi, hi lo):
    each operand split (split_tf32), each lo read at TF32, each term's
    product exact in float64 and rounded into c."""
    ah, al = zip(*(split_tf32(v) for v in a))
    bh, bl = zip(*(split_tf32(v) for v in b))
    al, bl = [tf32_read(v) for v in al], [tf32_read(v) for v in bl]
    for fa, fb in ((ah, bh), (al, bh), (ah, bl)):
        prod = c_regs(a_matrix(fa) @ b_matrix(fb))
        c = [(ci + p).astype(np.float32) for ci, p in zip(c, prod)]
    return c


def twin(x, w1, b1, w2, b2, permute=True):
    """d [n, c_dec] as seg_fwd_tf32_kernel addresses and sums it.
    ``permute=False`` feeds h's C registers to the decay in their own
    order (a0..a3 = c0..c3), the fault the permutation avoids."""
    n, c_in = x.shape
    c_mid, c_dec = w2.shape
    w1s = np.zeros((32, WS), np.float32)
    w1s[:c_in, :c_mid] = w1
    w2s = np.zeros((32, WS), np.float32)
    w2s[:c_dec, :c_mid] = w2.T
    b1s = np.zeros(256, np.float32)
    b1s[:c_mid] = b1
    b2s = np.zeros(32, np.float32)
    b2s[:c_dec] = b2
    tiles = -(-n // ROWS)
    # copy_rows: columns [0, c_in) of every row, zeros past n; the rest of
    # the buffer is whatever was there (NaN here: the fragments mask it).
    xt = np.full((tiles * ROWS, XS), np.nan, np.float32)
    xt[:, :c_in] = 0.0
    xt[:n, :c_in] = x
    X = xt.reshape(tiles * WARPS, 16, XS)          # a warp's 16 rows
    nw = X.shape[0]

    ax = []
    for k in range(4):
        c = k * 8 + Q_
        lo, hi = c < c_in, c + 4 < c_in
        ax.append((np.where(lo, X[:, G_, c], 0),
                   np.where(lo, X[:, G_ + 8, c], 0),
                   np.where(hi, X[:, G_, c + 4], 0),
                   np.where(hi, X[:, G_ + 8, c + 4], 0)))
    zero = lambda: [np.zeros((nw, 32), np.float32) for _ in range(4)]
    acc = [zero() for _ in range(4)]
    for ch in range(256 // CH):
        j0 = ch * CH
        if j0 >= c_mid:
            break
        dc = [zero() for _ in range(4)]
        for p in range(CH // 16):
            jn = j0 + p * 16
            z = [zero() for _ in range(2)]
            for k in range(4):
                for t in range(2):
                    col = jn + t * 8 + G_
                    bw = (w1s[k * 8 + Q_, col], w1s[k * 8 + Q_ + 4, col])
                    z[t] = mma3(z[t], ax[k], bw)
            for t in range(2):
                jl = jn + t * 8 + 2 * Q_
                h = [np.maximum(z[t][i] + b1s[jl + (i & 1)], 0)
                     for i in range(4)]
                ah = (h[0], h[2], h[1], h[3]) if permute else tuple(h)
                for ct in range(4):
                    row = ct * 8 + G_
                    bd = (w2s[row, jl], w2s[row, jl + 1])
                    dc[ct] = mma3(dc[ct], ah, bd)
        acc = [[a + d for a, d in zip(acc[ct], dc[ct])] for ct in range(4)]

    # Epilogue: + b2 into the warp's rows of the x tile (float2 stores at
    # rows g, g + 8, columns ct*8 + 2q), then the warp's contiguous run of
    # nr * c_dec floats of d, element e from row e // c_dec.
    for ct in range(4):
        cc = ct * 8 + 2 * Q_
        X[:, G_, cc] = acc[ct][0] + b2s[cc]
        X[:, G_, cc + 1] = acc[ct][1] + b2s[cc + 1]
        X[:, G_ + 8, cc] = acc[ct][2] + b2s[cc]
        X[:, G_ + 8, cc + 1] = acc[ct][3] + b2s[cc + 1]
    d = np.empty(n * c_dec, np.float32)
    for w in range(nw):
        r0 = w * 16
        nr = max(0, min(16, n - r0))
        e = np.arange(nr * c_dec)
        d[r0 * c_dec + e] = X[w, e // c_dec, e % c_dec]
    return d.reshape(n, c_dec)


def float64_ref(x, w1, b1, w2, b2):
    f = lambda a: a.astype(np.float64)
    return np.maximum(f(x) @ f(w1) + f(b1), 0) @ f(w2) + f(b2)


def jax_pallas_seg_fwd(x, w1, b1, w2, b2, monkeypatch):
    """The JAX package's Pallas seg_fwd in interpret mode, its x rows laid
    along the lanes of a one-tile geometry ([C, ext], interior mask 1)."""
    monkeypatch.setattr(jts, "INTERPRET", True)
    n = x.shape[0]
    t = 8
    w = max(1, -(-n // (t + 2)) - 2)
    s = (w + 2) * (t + 2)
    g = jts.Geom(1, w, t, 1, s, s)
    xt = np.zeros((x.shape[1], g.ext), np.float32)
    xt[:, :n] = x.T
    d = jts.seg_fwd(g, jnp.asarray(xt), jnp.ones((1, g.ext), jnp.float32),
                    *(jnp.asarray(a) for a in (w1, b1, w2, b2)))
    return np.asarray(d)[:, :n].T


def max_rel(got, ref):
    return float(np.abs(got.astype(np.float64) - ref).max() /
                 np.abs(ref).max())


@pytest.mark.parametrize("n,c_in,c_mid,c_dec", WIDTHS, ids=IDS)
def test_twin_matches_float64(n, c_in, c_mid, c_dec):
    """At the flagship's widths on 300 rows (a ragged second tile), at
    7/100/12 (C_in no multiple of 4, C_mid cut inside a chunk, C_dec > C_in)
    on 129 rows, and 32/64/7 on one row."""
    args = inputs(n, c_in, c_mid, c_dec, seed=n)
    got = twin(*args)
    assert got.shape == (n, c_dec) and np.isfinite(got).all()
    assert max_rel(got, float64_ref(*args)) < TOL


@pytest.mark.parametrize("n,c_in,c_mid,c_dec", WIDTHS, ids=IDS)
def test_twin_matches_jax_pallas_seg_fwd(n, c_in, c_mid, c_dec,
                                         monkeypatch):
    args = inputs(n, c_in, c_mid, c_dec, seed=n + 1)
    ref = jax_pallas_seg_fwd(*args, monkeypatch)
    assert max_rel(twin(*args), ref.astype(np.float64)) < TOL
    # ... and the port's plain version, the kernel's reference on the card.
    plain = ts.seg_fwd_plain(*(torch.from_numpy(a) for a in args)).numpy()
    assert max_rel(plain, ref.astype(np.float64)) < TOL


def test_twin_without_the_permutation_is_wrong():
    """Feeding h's C registers to the decay in their own order pairs
    middle channels with the wrong W2 rows: far beyond the tolerance."""
    args = inputs(300, 32, 256, 25, seed=5)
    assert max_rel(twin(*args, permute=False), float64_ref(*args)) > 1e-2


def test_fragment_loads_and_stores_are_conflict_free():
    """With the weight row stride 264 (8 mod 32) every W1 B load (32 lanes,
    one word) and every W2 B load and d staging store (float2: two
    half-warps of 16 lanes, 32 words each) touches 32 distinct banks."""
    for k in range(4):
        for jn in (0, 8, 72, 248):
            words = (k * 8 + Q_) * WS + jn + G_
            assert len(set(words % 32)) == 32
            assert len(set((words + 4 * WS) % 32)) == 32
    for ct in range(4):
        for jl0 in (0, 8, 64, 248):
            w2 = (ct * 8 + G_) * WS + jl0 + 2 * Q_
            st = G_ * XS + ct * 8 + 2 * Q_
            for half in (LANE < 16, LANE >= 16):
                for base in (w2, st, st + 8 * XS):
                    b = base[half]
                    assert len(set(np.concatenate([b, b + 1]) % 32)) == 32


def test_seg_fwd_variants_tool_applies_to_the_kernel_source():
    """tools/seg_fwd_variants.py builds its variants by substitution in
    the kernel's section of tstack.cu: every substitution still finds its
    text, and each variant gets its own copy of the kernel and a launch
    case."""
    from probav_tpu_torch.tools import seg_fwd_variants as sv
    names = list(sv.VARIANTS)
    src = sv.source(names)
    assert src.count("seg_fwd_tf32_kernel(const float* __restrict__ x") == \
        len(names)
    for i in range(len(names)):
        assert f"if (v == {i}) return v{i}::launch_seg_fwd_tf32(" in src
    assert "constexpr int SFT_WARPS = 12;" in sv.source(["warps12_blocks1"])
    assert "mma_term(acc[ct], ah, bd[ct], term)" in \
        sv.source(["no_fresh_sums"])
