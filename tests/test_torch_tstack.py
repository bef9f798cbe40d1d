"""Parity of the port's block stack (probav_tpu_torch/ops/tstack.py) with
the JAX package's fused stack (probav_tpu/ops/pallas_tstack.py).

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels through the interpreter, as tests/test_tstack.py does.
The CUDA kernels themselves are held against the same plain versions on
the card (tests/test_torch_kernels.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import probav_tpu.ops.pallas_tstack as jts
from probav_tpu_torch.ops import tstack as ts

torch.set_num_threads(1)

B, H, W, T, C = 4, 5, 6, 3, 8
CMID, CDEC, NBLK = 16, 7, 3
DIMS3 = ("NHWDC", "HWDIO", "NHWDC")
F32_TOL = 2e-5          # of max|ref|, as tests/test_tstack.py:65


@pytest.fixture(autouse=True)
def _interpret():
    old = jts.INTERPRET
    jts.INTERPRET = True
    yield
    jts.INTERPRET = old


def make_blocks(seed, cdec, nblk):
    r = np.random.default_rng(seed)
    mk = lambda *s: r.normal(0, 0.3, s).astype(np.float32)
    return [(mk(C, CMID), mk(CMID), mk(CMID, cdec), mk(cdec),
             mk(3, 3, 3, cdec, C), mk(C)) for _ in range(nblk)]


def make_x(seed=4):
    return np.random.default_rng(seed).normal(0, 1, (B, H, W, T, C)) \
        .astype(np.float32)


def to_jax(blocks, dtype=jnp.float32):
    return tuple(tuple(jnp.asarray(a, dtype) for a in b) for b in blocks)


def to_torch(blocks, dtype=torch.float32):
    return [tuple(torch.from_numpy(a).to(dtype) for a in b) for b in blocks]


def max_rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("cdec", [CDEC, 12], ids=["cdec7", "cdec12_gt_c"])
def test_stack_matches_jax_pallas_stack(cdec):
    """cdec=12 > C=8 is the 64-filter model's case (c_dec 51 > 32)."""
    blocks = make_blocks(3, cdec, NBLK)
    x = make_x()
    ref = jts.stack_apply_5d(jnp.asarray(x), to_jax(blocks),
                             target_rows=18, target_ch=6)
    got = ts.stack_apply_5d(torch.from_numpy(x), to_torch(blocks))
    assert got.shape == (B, H, W, T, C) and got.dtype == torch.float32
    assert max_rel(got, ref) < F32_TOL


def test_stack_bf16_matches_jax_pallas_stack():
    """bf16: weights and biases rounded to bf16, the relu output rounded
    before the decay product, outputs stored in bf16 -- the rounding points
    of pallas_tstack.py.  Tolerance: a few bf16 ulps (2**-8) of max|ref|
    after three blocks."""
    blocks = make_blocks(5, CDEC, NBLK)
    x = make_x(6)
    ref = jts.stack_apply_5d(jnp.asarray(x, jnp.bfloat16),
                             to_jax(blocks, jnp.bfloat16),
                             target_rows=18, target_ch=6)
    got = ts.stack_apply_5d(torch.from_numpy(x).bfloat16(),
                            to_torch(blocks, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert max_rel(got.float(), np.asarray(ref, np.float32)) < 2e-2


def jax_seg(x2, w1, b1, w2, b2):
    return jnp.maximum(x2 @ w1 + b1, 0.0) @ w2 + b2


def test_seg_fwd_plain_matches_jax_reference():
    (w1, b1, w2, b2, _, _), = make_blocks(7, CDEC, 1)
    x2 = make_x(8).reshape(-1, C)
    ref = jax_seg(*(jnp.asarray(a) for a in (x2, w1, b1, w2, b2)))
    got = ts.seg_fwd_plain(*(torch.from_numpy(a)
                             for a in (x2, w1, b1, w2, b2)))
    assert got.shape == (B * H * W * T, CDEC)
    assert max_rel(got, ref) < F32_TOL


@pytest.mark.parametrize("h,w", [(H, W), (1, W), (1, 48)],
                         ids=["h5", "h1", "h1_w48"])
@pytest.mark.parametrize("cdec", [CDEC, 12], ids=["cdec7", "cdec12_gt_c"])
def test_conv_fwd_plain_matches_jax_reference(cdec, h, w):
    """c_dec 12 > C 8 is the dd conv's relation (and the 64-filter model's);
    H = 1 leaves only the middle h tap, as the kernel's ring does; W = 48
    is a row that the kernel cuts into column runs."""
    (_, _, _, _, wc, bc), = make_blocks(9, cdec, 1)
    r = np.random.default_rng(10)
    d = r.normal(0, 1, (B, h, w, T, cdec)).astype(np.float32)
    x = make_x(11)[:, :h] if w == W else \
        r.normal(0, 1, (B, h, w, T, C)).astype(np.float32)
    ref = jnp.asarray(x) + lax.conv_general_dilated(
        jnp.asarray(d), jnp.asarray(wc), (1, 1, 1), "SAME",
        dimension_numbers=DIMS3) + jnp.asarray(bc)
    got = ts.conv_fwd_plain(*(torch.from_numpy(a) for a in (d, x, wc, bc)))
    assert got.shape == x.shape
    assert max_rel(got, ref) < F32_TOL


# ---------------------------------------------------------------------- #
# backward: blk_bwd_plain and the stack's autograd node                   #
# ---------------------------------------------------------------------- #

GRAD_TOL = 1e-4         # relative, of max|ref|: sums in another order


def jax_stack_vjp(x, blocks, gy, dtype=jnp.float32):
    """(dx, per-block grads) of the JAX fused stack (Pallas interpreted)."""
    def f(x, blocks):
        return jts.stack_apply_5d(x, blocks, target_rows=18, target_ch=6)
    _, vjp = jax.vjp(f, jnp.asarray(x, dtype), to_jax(blocks, dtype))
    return vjp(jnp.asarray(gy, dtype))


def port_stack_grads(x, blocks, gy, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    bt = [tuple(t.requires_grad_() for t in blk)
          for blk in to_torch(blocks, dtype)]
    y = ts.stack_apply_5d(xt, bt)
    leaves = [xt] + [t for blk in bt for t in blk]
    return torch.autograd.grad(y, leaves, torch.from_numpy(gy).to(dtype))


def test_blk_bwd_plain_matches_jax_blk_bwd_vjp():
    """One block: the JAX VJP of the fused stack is blk_bwd (its backward
    runs exactly one blk_bwd kernel); blk_bwd_plain gets x, d = seg(x) and
    the cotangent directly."""
    blocks = make_blocks(21, CDEC, 1)
    x, gy = make_x(22), make_x(23)
    dx_j, (g_j,) = jax_stack_vjp(x, blocks, gy)
    w1, b1, w2, b2, wc, bc = to_torch(blocks)[0]
    xt = torch.from_numpy(x)
    d = ts.seg_fwd_plain(xt.reshape(-1, C), w1, b1, w2, b2) \
        .reshape(B, H, W, T, CDEC)
    dx, dwc, dw1, db1, dw2, db2, dbc = ts.blk_bwd_plain(
        torch.from_numpy(gy), xt, d, w1, b1, w2, wc)
    assert max_rel(dx, dx_j) < GRAD_TOL
    for got, ref in ((dw1, g_j[0]), (db1, g_j[1]), (dw2, g_j[2]),
                     (db2, g_j[3]), (dwc, g_j[4]), (dbc, g_j[5])):
        assert got.shape == ref.shape
        assert max_rel(got, ref) < GRAD_TOL


@pytest.mark.parametrize("cdec", [CDEC, 12], ids=["cdec7", "cdec12_gt_c"])
def test_stack_grads_match_jax_fused_stack(cdec):
    blocks = make_blocks(31, cdec, NBLK)
    x, gy = make_x(32), make_x(33)
    dx_j, g_j = jax_stack_vjp(x, blocks, gy)
    got = port_stack_grads(x, blocks, gy)
    assert max_rel(got[0], dx_j) < GRAD_TOL
    ref = [np.asarray(a) for blk in g_j for a in blk]
    for g, r in zip(got[1:], ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        assert max_rel(g, r) < GRAD_TOL


@pytest.mark.parametrize("cdec", [CDEC, 12], ids=["cdec7", "cdec12_gt_c"])
def test_stack_grads_bf16_match_jax_fused_stack(cdec):
    """bf16: cotangents and weight grads rounded to bf16 where
    pallas_tstack.py rounds them (dd, dz, relu(z), dx, and each weight
    grad cast to its weight's dtype).  Elements near a relu threshold or a
    bf16 rounding tie may differ by one bf16 step, which three blocks
    carry on: 3e-2 of max|ref|."""
    blocks = make_blocks(41, cdec, NBLK)
    x, gy = make_x(42), make_x(43)
    dx_j, g_j = jax_stack_vjp(x, blocks, gy, jnp.bfloat16)
    got = port_stack_grads(x, blocks, gy, torch.bfloat16)
    ref = [np.asarray(dx_j, np.float32)] + \
        [np.asarray(a, np.float32) for blk in g_j for a in blk]
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        assert max_rel(g.float(), r) < 3e-2
