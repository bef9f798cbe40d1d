"""Parity of the port's block stack (probav_tpu_torch/ops/tstack.py) with
the JAX package's fused stack (probav_tpu/ops/pallas_tstack.py).

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels through the interpreter, as tests/test_tstack.py does.
The CUDA kernels themselves are held against the same plain versions on
the card (tests/test_torch_kernels.py and chip_smoke.py).
"""

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


def test_conv_fwd_plain_matches_jax_reference():
    (_, _, _, _, wc, bc), = make_blocks(9, CDEC, 1)
    r = np.random.default_rng(10)
    d = r.normal(0, 1, (B, H, W, T, CDEC)).astype(np.float32)
    x = make_x(11)
    ref = jnp.asarray(x) + lax.conv_general_dilated(
        jnp.asarray(d), jnp.asarray(wc), (1, 1, 1), "SAME",
        dimension_numbers=DIMS3) + jnp.asarray(bc)
    got = ts.conv_fwd_plain(*(torch.from_numpy(a) for a in (d, x, wc, bc)))
    assert got.shape == x.shape
    assert max_rel(got, ref) < F32_TOL
