"""The stack kernels' wrappers (probav_tpu_torch/ops/tstack.py): dispatch
on the CPU, and the CUDA kernels against their plain versions on a card.

This file imports neither JAX nor the JAX package, so the ``cuda`` tests
also run on a machine without them:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from probav_tpu_torch.ops import tstack as ts

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
@pytest.mark.parametrize("c,cmid,cdec", [(32, 256, 25), (64, 512, 51),
                                         (C, CMID, CDEC), (32, 100, 40)])
def test_kernels_match_plain_on_card(cuda, dtype, tol, c, cmid, cdec):
    """Flagship and 64-filter widths, the CPU tests' small widths, and a
    c_mid that is not a multiple of the staging chunk; a ragged volume
    (7x6x5) and a row count that is not a multiple of the tile."""
    w1, b1, w2, b2, wc, bc = params(c, cmid, cdec, device=cuda, dtype=dtype)
    x = torch.randn(3, 7, 6, 5, c, device=cuda).to(dtype)
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
    w1, b1, w2, b2, wc, bc = params(C, CMID, CDEC, device=cuda)
    x = torch.randn(20, C, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ts.seg_fwd(x.t().contiguous().t(), w1, b1, w2, b2)
    with pytest.raises(TypeError):
        ts.seg_fwd(x.half(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="shapes"):
        ts.seg_fwd(x, w1[:4], b1, w2, b2)
    with pytest.raises(ValueError, match="up to 64"):
        big = params(72, CMID, CDEC, device=cuda)
        ts.seg_fwd(torch.randn(20, 72, device=cuda), *big[:4])
