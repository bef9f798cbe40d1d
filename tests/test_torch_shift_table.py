"""The port's shift-table module (probav_tpu_torch/ops/shift_table.py) and
ShiftCompensatedLosses(use_kernel=True) against the JAX package's
pallas_shift_loss, Pallas in interpret mode, on the same numpy inputs.  On
the CPU the kernel wrappers run their plain twins, which these tests hold
(the backward twin is the analytic formula, not autograd of the forward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probav_tpu.ops.shift_loss as jsl
from probav_tpu.ops import pallas_shift_loss as psl
from probav_tpu_torch.ops import shift_table as st
from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_mode():
    old = psl.INTERPRET
    psl.INTERPRET = True
    yield
    psl.INTERPRET = old


def make(seed, b, clear=0.8, zero_occluded=False):
    """As tests/test_pallas.py: values over the 16-bit range, ~20% of the
    pixels occluded."""
    r = np.random.default_rng(seed)
    hr = r.uniform(0, 65535, (b, 48, 48, 1)).astype(np.float32)
    mask = (r.uniform(size=(b, 48, 48, 1)) < clear).astype(np.float32)
    pred = r.uniform(0, 65535, (b, 48, 48, 1)).astype(np.float32)
    if zero_occluded:
        hr = hr * mask
    return hr, mask, pred


@pytest.mark.parametrize("b", [8, 5])
@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_table_matches_pallas(kind, b):
    """[S, B] table, rtol 3e-5 (tests/test_pallas.py); B = 5 is below the
    TPU kernel's 8-sample tile, which the port does not pad to."""
    hr, mask, pred = make(b, b)
    want = np.asarray(psl.per_shift_table(kind, *map(jnp.asarray,
                                                     (hr, mask, pred))))
    got = st.per_shift_table(kind, *map(torch.from_numpy, (hr, mask, pred)))
    assert got.shape == (49, b)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5)


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_backward_formula_matches_pallas_vjp(kind):
    """shift_table_bwd_plain for a random cotangent g [B, S] against
    jax.grad of sum(g * table) through the Pallas custom VJP, rtol 1e-4,
    atol 1e-6 max|ref|, the occluded truth zeroed."""
    hr, mask, pred = make(11, 8, zero_occluded=True)
    g = np.random.default_rng(12).normal(size=(8, 49)).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(
        psl.per_shift_table(kind, jnp.asarray(hr), jnp.asarray(mask), p).T
        * g))(jnp.asarray(pred))
    want = np.asarray(want)[..., 0]
    got = st.shift_table_bwd_plain(
        *(torch.from_numpy(a[..., 0]) for a in (hr, mask, pred)),
        torch.from_numpy(g), 3, kind == "l2")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_table_autograd_runs_the_backward_formula(kind):
    """Autograd through per_shift_table gives shift_table_bwd_plain's
    gradient; hr and the mask get none."""
    hr, mask, pred = (torch.from_numpy(a) for a in make(13, 3))
    g = torch.randn(3, 49, generator=torch.Generator().manual_seed(0))
    hr.requires_grad_()
    p = pred.clone().requires_grad_()
    tab = st.per_shift_table(kind, hr, mask, p)
    dp, dhr = torch.autograd.grad((tab.t() * g).sum(), (p, hr),
                                  allow_unused=True)
    want = st.shift_table_bwd_plain(hr.detach()[..., 0], mask[..., 0],
                                    pred[..., 0], g, 3, kind == "l2")
    assert dhr is None
    assert torch.equal(dp[..., 0], want)
    assert dp[:, :3].abs().max() == 0 and dp[:, :, -3:].abs().max() == 0


@pytest.fixture
def pallas_losses(monkeypatch):
    """The JAX package's losses with use_pallas=True; its dispatch takes the
    Pallas kernels only on a TPU, so the test says it is on one (the
    kernels then run in interpret mode)."""
    monkeypatch.setattr(jsl, "_on_tpu", lambda: True)
    return jsl.ShiftCompensatedLosses((48, 48, 1), use_pallas=True)


@pytest.mark.parametrize("name", ["l1", "l2", "cpsnr"])
def test_kernel_losses_match_jax_pallas_losses(pallas_losses, name):
    """l1, l2 (scalars) and cpsnr (per sample), rtol 1e-5."""
    hr, mask, pred = make(20, 8)
    port = ShiftCompensatedLosses((48, 48, 1), use_kernel=True)
    got = getattr(port, name)(*map(torch.from_numpy, (hr, mask, pred)))
    want = getattr(pallas_losses, name)(*map(jnp.asarray, (hr, mask, pred)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("name", ["l1", "l2"])
def test_kernel_per_sample_and_weighted_match_jax(pallas_losses, name):
    hr, mask, pred = make(21, 5)
    w = np.array([1, 0, 1, 1, 0], np.float32)
    port = ShiftCompensatedLosses((48, 48, 1), use_kernel=True)
    t = [torch.from_numpy(a) for a in (hr, mask, pred)]
    j = [jnp.asarray(a) for a in (hr, mask, pred)]
    np.testing.assert_allclose(port.per_sample(name)(*t).numpy(),
                               np.asarray(pallas_losses.per_sample(name)(*j)),
                               rtol=1e-5)
    np.testing.assert_allclose(
        port.weighted(name)(*t, torch.from_numpy(w)).numpy(),
        np.asarray(pallas_losses.weighted(name)(*j, jnp.asarray(w))),
        rtol=1e-5)


@pytest.mark.parametrize("name", ["l1", "l2"])
def test_kernel_loss_gradient_matches_jax(pallas_losses, name):
    hr, mask, pred = make(22, 4, zero_occluded=True)
    port = ShiftCompensatedLosses((48, 48, 1), use_kernel=True)
    p = torch.from_numpy(pred).requires_grad_()
    (g,) = torch.autograd.grad(
        port.by_name(name)(torch.from_numpy(hr), torch.from_numpy(mask), p),
        p)
    gj = np.asarray(jax.grad(lambda q: pallas_losses.by_name(name)(
        jnp.asarray(hr), jnp.asarray(mask), q))(jnp.asarray(pred)))
    np.testing.assert_allclose(g.numpy(), gj, rtol=1e-4,
                               atol=1e-6 * np.abs(gj).max())


def test_kernel_path_equals_plain_path_on_cpu():
    """use_kernel takes the tables from per_shift_table (the plain twins
    here), which agree with the unfold path."""
    hr, mask, pred = (torch.from_numpy(a) for a in make(23, 3))
    a = ShiftCompensatedLosses((48, 48, 1), use_kernel=True)
    b = ShiftCompensatedLosses((48, 48, 1))
    for name in ("l1", "l2", "cpsnr"):
        torch.testing.assert_close(getattr(a, name)(hr, mask, pred),
                                   getattr(b, name)(hr, mask, pred),
                                   rtol=1e-5, atol=0)


def test_kernel_path_not_taken_where_unsupported(monkeypatch):
    """Multichannel patches keep the unfold path (as _maybe_pallas)."""
    monkeypatch.setattr(st, "per_shift_table", None)   # any call fails
    r = np.random.default_rng(24)
    hr, mask, pred = (torch.from_numpy(r.uniform(0, 100, (2, 12, 12, 3))
                                       .astype(np.float32))
                      for _ in range(3))
    loss = ShiftCompensatedLosses((12, 12, 3), use_kernel=True)
    assert torch.isfinite(loss.l2(hr, (mask > 50).float(), pred))


@pytest.mark.parametrize("shape,border,ok", [
    ((2, 48, 48, 1), 3, True), ((2, 48, 48, 3), 3, False),
    ((2, 48, 42, 1), 3, False), ((2, 6, 6, 1), 3, False),
    ((2, 7, 7, 1), 3, True), ((48, 48, 1), 3, False)])
def test_supports_gate(shape, border, ok):
    """The gate of pallas_shift_loss.supports, case by case."""
    assert st.supports(torch.zeros(shape), border) is ok
    assert psl.supports(jnp.zeros(shape), border) is ok


@pytest.mark.parametrize("size", [48, 130, 131, 384])
def test_supports_gate_at_patch_and_scene_sizes(size):
    """The gate is JAX's at every size: the card's launchers, not the
    gate, refuse planes beyond their shared memory (the card test
    test_kernel_loss_cpsnr_refuses_planes_beyond_shared_memory_on_card)."""
    assert st.supports(torch.zeros(2, size, size, 1), 3)
    assert psl.supports(jnp.zeros((2, size, size, 1)), 3)


def test_kernel_loss_cpsnr_of_a_scene_on_cpu_runs_the_plain_twin():
    """cPSNR of 384^2 scenes with use_kernel on CPU tensors: the table's
    plain twin, within 1e-5 of the unfold path."""
    hr, mask, pred = (torch.from_numpy(a) for a in make(25, 2))
    big = lambda a: a.repeat(1, 8, 8, 1)                      # 384^2
    want = ShiftCompensatedLosses((384, 384, 1)).cpsnr(
        big(hr), big(mask), big(pred))
    got = ShiftCompensatedLosses((384, 384, 1), use_kernel=True).cpsnr(
        big(hr), big(mask), big(pred))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
