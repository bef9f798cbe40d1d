"""The port's Sobel edges and its two other cfg losses, ``sobel_l1_mix``
(l1_edge) and ``l1msssim`` (rev_msssim), against the JAX package's and the
numpy oracles of tests/oracles.py, on 48x48 patches (42x42 crops)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import rev_msssim_oracle, sobel_edges_oracle
from probav_tpu.ops.shift_loss import ShiftCompensatedLosses as JaxLosses
from probav_tpu.ops.sobel import sobel_edges as jax_sobel
from probav_tpu_torch.ops.shift_loss import (ShiftCompensatedLosses,
                                             jnp_linspace)
from probav_tpu_torch.ops.sobel import sobel_edges

torch.set_num_threads(1)

B, S = 3, 48
NAMES = ("l1", "l2", "sobel_l1_mix", "l1msssim")
# Relative tolerances.  l1_edge: float32 sums over 42x42 (and the Sobel
# adds) in another order, as l1/l2 (tests/test_torch_shift_loss.py).
# rev_msssim: its variances are E[x^2] - mu^2 of 16-bit values, which
# cancel in float32, so summation order moves them by ~1e-5 relative;
# the window exponentiates linspace (e^42 at sigma 0.5), which the port
# computes as JAX does.
TOL = {"sobel_l1_mix": 1e-5, "l1msssim": 1e-4}
# Gradients, norm-wise ||got - ref|| / ||ref||: a residual within a
# rounding of 0 may take the other L1 sign in either package.
GRAD_TOL = 1e-4


def batch(seed=0, clear=0.8, n=B):
    """HR, mask (~20% occluded), pred in the 16-bit range; no ties."""
    r = np.random.default_rng(seed)
    hr = r.uniform(4000, 12000, (n, S, S, 1)).astype(np.float32)
    mask = (r.uniform(size=hr.shape) < clear).astype(np.float32)
    pred = (hr + r.normal(0, 300, hr.shape)).astype(np.float32)
    return hr, mask, pred


@pytest.fixture(scope="module")
def losses():
    return (ShiftCompensatedLosses(target_shape=(S, S, 1)),
            JaxLosses(target_shape=(S, S, 1)))


def close(got, ref, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=0)


@pytest.mark.parametrize("shape", [(2, 9, 11, 1), (1, 6, 5, 3)])
def test_sobel_edges_match_jax_and_oracle(shape):
    """Exact on integers (the adds are exact there); within 1e-6 of
    max|ref| on floats against the float64 oracle."""
    r = np.random.default_rng(sum(shape))
    ints = r.integers(0, 65535, shape).astype(np.float32)
    got = sobel_edges(torch.from_numpy(ints)).numpy()
    assert got.shape == shape + (2,)
    np.testing.assert_array_equal(got, sobel_edges_oracle(ints))
    np.testing.assert_array_equal(got, np.asarray(jax_sobel(
        jnp.asarray(ints))))
    floats = r.normal(0, 1000, shape).astype(np.float32)
    ref = sobel_edges_oracle(floats)
    got = sobel_edges(torch.from_numpy(floats)).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("h", [5, 42, 47, 48, 96])
def test_linspace_is_jax_bit_for_bit(h):
    """The MS-SSIM window's coordinates at the crop sizes of 11-, 48-,
    53-, 54- and 102-pixel patches (beyond 48 the window overflows
    float32 in both packages)."""
    got = jnp_linspace(-h / 2.0, h / 2.0, h)
    np.testing.assert_array_equal(got, np.asarray(
        jnp.linspace(-h / 2.0, h / 2.0, h)))


@pytest.mark.parametrize("name", ["sobel_l1_mix", "l1msssim"])
def test_loss_matches_jax(losses, name):
    port, jx = losses
    hr, mask, pred = batch(1)
    got = port.by_name(name)(*map(torch.from_numpy, (hr, mask, pred)))
    ref = jx.by_name(name)(*map(jnp.asarray, (hr, mask, pred)))
    close(got, ref, TOL[name])
    if name == "l1msssim":
        close(got, rev_msssim_oracle(hr.astype(np.float64),
                                     mask.astype(np.float64),
                                     pred.astype(np.float64)), TOL[name])


def test_l1_edge_per_sample_matches_jax(losses):
    port, jx = losses
    hr, mask, pred = batch(2)
    t = [torch.from_numpy(a) for a in (hr, mask, pred)]
    ps = port.per_sample("sobel_l1_mix")(*t)
    close(ps, jx.per_sample("sobel_l1_mix")(*map(jnp.asarray,
                                                 (hr, mask, pred))),
          TOL["sobel_l1_mix"])
    close(ps.mean(), port.l1_edge(*t), 1e-6)
    assert port.per_sample("l1msssim") is None


@pytest.mark.parametrize("name", ["sobel_l1_mix", "l1msssim"])
def test_weighted_under_wrap_padding(losses, name):
    """Three real rows wrap-padded to five with weight-0 rows, as the
    trainer pads a ragged eval batch: equal to the loss of the three rows
    and to JAX's weighted loss on the padded batch."""
    port, jx = losses
    hr, mask, pred = batch(3)
    pad = lambda a: np.resize(a, (5,) + a.shape[1:])
    w = np.array([1, 1, 1, 0, 0], np.float32)
    padded = [pad(a) for a in (hr, mask, pred)]
    got = port.weighted(name)(*map(torch.from_numpy, padded),
                              torch.from_numpy(w))
    close(got, jx.weighted(name)(*map(jnp.asarray, padded), jnp.asarray(w)),
          TOL[name])
    close(got, port.by_name(name)(*map(torch.from_numpy, (hr, mask, pred))),
          TOL[name])


@pytest.mark.parametrize("name", ["sobel_l1_mix", "l1msssim"])
def test_loss_gradient_matches_jax(losses, name):
    """d loss / d pred against jax.grad, norm-wise; the occluded truth is
    zeroed so that the L1 terms' gradient is not rounding noise (see
    tests/test_torch_shift_loss.py)."""
    port, jx = losses
    hr, mask, pred = batch(4)
    hr = hr * mask
    p = torch.from_numpy(pred).requires_grad_()
    loss = port.by_name(name)(torch.from_numpy(hr), torch.from_numpy(mask),
                              p)
    (g,) = torch.autograd.grad(loss, p)
    gj = np.asarray(jax.grad(lambda q: jx.by_name(name)(
        jnp.asarray(hr), jnp.asarray(mask), q))(jnp.asarray(pred)))
    assert np.abs(gj).max() > 0
    err = np.linalg.norm(g.numpy() - gj) / np.linalg.norm(gj)
    assert err <= GRAD_TOL, err


@pytest.mark.parametrize("name", NAMES)
def test_by_name_takes_every_cfg_key(losses, name):
    port, jx = losses
    hr, mask, pred = batch(5)
    got = port.by_name(name)(*map(torch.from_numpy, (hr, mask, pred)))
    ref = jx.by_name(name)(*map(jnp.asarray, (hr, mask, pred)))
    close(got, ref, TOL.get(name, 1e-5))
    assert callable(port.weighted(name))


def test_unknown_key_raises(losses):
    port, _ = losses
    for fn in (port.by_name, port.per_sample, port.weighted):
        with pytest.raises(KeyError):
            fn("l3")


def test_msssim_window_is_built_once_per_crop_size():
    """The [5, h, h] window is made on the host once and reused, so a step
    on the card copies nothing from the host; a second call scores the
    same."""
    port = ShiftCompensatedLosses(target_shape=(S, S, 1))
    args = [torch.from_numpy(a) for a in batch(6)]
    first = port.rev_msssim(*args)
    (window,) = port._w2.values()
    assert window.shape == (5, S - 6, S - 6) and window.dtype == torch.float32
    assert torch.equal(port.rev_msssim(*args), first)
    assert len(port._w2) == 1 and next(iter(port._w2.values())) is window
