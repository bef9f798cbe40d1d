"""The port's shift-compensated losses (probav_tpu_torch/ops/shift_loss.py)
against the JAX package's and the numpy oracle of tests/oracles.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import shift_losses_oracle
from probav_tpu.ops.shift_loss import ShiftCompensatedLosses as JaxLosses
from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses

torch.set_num_threads(1)

B, S = 3, 48
TOL = 1e-5              # relative; float32 sums over 42x42 in another order


def batch(seed=0, clear=0.8):
    """HR, mask (partly masked: ~20% occluded), pred in the 16-bit range."""
    r = np.random.default_rng(seed)
    hr = r.uniform(4000, 12000, (B, S, S, 1)).astype(np.float32)
    mask = (r.uniform(size=hr.shape) < clear).astype(np.float32)
    pred = (hr + r.normal(0, 300, hr.shape)).astype(np.float32)
    return hr, mask, pred


@pytest.fixture(scope="module")
def losses():
    return (ShiftCompensatedLosses(target_shape=(S, S, 1)),
            JaxLosses(target_shape=(S, S, 1)))


def close(got, ref, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=0)


@pytest.mark.parametrize("name", ["l1", "l2", "cpsnr"])
def test_losses_match_jax_and_oracle(losses, name):
    port, jx = losses
    hr, mask, pred = batch(1)
    got = getattr(port, name)(*map(torch.from_numpy, (hr, mask, pred)))
    close(got, getattr(jx, name)(*map(jnp.asarray, (hr, mask, pred))))
    oracle = shift_losses_oracle(hr.astype(np.float64),
                                 mask.astype(np.float64),
                                 pred.astype(np.float64))
    close(got, oracle[name], 1e-4)


def test_per_shift_tables_match_oracle(losses):
    port, _ = losses
    hr, mask, pred = batch(2)
    oracle = shift_losses_oracle(hr, mask, pred)
    t = lambda a: torch.from_numpy(a)
    close(port._per_shift("l1", t(hr), t(mask), t(pred)),
          oracle["l1_table"], 1e-4)
    close(port._per_shift("l2", t(hr), t(mask), t(pred)),
          oracle["l2_table"], 1e-4)


@pytest.mark.parametrize("name", ["l1", "l2"])
def test_per_sample_and_weighted_match_jax(losses, name):
    port, jx = losses
    hr, mask, pred = batch(3)
    w = np.array([1.0, 0.0, 1.0], np.float32)
    t = [torch.from_numpy(a) for a in (hr, mask, pred)]
    j = [jnp.asarray(a) for a in (hr, mask, pred)]
    ps = port.per_sample(name)(*t)
    close(ps, jx.per_sample(name)(*j))
    close(ps.mean(), port.by_name(name)(*t))
    close(port.weighted(name)(*t, torch.from_numpy(w)),
          jx.weighted(name)(*j, jnp.asarray(w)))
    # the weight-0 row does not count: equal to the loss of the other two
    keep = [0, 2]
    close(port.weighted(name)(*t, torch.from_numpy(w)),
          port.by_name(name)(*(a[keep] for a in t)))


@pytest.mark.parametrize("clear", [1.0, 0.8], ids=["clear", "masked"])
@pytest.mark.parametrize("name", ["l1", "l2"])
def test_loss_gradient_matches_jax(losses, name, clear):
    """With occluded truth left at ~8000, the bias term makes every clear
    residual one sign and the L1 gradient vanishes; the masked case zeroes
    the occluded truth so that the gradient is not rounding noise."""
    port, jx = losses
    hr, mask, pred = batch(4, clear)
    hr = hr * mask
    p = torch.from_numpy(pred).requires_grad_()
    loss = port.by_name(name)(torch.from_numpy(hr), torch.from_numpy(mask),
                              p)
    (g,) = torch.autograd.grad(loss, p)
    gj = jax.grad(lambda q: jx.by_name(name)(jnp.asarray(hr),
                                             jnp.asarray(mask), q))(
        jnp.asarray(pred))
    gj = np.asarray(gj)
    assert np.abs(g.numpy() - gj).max() <= 1e-4 * np.abs(gj).max()


def test_unknown_loss_name_raises(losses):
    """Every cfg key is ported (tests/test_torch_sobel_msssim.py holds the
    two others); an unknown key raises KeyError, as JAX's dict lookup."""
    port, jx = losses
    for name in ("sobel_l1_mix", "l1msssim"):
        assert callable(port.by_name(name))
        assert callable(port.weighted(name))
    for fn in (port.by_name, port.per_sample, port.weighted):
        with pytest.raises(KeyError):
            fn("ssim")
    with pytest.raises(KeyError):
        jx.by_name("ssim")
