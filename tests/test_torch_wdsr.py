"""Parity of the port's WDSRConv3D (probav_tpu_torch/models) with the JAX
flagship model, on parameters converted from a flax init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probav_tpu.ops.pallas_tstack as jts
from probav_tpu.models import WDSRConv3D as JaxWDSR
from probav_tpu.models import reduction_schedule as jax_schedule
from probav_tpu.models.layers import reflect_pad as jax_reflect_pad
from probav_tpu.ops.patches import depth_to_space as jax_d2s
from probav_tpu_torch.convert import to_state_dict
from probav_tpu_torch.models import WDSRConv3D, reduction_schedule, \
    reflect_pad
from probav_tpu_torch.ops.patches import depth_to_space

torch.set_num_threads(1)

KW = dict(scale=3, num_filters=8, num_res_blocks=2, exp_rate=4,
          decay_rate=0.8, patch_size_lr=4, mean=100.0, std=50.0)


@pytest.fixture(autouse=True)
def _interpret():
    old = jts.INTERPRET
    jts.INTERPRET = True
    yield
    jts.INTERPRET = old


@pytest.mark.parametrize("t", [7, 9, 13, 19])
def test_reduction_schedule_matches_jax(t):
    assert reduction_schedule(t, 3) == jax_schedule(t, 3)


@pytest.mark.parametrize("t", [7, 9])
def test_model_matches_jax_fused_stack_t(t):
    """Port WDSRConv3D (stack on the kernels' plain versions here) against
    JAX WDSRConv3D(fused_stack="t") with its Pallas stack interpreted, the
    band statistics passed as data.  f32, <= 1e-4 * max|ref|."""
    r = np.random.default_rng(20 + t)
    x = r.uniform(0, 300, (2, 10, 10, t, 1)).astype(np.float32)
    norm = np.asarray([90.0, 40.0], np.float32)   # not the baked 100/50
    jm = JaxWDSR(num_img_lr=t, fused_stack="t", **KW)
    params = JaxWDSR(num_img_lr=t, **KW).init(
        jax.random.PRNGKey(t), jnp.asarray(x))["params"]
    # Non-zero biases so that the bias paths are exercised too.
    params = jax.tree.map(
        lambda a: a + 0.05 if a.ndim == 1 else a, params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(norm)))

    pm = WDSRConv3D(num_img_lr=t, fused_stack=True, **KW)
    pm.load_state_dict(to_state_dict(params))
    with torch.inference_mode():
        got = pm(torch.from_numpy(x), torch.from_numpy(norm)).numpy()
    assert got.shape == ref.shape == (2, 12, 12, 1)
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("cout", [1, 2])
def test_depth_to_space_matches_tf_order(cout):
    x = np.random.default_rng(cout).normal(size=(2, 3, 4, 9 * cout)) \
        .astype(np.float32)
    got = depth_to_space(torch.from_numpy(x), 3).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_d2s(jnp.asarray(x), 3)))
    if cout == 1:   # pixel_shuffle agrees with TF order only at C_out = 1
        ps = torch.nn.functional.pixel_shuffle(
            torch.from_numpy(x).permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got, ps.numpy())


def test_reflect_pad_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 6, 7, 5, 3)) \
        .astype(np.float32)
    for pads in ((1, 1, 0), (2, 2, 1)):
        got = reflect_pad(torch.from_numpy(x), pads).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jax_reflect_pad(jnp.asarray(x), pads)))


def test_plain_and_kernel_stack_models_agree():
    """fused_stack=False (WDSRBlock convs) and the stack path share one
    parameter set and agree in f32."""
    g = torch.Generator().manual_seed(0)
    a = WDSRConv3D(num_img_lr=9, fused_stack=True, generator=g, **KW)
    b = WDSRConv3D(num_img_lr=9, fused_stack=False, **KW)
    b.load_state_dict(a.state_dict())
    x = torch.rand(2, 10, 10, 9, 1, generator=g) * 300
    with torch.inference_mode():
        ya, yb = a(x), b(x)
    assert (ya - yb).abs().max() < 1e-4 * yb.abs().max()
