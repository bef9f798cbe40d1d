"""The channel widths of the port's "t" stack tier (``ops.tstack
.t_tier_refusal``): every C and C_dec from 1 to 128 runs on the kernel
stack, forward and backward, and agrees with the JAX model's plain stack on
the same converted parameters; beyond 128 a "t" model is not built, and the
"off" model of that width agrees with the JAX plain stack."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probav_tpu.models import WDSRConv3D as JaxWDSR
from probav_tpu_torch.convert import to_state_dict
from probav_tpu_torch.models import WDSRConv3D
from probav_tpu_torch.models import wdsr as port_wdsr
from probav_tpu_torch.ops import tstack as ts

torch.set_num_threads(1)

T = 7
KW = dict(scale=3, num_res_blocks=2, exp_rate=2, decay_rate=0.8,
          patch_size_lr=4, mean=100.0, std=50.0, num_img_lr=T)


def jax_plain(filters, seed, exp_rate=KW["exp_rate"]):
    """(input, params, JAX model with the plain stack): an f32 input of 2
    patches of 10x10xT and a flax init with non-zero biases."""
    x = np.random.default_rng(seed).uniform(0, 300, (2, 10, 10, T, 1)) \
        .astype(np.float32)
    jm = JaxWDSR(num_filters=filters, fused_stack=False,
                 **dict(KW, exp_rate=exp_rate))
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, params)
    return x, params, jm


def test_t_tier_refusal_names_the_kernels_limits():
    """None for every width up to 128, whether or not C divides 128, at
    both directions; beyond 128 the limit is named."""
    for c, c_dec in ((32, 25), (64, 51), (48, 38), (72, 57), (96, 76),
                     (128, 102), (1, 1), (100, 128), (128, 128)):
        assert ts.t_tier_refusal(c, c_dec) is None
        assert ts.t_tier_refusal(c, c_dec, backward=True) is None
    assert "from 1 to 128" in ts.t_tier_refusal(136, 108)
    assert "from 1 to 128" in ts.t_tier_refusal(136, 108, backward=True)
    assert "from 1 to 128" in ts.t_tier_refusal(32, 136)


def test_wide_t_model_raises_and_off_model_matches_jax_plain_stack():
    """136 filters (C_dec 108): a "t" model is refused at construction with
    the kernels' limit; the "off" model agrees with the JAX model's plain
    stack, f32, <= 1e-4 * max|ref| as the flagship model test
    (tests/test_torch_wdsr.py)."""
    with pytest.raises(ValueError, match="from 1 to 128.*fused_stack='off'"):
        WDSRConv3D(num_filters=136, fused_stack="t", **KW)

    x, params, jm = jax_plain(136, seed=5)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    pm = WDSRConv3D(num_filters=136, fused_stack="off", **KW)
    pm.load_state_dict(to_state_dict(params))
    with torch.inference_mode():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 12, 12, 1)
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("filters", [32, 48, 72, 96, 128])
def test_t_model_of_a_forward_width_runs_the_kernel_stack(monkeypatch,
                                                          filters):
    """32 (the flagship), 48, 72, 96 and 128 filters: the "t" model is
    built and its forward goes through the kernel stack."""
    calls = []

    def counted(x, blocks):
        calls.append(len(blocks))
        return ts.stack_apply_5d(x, blocks)

    monkeypatch.setattr(port_wdsr, "stack_apply_5d", counted)
    g = torch.Generator().manual_seed(0)
    pm = WDSRConv3D(num_filters=filters, fused_stack="t", generator=g, **KW)
    x = torch.rand(1, 10, 10, T, 1, generator=g) * 300
    with torch.inference_mode():
        assert torch.isfinite(pm(x)).all()
    assert calls == [KW["num_res_blocks"]]


@pytest.mark.parametrize("filters, exp_rate", [
    pytest.param(48, 2, id="48"), pytest.param(72, 2, id="72"),
    pytest.param(64, 8, id="64")])
def test_t_model_output_and_gradients_match_jax_plain_stack(filters,
                                                             exp_rate):
    """48 (not a divisor of 128) and 72 filters (beyond 64), and 64 at
    exp_rate 8, the 0.9411 model's 64/512/51: the "t" model's output and
    the gradients of one loss through its stack's autograd node (blk_bwd's
    plain twin here) against the JAX model's plain stack on the same
    converted parameters, f32: the output to 1e-4 * max|ref| and every
    gradient leaf to 1e-3 of its max|ref|, as tests/test_tstack.py holds
    the JAX tiers to each other."""
    x, params, jm = jax_plain(filters, seed=filters, exp_rate=exp_rate)

    def loss(p):
        y = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(jnp.square(y / 100.0)), y

    (_, ref), gref = jax.value_and_grad(loss, has_aux=True)(params)
    ref, gref = np.asarray(ref), to_state_dict(gref)

    pm = WDSRConv3D(num_filters=filters, fused_stack="t",
                    **dict(KW, exp_rate=exp_rate))
    pm.load_state_dict(to_state_dict(params))
    names, leaves = zip(*pm.named_parameters())
    out = pm(torch.from_numpy(x))
    grads = torch.autograd.grad(torch.mean(torch.square(out / 100.0)), leaves)
    got = out.detach().numpy()
    assert got.shape == ref.shape == (2, 12, 12, 1)
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()
    assert set(names) == set(gref)
    rel = {n: float((g - gref[n]).abs().max() / (gref[n].abs().max() + 1e-8))
           for n, g in zip(names, grads)}
    assert max(rel.values()) < 1e-3, rel
