"""The channel widths of the port's "t" stack tier (``ops.tstack
.t_tier_refusal``): a "t" model of a width the kernels refuse is not
built, and the "off" model of that width agrees with the JAX model's plain
stack on the same converted parameters."""

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


def test_t_tier_refusal_names_the_kernels_limits():
    assert ts.t_tier_refusal(32, 25) is None
    assert ts.t_tier_refusal(64, 51, backward=True) is None
    assert "up to 64" in ts.t_tier_refusal(72, 57)
    assert "up to 64" in ts.t_tier_refusal(32, 72)
    # 48 channels: the forward kernels take them, blk_bwd does not.
    assert ts.t_tier_refusal(48, 38) is None
    assert "divides 128" in ts.t_tier_refusal(48, 38, backward=True)


def test_wide_t_model_raises_and_off_model_matches_jax_plain_stack():
    """72 filters (C_dec 57): a "t" model is refused at construction with
    the kernels' limit; the "off" model agrees with the JAX model's plain
    stack, f32, <= 1e-4 * max|ref| as the flagship model test
    (tests/test_torch_wdsr.py)."""
    with pytest.raises(ValueError, match="up to 64.*fused_stack='off'"):
        WDSRConv3D(num_filters=72, fused_stack="t", **KW)

    x = np.random.default_rng(5).uniform(0, 300, (2, 10, 10, T, 1)) \
        .astype(np.float32)
    jm = JaxWDSR(num_filters=72, fused_stack=False, **KW)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))

    pm = WDSRConv3D(num_filters=72, fused_stack="off", **KW)
    pm.load_state_dict(to_state_dict(params))
    with torch.inference_mode():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 12, 12, 1)
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("filters", [32, 48])
def test_t_model_of_a_forward_width_runs_the_kernel_stack(monkeypatch,
                                                          filters):
    """32 (the flagship) and 48 filters: the "t" model is built and its
    forward goes through the kernel stack."""
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
