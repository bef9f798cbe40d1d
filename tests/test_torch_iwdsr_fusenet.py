"""The port's off-main models and their layers against the JAX package, on
parameters converted from a flax init: InstanceNorm, mish, flax-style
Conv, IWDSRConv3D (instance norm + mish WDSR) and FuseNetConv2D v1-v3."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probav_tpu.config import Config as JaxConfig
from probav_tpu.models import build_model as jax_build_model
from probav_tpu.models.layers import InstanceNorm as JaxInstanceNorm
from probav_tpu.models.layers import mish as jax_mish
from probav_tpu.models.wdsr import FuseNetConv2D as JaxFuseNet
from probav_tpu.models.wdsr import IWDSRConv3D as JaxIWDSR
from probav_tpu_torch.config import Config
from probav_tpu_torch.convert import to_state_dict
from probav_tpu_torch.models import (Conv, FuseNetConv2D, IWDSRConv3D,
                                     InstanceNorm, build_model, mish)
from probav_tpu_torch.models.layers import same_pads

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "cfg", "p16t9c85r12.cfg")

KW = dict(scale=3, num_filters=4, exp_rate=4, decay_rate=0.8,
          patch_size_lr=4, mean=100.0, std=50.0)
# float32, against max|ref|: the same products summed in another order
# (convs over 3^3 taps and instance-norm statistics over every position).
FWD_TOL = 1e-5
# Gradients, per leaf: ||got - ref|| <= GRAD_TOL * ||ref|| + GRAD_FLOOR *
# (the largest leaf's ||ref||).  GRAD_TOL: sums over the batch and every
# position in another order, through the instance norms' backward, which
# subtracts means of products (measured <= 2e-5).  GRAD_FLOOR: an
# instance norm is blind to a shift of its input, and to a scale but for
# its eps, so the gradients of every conv's bias (and of a beta that only
# another conv and norm follow) vanish and those of wn_g nearly do; both
# packages leave rounding noise there, ~1e-7 of the largest leaf.
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-6


def bumped(params):
    """Non-zero biases (and betas), so that their paths count."""
    return jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, params)


def rel_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("shape", [(2, 5, 6, 3), (2, 5, 6, 4, 3)],
                         ids=["2d", "3d"])
def test_instance_norm_matches_flax(shape):
    r = np.random.default_rng(len(shape))
    x = (r.normal(0, 3, shape) + 7).astype(np.float32)
    params = bumped(JaxInstanceNorm().init(jax.random.PRNGKey(0),
                                           jnp.asarray(x))["params"])
    ref = np.asarray(JaxInstanceNorm().apply({"params": params},
                                             jnp.asarray(x)))
    m = InstanceNorm(shape[-1])
    m.load_state_dict(to_state_dict(params))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert rel_err(got, ref) < FWD_TOL
    # the init is keras's U(-0.05, 0.05), from the caller's generator
    a = InstanceNorm(64, generator=torch.Generator().manual_seed(1))
    assert a.gamma.abs().max() <= 0.05 and a.beta.abs().max() <= 0.05
    assert not torch.equal(a.gamma, a.beta)


def test_mish_matches_flax():
    """F.mish against x * tanh(log1p(exp(x))) at |x| <= 30: within one
    float32 ulp of max(|x|, 1), 2**-22 of it (tanh and softplus round
    otherwise)."""
    x = np.linspace(-30, 30, 2001, dtype=np.float32)
    got = mish(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_mish(jnp.asarray(x)))
    assert np.all(np.abs(got - ref) <= 2.0 ** -22 * np.maximum(np.abs(x), 1))


@pytest.mark.parametrize("size,kernel,stride", [(9, 4, 1), (10, 3, 3),
                                                (16, 8, 8), (12, 6, 1)])
def test_conv_matches_flax_same(size, kernel, stride):
    """flax nn.Conv's SAME at even kernels and strides (XLA pads lo =
    total // 2), on its own kernel and a non-zero bias."""
    from flax import linen as fnn

    r = np.random.default_rng(size + kernel)
    x = r.normal(size=(2, size, size, 3)).astype(np.float32)
    jm = fnn.Conv(5, (kernel, kernel), strides=(stride, stride),
                  padding="SAME")
    params = bumped(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    m = Conv(3, 5, (kernel, kernel), (stride, stride))
    m.load_state_dict(to_state_dict(params))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    assert rel_err(got, ref) < FWD_TOL
    assert same_pads(384, 48, 1) == (23, 24)


@pytest.mark.parametrize("blocks", [1, 2])
def test_iwdsr_matches_jax(blocks):
    """Forward and every parameter's gradient of a loss on the output,
    band statistics passed as data (not the baked mean/std)."""
    r = np.random.default_rng(blocks)
    x = r.uniform(0, 300, (2, 10, 10, 9, 1)).astype(np.float32)
    norm = np.asarray([90.0, 40.0], np.float32)
    cot = r.normal(size=(2, 12, 12, 1)).astype(np.float32)
    jm = JaxIWDSR(num_res_blocks=blocks, **KW)
    params = bumped(jax.jit(jm.init)(jax.random.PRNGKey(blocks),
                                     jnp.asarray(x))["params"])

    def jloss(p):
        y = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(norm))
        return jnp.sum(y * jnp.asarray(cot)), y

    (_, ref), gref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    pm = IWDSRConv3D(num_res_blocks=blocks, **KW)
    state = to_state_dict(params)
    assert set(state) == set(pm.state_dict())
    pm.load_state_dict(state)
    y = pm(torch.from_numpy(x), torch.from_numpy(norm))
    assert y.shape == ref.shape == (2, 12, 12, 1)
    assert rel_err(y.detach().numpy(), np.asarray(ref)) < FWD_TOL
    names = list(dict(pm.named_parameters()))
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                list(pm.parameters()))
    gflat = {k: v.numpy() for k, v in to_state_dict(gref).items()}
    floor = GRAD_FLOOR * max(np.linalg.norm(v) for v in gflat.values())
    for name, g in zip(names, grads):
        want = gflat[name]
        err = np.linalg.norm(g.numpy() - want)
        assert err <= GRAD_TOL * np.linalg.norm(want) + floor, (name, err)


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_fusenet_matches_jax(variant):
    """Forward at 96x96 (v3's 48x48 conv pads 23, 24; v2's stride 8 and
    v1's stride 3 pad nothing); ``norm`` is ignored.  The input lies in
    [0, 1), so that ``x + correction`` keeps the correction's digits (the
    instance norms make it blind to the input's scale)."""
    r = np.random.default_rng(len(variant))
    x = r.uniform(0, 1, (2, 96, 96, 1)).astype(np.float32)
    jm = JaxFuseNet(variant=variant)
    params = bumped(jax.jit(jm.init)(jax.random.PRNGKey(3),
                                     jnp.asarray(x))["params"])
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    pm = FuseNetConv2D(variant)
    pm.load_state_dict(to_state_dict(params))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.tensor([5.0, 2.0])).numpy()
    assert got.shape == ref.shape == x.shape and got.dtype == np.float32
    # the output is x + a correction: hold the correction
    assert rel_err(got - x, ref - x) < FWD_TOL


@pytest.mark.parametrize("model_type,count", [("wdsr", 535_267),
                                              ("iwdsr", 545_402),
                                              ("fusenet", 147_648)])
def test_build_model_parameter_counts_equal_jax(model_type, count):
    """At the flagship cfg: the port's counts against jax.eval_shape of the
    JAX package's init, and the top-level entries' names."""
    jm = jax_build_model(JaxConfig.from_file(CFG), "NIR",
                         model_type=model_type)
    x = (jnp.zeros((1, 384, 384, 1)) if model_type == "fusenet" else
         jnp.zeros((1, 22, 22, 9, 1)))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"]
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    pm = build_model(Config.from_file(CFG), "NIR", model_type=model_type)
    assert sum(p.numel() for p in pm.parameters()) == want == count
    assert {k.split(".")[0] for k in pm.state_dict()} == set(shapes)


def test_build_model_refuses_an_unknown_type():
    with pytest.raises(ValueError, match="model_type"):
        build_model(CFG, "NIR", model_type="fusionNet")


def test_build_model_fusenet_is_float32_only():
    """FuseNet has no bf16 path in the port (the CLI refuses --bf16 with
    fusionNet); build_model says so instead of dropping the dtype."""
    with pytest.raises(ValueError, match="float32"):
        build_model(CFG, "NIR", dtype=torch.bfloat16, model_type="fusenet")
