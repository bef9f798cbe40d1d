"""The cfg losses ``sobel_l1_mix`` and ``l1msssim`` and the models
``IWDSRConv3D`` and ``FuseNetConv2D`` on a card against the same functions
on CPU tensors, float32 with TF32 off (the JAX package is held to the CPU
side by tests/test_torch_sobel_msssim.py and
tests/test_torch_iwdsr_fusenet.py).

This file imports neither JAX nor the JAX package, so the ``cuda`` tests
also run on a machine without them:

    python -m pytest tests/test_torch_card_losses_models.py -m cuda \\
        --noconftest
"""

import numpy as np
import pytest
import torch

from probav_tpu_torch.models import FuseNetConv2D, IWDSRConv3D
from probav_tpu_torch.ops import tstack
from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses

torch.set_num_threads(1)

S = 48
# Relative to |ref| (the loss) and norm-wise (d loss / d pred): float32
# sums in another order; rev_msssim's variances cancel (E[x^2] - mu^2).
LOSS_TOL = {"sobel_l1_mix": 1e-5, "l1msssim": 1e-4}
GRAD_TOL = 1e-4
# Model forwards against max|ref| (of the correction, for FuseNet): cuDNN's
# convs and the instance norms' statistics sum in another order.
MODEL_TOL = 1e-4
# IWDSR's gradients per leaf, as tests/test_torch_iwdsr_fusenet.py holds
# them: ||got - ref|| <= 1e-4 ||ref|| + 1e-6 of the largest leaf's norm
# (the conv biases' gradients vanish under the instance norms, leaving
# rounding noise on both devices).
GRAD_FLOOR = 1e-6
IWDSR_KW = dict(scale=3, num_filters=8, num_res_blocks=2, exp_rate=4,
                decay_rate=0.8, patch_size_lr=16, mean=7000.0, std=2000.0)


def batch(n, seed):
    """HR (occluded pixels zeroed), mask, pred in the 16-bit range."""
    r = np.random.default_rng(seed)
    hr = r.uniform(4000, 12000, (n, S, S, 1)).astype(np.float32)
    mask = (r.uniform(size=hr.shape) < 0.8).astype(np.float32)
    pred = (hr + r.normal(0, 300, hr.shape)).astype(np.float32)
    return [torch.from_numpy(a) for a in (hr * mask, mask, pred)]


def loss_and_grad(losses, name, hr, mask, pred):
    p = pred.clone().requires_grad_()
    loss = losses.by_name(name)(hr, mask, p)
    (g,) = torch.autograd.grad(loss, p)
    return float(loss.detach()), g.cpu()


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["sobel_l1_mix", "l1msssim"])
def test_losses_run_plain_on_the_cpu_without_kernels(name):
    """Neither loss reaches a kernel: no stack or shift-table launch, and
    the weighted form of a full batch equals the loss."""
    from probav_tpu_torch.ops import shift_table

    losses = ShiftCompensatedLosses((S, S, 1), use_kernel=True)
    hr, mask, pred = batch(2, 0)
    before = (dict(tstack.LAUNCHES), dict(shift_table.LAUNCHES))
    loss = losses.by_name(name)(hr, mask, pred)
    w = losses.weighted(name)(hr, mask, pred, torch.ones(2))
    assert torch.isfinite(loss) and abs(float(w - loss)) <= 1e-6 * abs(
        float(loss))
    assert (dict(tstack.LAUNCHES), dict(shift_table.LAUNCHES)) == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 128])
@pytest.mark.parametrize("name", ["sobel_l1_mix", "l1msssim"])
def test_loss_on_the_card_matches_the_cpu(cuda, name, n):
    losses = ShiftCompensatedLosses((S, S, 1))
    cpu = batch(n, n)
    ref, gref = loss_and_grad(losses, name, *cpu)
    got, g = loss_and_grad(losses, name, *(a.to(cuda) for a in cpu))
    assert abs(got - ref) <= LOSS_TOL[name] * abs(ref)
    assert float((g - gref).norm() / gref.norm()) <= GRAD_TOL


@pytest.mark.cuda
def test_iwdsr_on_the_card_matches_the_cpu(cuda):
    """Forward, and every parameter's gradient of a loss on the output."""
    g = torch.Generator().manual_seed(0)
    model = IWDSRConv3D(**IWDSR_KW, generator=g)
    x = torch.rand(4, 22, 22, 9, 1, generator=g) * 8000 + 3000
    cot = torch.randn(4, 48, 48, 1, generator=g)
    outs = {}
    for dev in ("cpu", cuda):
        m = model.to(dev)
        y = m(x.to(dev))
        grads = torch.autograd.grad((y * cot.to(dev)).sum(),
                                    list(m.parameters()))
        outs[str(dev)] = (y.detach().cpu(), [t.cpu() for t in grads])
    (yc, gc), (yg, gg) = outs["cpu"], outs[str(cuda)]
    assert float((yg - yc).abs().max() / yc.abs().max()) <= MODEL_TOL
    floor = GRAD_FLOOR * max(float(b.norm()) for b in gc)
    for name, a, b in zip(dict(model.named_parameters()), gg, gc):
        assert float((a - b).norm()) <= GRAD_TOL * float(b.norm()) + floor, \
            name


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_fusenet_on_the_card_matches_the_cpu(cuda, variant):
    g = torch.Generator().manual_seed(1)
    model = FuseNetConv2D(variant, generator=g)
    x = torch.rand(2, 384, 384, 1, generator=g)
    with torch.no_grad():
        ref = model(x) - x
        got = model.to(cuda)(x.to(cuda)).cpu() - x
    assert float((got - ref).abs().max() / ref.abs().max()) <= MODEL_TOL
