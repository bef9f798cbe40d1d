"""The port's train step (ModelTrainer.train_step: kernel stack with its
autograd node, shift L1 loss, nadam) against the JAX train step (flax
WDSRConv3D with the fused Pallas stack in interpret mode, jax.value_and_grad,
optax.nadam) from the same converted parameters on the same batches.

Gradients and the loss are compared at every step, tightly.  Parameters
after the steps are compared in units of the learning rate: nadam's first
updates are about -1.47 lr * sign(g) for every gradient element well above
eps, so an element whose gradient is within the two frameworks' rounding
of zero could move the other way (2.9 lr apart); on these inputs none does,
and the parameters agree to 1e-2 lr at float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import probav_tpu.ops.pallas_tstack as jts
from probav_tpu.models import WDSRConv3D as JaxWDSR
from probav_tpu.ops import ShiftCompensatedLosses as JaxLosses
from probav_tpu_torch import convert
from probav_tpu_torch.models.wdsr import WDSRConv3D
from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
from probav_tpu_torch.tools.profile_train import synthetic_batch
from probav_tpu_torch.train.optim import build_optimizer
from probav_tpu_torch.train.trainer import ModelTrainer

torch.set_num_threads(1)

LR = 1e-3
MEAN, STD = 8000.0, 3000.0
NET = dict(scale=3, num_filters=8, num_res_blocks=2, exp_rate=2,
           decay_rate=0.8, num_img_lr=9, patch_size_lr=16, mean=MEAN,
           std=STD)
B, STEPS = 2, 3


@pytest.fixture(autouse=True)
def _interpret():
    old = jts.INTERPRET
    jts.INTERPRET = True
    yield
    jts.INTERPRET = old


def batches():
    out = []
    for s in range(STEPS):
        lr, hr, mask = synthetic_batch(B, seed=10 + s, hr_clear=0.9)
        out.append((lr, hr * mask, mask))   # occluded truth zeroed: see
    return out                              # test_torch_shift_loss.py


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def run(dtype_j, dtype_t, tmp_path, n_steps=STEPS):
    jm = JaxWDSR(**NET, dtype=dtype_j, fused_stack="t")
    data = batches()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(data[0][0]),
                     jnp.asarray([MEAN, STD]))["params"]
    jl = JaxLosses(target_shape=(48, 48, 1))
    tx = optax.nadam(LR)
    opt_state = tx.init(params)
    norm = jnp.asarray([MEAN, STD], jnp.float32)

    model = WDSRConv3D(**NET, dtype=dtype_t, fused_stack=True)
    model.load_state_dict(convert.to_state_dict(params))
    tl = ShiftCompensatedLosses(target_shape=(48, 48, 1))
    tr = ModelTrainer(model, tl.l1, tl.cpsnr, build_optimizer("nadam", LR),
                      str(tmp_path / "ckpt"), str(tmp_path / "logs"),
                      device="cpu")
    tr.init_state()

    @jax.jit
    def jax_step(params, opt_state, lr, hr, mask):
        def objective(p):
            pred = jm.apply({"params": p}, lr, norm)
            return jl.l1(hr, mask, pred), pred
        (loss, pred), grads = jax.value_and_grad(objective, has_aux=True)(
            params)
        metric = jnp.mean(jl.cpsnr(hr, mask, pred))
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state, loss,
                metric, grads)

    steps = []
    for lr, hr, mask in data[:n_steps]:
        params, opt_state, loss_j, metric_j, g_j = jax_step(
            params, opt_state, *map(jnp.asarray, (lr, hr, mask)))

        t = [torch.from_numpy(a) for a in (lr, hr, mask)]
        _, _, g_t = tr.loss_and_grads(*t)
        loss_t, metric_t = tr.train_step(*t)
        steps.append((float(loss_j), float(metric_j), float(loss_t),
                      float(metric_t), convert.flatten_tree(g_j), g_t))
    return params, opt_state, tr, steps


def test_train_step_matches_jax_f32(tmp_path):
    params, opt_state, tr, steps = run(jnp.float32, torch.float32, tmp_path)
    for loss_j, metric_j, loss_t, metric_t, g_j, g_t in steps:
        assert loss_t == pytest.approx(loss_j, rel=1e-5)
        assert metric_t == pytest.approx(metric_j, abs=1e-4)
        assert set(g_j) == {k.replace(".", "/") for k in g_t}
        for k, v in g_j.items():
            assert rel(g_t[k.replace("/", ".")], v) < 1e-4, k
    for k, v in convert.flatten_tree(params).items():
        diff = np.abs(tr.params[k.replace("/", ".")].detach().numpy() - v)
        assert diff.max() < 1e-2 * LR, k
    want = convert.opt_state_from_optax(opt_state)
    assert int(tr.opt_state["count"]) == int(want["count"]) == STEPS
    for key in ("mu", "nu"):
        for k, v in want[key].items():
            assert rel(tr.opt_state[key][k], v) < 1e-4, (key, k)


def test_train_step_matches_jax_bf16(tmp_path):
    """bf16 compute, one step (params, loss and optimizer state stay
    float32).  Both sides round at bf16, but at other points: the plain
    convs outside the stack are PyTorch's and XLA's CPU bf16 convs, which
    accumulate and round their gradients differently, and the bias
    gradient of such a conv sums those over every position (measured up to
    7.5% norm-wise, convReducer_2/bias).  Losses agree to 1e-3; gradient
    leaves of the residual blocks (the stack this slice ports) to 3e-2 and
    the other leaves to 1e-1, norm-wise (||got - ref|| / ||ref||)."""
    _, _, _, steps = run(jnp.bfloat16, torch.bfloat16, tmp_path, 1)
    for loss_j, metric_j, loss_t, metric_t, g_j, g_t in steps:
        assert np.isfinite(loss_t)
        assert loss_t == pytest.approx(loss_j, rel=1e-3)
        assert metric_t == pytest.approx(metric_j, abs=1e-2)
        for k, v in g_j.items():
            assert g_t[k.replace("/", ".")].dtype == torch.float32
            tol = 3e-2 if k.startswith("resBlock_") else 1e-1
            assert rel_l2(g_t[k.replace("/", ".")], v) < tol, k
