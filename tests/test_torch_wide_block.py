"""The flat block-stack tier and the fused wide block of the port
(probav_tpu_torch/ops/wide_block.py, ops/block_stack.py, WDSRConv3D
fused_stack="flat" and fused_block=True) against the JAX package's
pallas_wide_block / pallas_block_stack, Pallas in interpret mode, on the
same numpy inputs and converted parameters.  On the CPU the wide_bwd
wrapper runs its plain twin, which is what these tests hold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probav_tpu.models import WDSRConv3D as JaxWDSR
from probav_tpu.ops import pallas_wide_block as pwb
from probav_tpu.ops.pallas_block_stack import fused_block_stack as jax_stack
from probav_tpu_torch import convert
from probav_tpu_torch.data.loader import Batcher
from probav_tpu_torch.models import WDSRConv3D
from probav_tpu_torch.models.wdsr import stack_tier
from probav_tpu_torch.ops import wide_block as wb
from probav_tpu_torch.ops.block_stack import FusedBlockStack, block_fwd, \
    fused_block_stack
from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
from probav_tpu_torch.tools.profile_train import synthetic_batch
from probav_tpu_torch.train import cli
from probav_tpu_torch.train.optim import build_optimizer
from probav_tpu_torch.train.trainer import ModelTrainer
from test_torch_train_cli import stage5_tree

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pwb.INTERPRET
    pwb.INTERPRET = True
    yield
    pwb.INTERPRET = old


def arrays(seed, *shapes, scale=0.1):
    r = np.random.default_rng(seed)
    return [(r.normal(size=s) * scale).astype(np.float32) for s in shapes]


def close(got, ref, rtol, atol_frac=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_frac * float(np.abs(ref).max()))


def test_fused_expand_decay_matches_jax():
    """n = 300 (no tile multiple), 8/32/8: forward rtol 1e-5; the VJP of
    sum(sin(y)) rtol 1e-4, atol 1e-5 max|ref| (tests/test_wide_block.py)."""
    n, cin, cmid, cout = 300, 8, 32, 8
    x, w1, b1, w2, b2 = arrays(0, (n, cin), (cin, cmid), (cmid,),
                               (cmid, cout), (cout,))
    x = x * 10.0
    args_j = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    args_t = [torch.from_numpy(a).requires_grad_() for a in (x, w1, b1, w2,
                                                              b2)]
    y_t = wb.fused_expand_decay(*args_t)
    close(y_t, pwb.fused_expand_decay(*args_j), 1e-5, 1e-5)
    g_t = torch.autograd.grad(torch.sin(y_t).sum(), args_t)
    g_j = jax.grad(lambda a: jnp.sum(jnp.sin(pwb.fused_expand_decay(*a))))(
        tuple(args_j))
    for a, b in zip(g_t, g_j):
        close(a, b, 1e-4, 1e-5)


@pytest.mark.parametrize("n", [300, 2048 + 17])
def test_wide_bwd_plain_matches_pallas_bwd(n):
    x, w1, b1, w2, dy = arrays(n, (n, 8), (8, 32), (32,), (32, 8), (n, 8))
    x, dy = x * 10.0, dy * 10.0
    want = pwb._bwd(*map(jnp.asarray, (x, w1, b1, w2, dy)), interpret=True)
    got = wb.wide_bwd_plain(*map(torch.from_numpy, (x, w1, b1, w2, dy)))
    assert got[0].dtype == torch.float32
    for a, b in zip(got, want):
        close(a, b, 1e-5, 1e-6)


def make_blocks(seed, n_blocks, c, c_mid, c_dec, kt=3):
    out = []
    for i in range(n_blocks):
        out.append(arrays(seed + i, (c, c_mid), (c_mid,), (c_mid, c_dec),
                          (c_dec,), (kt, kt, kt, c_dec, c), (c,)))
    return out


def test_fused_block_stack_matches_jax():
    """3 blocks at 8/16/6: forward rtol 1e-6; the VJP of sum(sin(y)) for x
    and every block parameter, rtol 1e-4, atol 1e-5 max|ref|
    (tests/test_block_stack.py)."""
    blocks = make_blocks(1, 3, 8, 16, 6)
    (x,) = arrays(9, (2, 6, 6, 5, 8), scale=1.0)
    bj = tuple(tuple(jnp.asarray(a) for a in blk) for blk in blocks)
    bt = [tuple(torch.from_numpy(a).requires_grad_() for a in blk)
          for blk in blocks]
    xt = torch.from_numpy(x).requires_grad_()
    y = fused_block_stack(xt, bt)
    close(y, jax_stack(jnp.asarray(x), bj), 1e-6, 1e-6)
    leaves = [xt] + [t for blk in bt for t in blk]
    got = torch.autograd.grad(torch.sin(y).sum(), leaves)
    want = jax.grad(lambda a: jnp.sum(jnp.sin(jax_stack(*a))))(
        (jnp.asarray(x), bj))
    for a, b in zip(got, jax.tree.leaves(want)):
        close(a, b, 1e-4, 1e-5)


def test_fused_block_stack_is_one_node_and_saves_no_wide_activation():
    blocks = [tuple(torch.from_numpy(a).requires_grad_() for a in blk)
              for blk in make_blocks(3, 2, 8, 16, 6)]
    x = torch.randn(1, 5, 5, 3, 8, generator=torch.Generator().manual_seed(0))
    y = fused_block_stack(x, blocks)
    assert type(y.grad_fn).__name__ == FusedBlockStack.__name__ + "Backward"
    saved = y.grad_fn.saved_tensors
    assert max(t.shape[-1] for t in saved if t.dim() == 5) == 8
    with torch.no_grad():
        h = x
        for blk in blocks:
            h, _ = block_fwd(h, *blk)
        assert torch.equal(fused_block_stack(x, blocks), h)


COMMON = dict(scale=3, num_filters=4, num_res_blocks=2, exp_rate=2,
              decay_rate=0.8, num_img_lr=9, patch_size_lr=16, mean=100.0,
              std=50.0)


def models(kind):
    """(JAX model, port model) of one tier: flat stack or fused blocks."""
    if kind == "flat":
        return (JaxWDSR(fused_stack=True, **COMMON),
                WDSRConv3D(fused_stack="flat", **COMMON))
    return (JaxWDSR(fused_block=True, **COMMON),
            WDSRConv3D(fused_stack="off", fused_block=True, **COMMON))


@pytest.mark.parametrize("kind", ["flat", "fused_block"])
def test_model_forward_matches_jax(kind):
    """JAX fused_stack=True (flat) / fused_block=True against the port's
    "flat" tier / fused_block=True, converted params, 2 patches: rtol 1e-5,
    atol 1e-2 (tests/test_block_stack.py)."""
    jm, pm = models(kind)
    (x,) = arrays(5, (2, 22, 22, 9, 1), scale=1.0)
    x = (x * 30 + 100).astype(np.float32)
    params = JaxWDSR(**COMMON).init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, params)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    pm.load_state_dict(convert.to_state_dict(params["params"]))
    with torch.inference_mode():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("kind", ["flat", "fused_block"])
def test_model_grads_through_weight_norm_match_jax(kind):
    """Gradients for every v / g / bias through the weight norm outside the
    custom backward: rtol 2e-4, atol 1e-6 + 1e-4 max|ref|
    (tests/test_block_stack.py)."""
    jm, pm = models(kind)
    (x,) = arrays(6, (1, 22, 22, 9, 1), scale=1.0)
    x = (x * 30 + 100).astype(np.float32)
    params = JaxWDSR(**COMMON).init(jax.random.PRNGKey(1), jnp.asarray(x))
    gj = jax.grad(lambda p: jnp.mean(jnp.abs(jm.apply(p, jnp.asarray(x))))
                  * 1e-2)(params)
    gj = convert.flatten_tree(gj["params"])
    pm.load_state_dict(convert.to_state_dict(params["params"]))
    named = dict(pm.named_parameters())
    loss = pm(torch.from_numpy(x)).abs().mean() * 1e-2
    gt = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert set(gj) == {k.replace(".", "/") for k in gt}
    for k, v in gj.items():
        np.testing.assert_allclose(
            gt[k.replace("/", ".")].numpy(), v, rtol=2e-4,
            atol=1e-6 + 1e-4 * float(np.abs(v).max()), err_msg=k)


def test_tiers_share_one_parameter_tree_and_agree():
    g = torch.Generator().manual_seed(0)
    ref = WDSRConv3D(fused_stack="off", generator=g, **COMMON)
    x = torch.rand(2, 22, 22, 9, 1, generator=g) * 300
    with torch.inference_mode():
        want = ref(x)
        for kw in ({"fused_stack": "t"}, {"fused_stack": "flat"},
                   {"fused_stack": "off", "fused_block": True}):
            m = WDSRConv3D(**kw, **COMMON)
            m.load_state_dict(ref.state_dict())
            assert (m(x) - want).abs().max() < 1e-4 * want.abs().max(), kw


@pytest.mark.parametrize("arg,tier", [(True, "t"), (False, "off"),
                                      ("t", "t"), ("flat", "flat"),
                                      ("off", "off")])
def test_stack_tier_keeps_the_ports_bool_meaning(arg, tier):
    """True stays the "t" tier (the JAX package's True is flat)."""
    assert stack_tier(arg) == tier
    assert WDSRConv3D(fused_stack=arg, **COMMON).fused_stack == tier


def test_stack_tier_refuses_unknown_names():
    with pytest.raises(ValueError, match="fused_stack"):
        stack_tier("scan")
    assert WDSRConv3D(**COMMON).fused_stack == "t"


@pytest.mark.parametrize("flags,tier", [
    (["--fused-stack", "flat"], "flat"), ([], "t"), (["--plain"], "off"),
    (["--fused-stack", "flat", "--plain"], "off")])
def test_cli_fused_stack_flag(flags, tier):
    assert cli.parse_args(flags).fused_stack == tier


@pytest.mark.parametrize("tier,ragged", [("t", 4), ("flat", 1), ("off", 1)])
def test_eval_pads_the_ragged_batch_only_in_the_t_tier(tmp_path, tier,
                                                       ragged):
    """As the JAX trainer: the last validation batch of 1 is padded to
    the batch of 4 with a weight-0 row only for the "t" tier."""
    model = WDSRConv3D(fused_stack=tier, **dict(COMMON, mean=8000.0,
                                                std=3000.0))
    losses = ShiftCompensatedLosses(target_shape=(48, 48, 1))
    tr = ModelTrainer(model, losses.l1, losses.cpsnr,
                      build_optimizer("nadam", 1e-3),
                      str(tmp_path / "ckpt"), str(tmp_path / "logs"),
                      loss_weighted_fn=losses.weighted("l1"), device="cpu")
    tr.init_state()
    shapes = []
    step = tr.eval_step

    def spy(lr_b, hr_b, mask_b, w):
        shapes.append((len(lr_b), float(w.sum())))
        return step(lr_b, hr_b, mask_b, w)

    tr.eval_step = spy
    lr, hr, mask = synthetic_batch(5, seed=3)
    tr.evaluate(Batcher((lr, hr * mask, mask), 4, seed=1,
                        drop_remainder=False), 8)
    assert shapes == [(4, 4.0), (ragged, 1.0)]


def test_train_cli_flat_tier_on_cpu(tmp_path, monkeypatch):
    """The train CLI with --fused-stack flat trains, checkpoints and
    resumes; every backward goes through the flat stack's autograd node."""
    calls = []
    orig = FusedBlockStack.backward

    def counted(ctx, g):
        calls.append(1)
        return orig(ctx, g)

    monkeypatch.setattr(FusedBlockStack, "backward", staticmethod(counted))
    cfgp, cfg = stage5_tree(tmp_path)
    args = ["--cfg", cfgp, "--band", "NIR", "--device", "cpu",
            "--eval-step", "2", "--fused-stack", "flat"]
    res = cli.main(args)["NIR"]
    assert res["steps"] == 4 and np.isfinite(res["train_loss"])
    assert len(calls) == 4
    stage5_tree(tmp_path, epochs=3)
    assert cli.main(args)["NIR"]["steps"] == 6
    assert len(calls) == 6
