"""The port's optimizers (probav_tpu_torch/train/optim.py) against optax on
identical gradient sequences, the staged decay at its boundaries, and the
optimizer-state mapping of probav_tpu_torch/convert.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from probav_tpu.train.optim import build_optimizer as jax_build_optimizer
from probav_tpu.train.optim import staged_decay as jax_staged_decay
from probav_tpu_torch import convert
from probav_tpu_torch.train.optim import build_optimizer, staged_decay

torch.set_num_threads(1)

SHAPES = {"mainConv1/kernel_v": (3, 3, 3, 1, 4), "mainConv1/wn_g": (4,),
          "mainConv1/bias": (4,)}
STEPS = 30
TOL = 1e-6              # absolute, on parameters of order 1


def grads_seq(seed):
    """Gradients of mixed scales, including exact zeros."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(STEPS):
        g = {k: (r.normal(size=s) * 10.0 ** r.integers(-4, 1))
             .astype(np.float32) for k, s in SHAPES.items()}
        g["mainConv1/bias"][0] = 0.0
        out.append(g)
    return out


def nested(flat):
    tree = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def run_both(name, staged, seed=0):
    r = np.random.default_rng(seed + 100)
    p0 = {k: r.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    tx = jax_build_optimizer(name, 2e-3, steps_per_epoch=2,
                             use_staged_decay=staged)
    opt = build_optimizer(name, 2e-3, steps_per_epoch=2,
                          use_staged_decay=staged)
    jp = nested(p0)
    js = tx.init(jp)
    tp = {k.replace("/", "."): torch.from_numpy(v.copy())
          for k, v in p0.items()}
    ts = opt.init(tp)
    for g in grads_seq(seed):
        u, js = tx.update(nested(g), js, jp)
        jp = optax.apply_updates(jp, u)
        opt.step(tp, {k.replace("/", "."): torch.from_numpy(v)
                      for k, v in g.items()}, ts)
    return jp, js, tp, ts


@pytest.mark.parametrize("staged", [False, True], ids=["const", "staged"])
@pytest.mark.parametrize("name", ["nadam", "adam", "sgd"])
def test_optimizer_matches_optax(name, staged):
    """30 steps (past both staged-decay boundaries at steps_per_epoch 2)."""
    jp, js, tp, ts = run_both(name, staged)
    flat = convert.flatten_tree(jp)
    for k, v in flat.items():
        np.testing.assert_allclose(tp[k.replace("/", ".")].numpy(), v,
                                   rtol=0, atol=TOL)
    assert int(ts["count"]) == STEPS
    if name != "sgd":
        got = convert.opt_state_from_optax(js)
        assert int(got["count"]) == int(js[0].count) == STEPS
        for key in ("mu", "nu"):
            for k, v in got[key].items():
                np.testing.assert_allclose(ts[key][k].numpy(), v.numpy(),
                                           rtol=1e-6, atol=1e-12)


def test_nadam_is_not_torch_nadam():
    """torch.optim.NAdam is another algorithm: after 5 steps its params
    are far (relative to the step size) from optax's."""
    jp, _, tp, _ = run_both("nadam", False)
    p = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
         convert.flatten_tree(nested({k: np.ones(s, np.float32)
                                      for k, s in SHAPES.items()})).items()}
    ref = {k: v.clone() for k, v in p.items()}
    ours = build_optimizer("nadam", 2e-3)
    st = ours.init(ref)
    params = [v.clone().requires_grad_() for v in p.values()]
    topt = torch.optim.NAdam(params, lr=2e-3)
    for g in grads_seq(1)[:5]:
        ours.step(ref, {k: torch.from_numpy(g[k]) for k in ref}, st)
        for t, k in zip(params, p):
            t.grad = torch.from_numpy(g[k])
        topt.step()
    gap = max(float((t.detach() - ref[k]).abs().max())
              for t, k in zip(params, p))
    assert gap > 1e-4


@pytest.mark.parametrize("count", [0, 19, 20, 21, 39, 40, 41, 1000])
def test_staged_decay_boundaries(count):
    """steps_per_epoch 2: lr until step 20, lr/2 until 40, lr/10 after."""
    want = float(jax_staged_decay(5e-4, 2)(jnp.asarray(count, jnp.int32)))
    got = staged_decay(5e-4, 2)(count)
    assert got == pytest.approx(want, rel=1e-6)
    expect = 5e-4 if count < 20 else (2.5e-4 if count < 40 else 5e-5)
    assert got == pytest.approx(expect, rel=1e-12)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer("rmsprop", 1e-3)


@pytest.mark.parametrize("staged", [False, True], ids=["const", "staged"])
def test_optax_state_round_trip_continues_training(staged):
    """A JAX nadam state carried into the port and back: the port's next
    updates equal optax's, and the mapped-back state is optax's."""
    jp, js, _, _ = run_both("nadam", staged, seed=3)
    tx = jax_build_optimizer("nadam", 2e-3, steps_per_epoch=2,
                             use_staged_decay=staged)
    opt = build_optimizer("nadam", 2e-3, steps_per_epoch=2,
                          use_staged_decay=staged)
    tp = convert.to_state_dict(jp)
    ts = convert.opt_state_from_optax(js)
    for g in grads_seq(4)[:5]:
        u, js = tx.update(nested(g), js, jp)
        jp = optax.apply_updates(jp, u)
        opt.step(tp, {k.replace("/", "."): torch.from_numpy(v)
                      for k, v in g.items()}, ts)
    for k, v in convert.flatten_tree(jp).items():
        np.testing.assert_allclose(tp[k.replace("/", ".")].numpy(), v,
                                   rtol=0, atol=TOL)
    back = convert.opt_state_to_optax(ts, like=tx.init(jp))
    assert type(back) is type(js)
    la, lb = jax.tree.leaves(back), jax.tree.leaves(js)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-12)
    plain = convert.opt_state_to_optax(ts)
    assert set(plain) == {"count", "mu", "nu"}
    assert int(plain["count"]) == int(ts["count"])
