"""The port's model axis (tensor parallelism of the WDSR-B expand / decay
pair, ``--mesh-model``) on the CPU over gloo ranks, against the JAX
package's ``make_mesh(num_data, num_model=2)`` step and against the port
in one process.

The spawned ranks run the functions of ``tests/torch_model_axis_ranks.py``
(no JAX there).  A spawn costs seconds, so one 2-rank run, a (data 1,
model 2) mesh, does every check of that mesh (``one_by_two``, a module
fixture), and one 4-rank run the (2, 2) mesh's (``two_by_two``).

Tolerances: the loss within 1e-5 relative, the cPSNR 1e-4 absolute, the
gathered gradients norm-wise within 1e-5 of the reference leaf's norm,
and the parameters after two nadam steps within rtol 2e-5 / atol 1e-6
(tests/test_train.py's bound between one device and a mesh), of JAX's
step and of one process alike.  That bound cannot hold where a gradient
element is within a few orders of nadam's eps (1e-8): there the update
g / (|g| + eps) is a fraction of the learning rate that follows g's
relative rounding, and a float32 sum in another order moves such an
element by percents (l1msssim at the (2, 2) mesh: an element of 3.1e-8,
largest 1.4e-3, 2% apart from JAX's, its parameter 4.9e-6 apart).  The
elements whose first gradient is below TINY_GRAD are held to the data
axis tests' bound instead, 1e-2 of the learning rate
(tests/test_torch_parallel.py).  The JAX step is its plain tier (its mesh
math does not depend on the tier); the port's ``off`` and ``flat`` tiers
(the latter's ``wide_bwd`` on each rank's C_mid / 2 channels, by its
plain twin on the CPU) are each held to it.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_model_axis_ranks as ranks
from probav_tpu.models import IWDSRConv3D as JaxIWDSR
from probav_tpu.models import WDSRConv3D as JaxWDSR
from probav_tpu.ops import ShiftCompensatedLosses as JaxLosses
from probav_tpu.parallel import batch_sharding, param_shardings
from probav_tpu.parallel import make_mesh as jax_make_mesh
from probav_tpu.parallel import state_shardings
from probav_tpu_torch import convert
from probav_tpu_torch.config import Config
from probav_tpu_torch.models import IWDSRConv3D, WDSRConv3D
from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
from probav_tpu_torch.parallel import launch, shard_dim, shard_state
from probav_tpu_torch.parallel.mesh import Mesh
from probav_tpu_torch.tools.profile_train import synthetic_batch
from probav_tpu_torch.train import cli
from probav_tpu_torch.train.optim import build_optimizer
from probav_tpu_torch.train.trainer import ModelTrainer, list_checkpoints
from synthetic_data import write_cfg

torch.set_num_threads(1)

LR = ranks.LR
STEP_NET, FIT_NET = ranks.STEP_NET, ranks.FIT_NET
MEAN, STD = STEP_NET["mean"], STEP_NET["std"]
DEADLINE = 240.0
# Shifts planted in the two halves of the batch, so that the data ranks'
# shares take their l1msssim minimum at other shifts.
PLANTED = ((2, 1), (-1, -2))
LOSS_RTOL, METRIC_ATOL, GRAD_TOL = 1e-5, 1e-4, 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-5, 1e-6
TINY_GRAD = 1e-6


@pytest.fixture(autouse=True)
def keep_tf32(monkeypatch):
    """The CLI turns cuDNN's and cuBLAS's TF32 off in this process: restore
    both flags after each test."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """The trainers of this process write metrics.jsonl only, as the
    ranks' do (its TensorFlow import costs ~20 s)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


# --------------------------------------------------------------------- #
# inputs                                                                 #
# --------------------------------------------------------------------- #

def seeded(cls, net, seed):
    """A seeded init of the port's model as a state_dict, its 1-D leaves
    moved off their init (the biases off 0, the norms' g off ||v||)."""
    m = cls(**net, generator=torch.Generator().manual_seed(seed))
    r = np.random.default_rng(seed)
    return {k: v.detach() + torch.from_numpy(
        r.uniform(-0.05, 0.05, v.shape).astype(np.float32))
        if v.ndim == 1 else v.detach().clone()
        for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def step_inputs():
    """({"wdsr": state_dict, "iwdsr": state_dict}, the global batch of 4):
    the truth of each half is the initial WDSR's prediction shifted by
    that half's PLANTED shift, plus noise, its occluded pixels zeroed."""
    params = {"wdsr": seeded(WDSRConv3D, STEP_NET, 0),
              "iwdsr": seeded(IWDSRConv3D, STEP_NET, 1)}
    lr, _, mask = synthetic_batch(4, seed=21, hr_clear=0.9)
    model = WDSRConv3D(**STEP_NET, fused_stack="off")
    model.load_state_dict(params["wdsr"])
    with torch.no_grad():
        pred = model(torch.from_numpy(lr), torch.tensor([MEAN, STD])).numpy()
    r = np.random.default_rng(22)
    hr = np.concatenate([np.roll(pred[2 * i:2 * i + 2], s, axis=(1, 2))
                         for i, s in enumerate(PLANTED)])
    hr = (hr + r.normal(0, 30, hr.shape)).astype(np.float32)
    return params, (lr, hr * mask, mask)


def fit_data():
    """12 training patches (3 steps of 4 an epoch) and a ragged validation
    set of 6 (a batch of 4 and one of 2)."""
    r = np.random.default_rng(23)
    x = r.uniform(50, 150, (18, 22, 22, 9, 1)).astype(np.float32)
    hr = r.uniform(50, 150, (18, 48, 48, 1)).astype(np.float32)
    mask = np.ones_like(hr)
    return x[:12], hr[:12], mask[:12], x[12:], hr[12:], mask[12:]


def nadam_state(params, seed):
    """A nadam state of ``params`` after some updates (random moments)."""
    r = np.random.default_rng(seed)
    moments = lambda: {k: torch.from_numpy(r.normal(size=v.shape).astype(
        np.float32)) for k, v in params.items()}
    return {"count": torch.tensor(3, dtype=torch.int32), "mu": moments(),
            "nu": moments()}


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, step_inputs):
    """The port in this process: every step variant of the (1, 2) mesh and
    the flat steps of the (2, 2) mesh's losses, fit and fit_device, and
    the directory of fit's checkpoints."""
    params, batch = step_inputs
    root = tmp_path_factory.mktemp("one")
    out = {name: ranks.steps(None, params[kw.get("model", "wdsr")], "l1",
                             batch, str(root / name), **kw)
           for name, kw in ranks.ONE_BY_TWO}
    out["msssim"] = ranks.steps(None, params["wdsr"], "l1msssim", batch,
                                str(root / "msssim"), tier="flat")
    for loop in ("fit", "fit_device"):
        out[loop] = ranks.fit_run(None, seeded(WDSRConv3D, FIT_NET, 2),
                                  loop, fit_data(), str(root / loop))
    out["fit_ckpt"] = str(root / "fit" / "ckpt")
    return out


@pytest.fixture(scope="module")
def one_by_two(tmp_path_factory, step_inputs, one_process):
    """Rank 0's results of ``torch_model_axis_ranks.one_by_two`` and the
    directory of the per-rank files."""
    params, batch = step_inputs
    out_dir = str(tmp_path_factory.mktemp("one_by_two"))
    state = {"params": params["wdsr"], **{
        k: v for k, v in nadam_state(params["wdsr"], 3).items()
        if k != "count"}}
    spec = dict(out_dir=out_dir, state=state, params=params, batch=batch,
                fit_params=seeded(WDSRConv3D, FIT_NET, 2),
                fit_data=fit_data(),
                one_ckpt=list_checkpoints(one_process["fit_ckpt"])[-1][1])
    res = launch(ranks.one_by_two, 2, spec, device="cpu", num_model=2,
                 deadline=DEADLINE)
    return res, out_dir


@pytest.fixture(scope="module")
def two_by_two(tmp_path_factory, step_inputs):
    params, batch = step_inputs
    out_dir = str(tmp_path_factory.mktemp("two_by_two"))
    spec = dict(out_dir=out_dir, params=params["wdsr"], batch=batch,
                losses=("l1", "l1msssim"))
    res = launch(ranks.two_by_two, 4, spec, device="cpu", num_model=2,
                 deadline=DEADLINE)
    return res, out_dir


def per_rank(out_dir, name, n):
    return [torch.load(os.path.join(out_dir, f"{name}_rank{r}.pt"))
            for r in range(n)]


# --------------------------------------------------------------------- #
# the JAX step                                                           #
# --------------------------------------------------------------------- #

def jax_mesh_steps(loss, params, batch, num_data):
    """(losses, cPSNRs, gradients at ``params``, parameters after) of
    ranks.STEPS nadam steps of the plain-tier JAX model on
    make_mesh(num_data, num_model=2): the JAX trainer's train step with
    its shardings (the batch over 'data', the state by
    ``state_shardings``, the expand / decay pair over 'model'), and the
    gradients at the start under the same shardings."""
    jm = JaxWDSR(**STEP_NET)
    jl = JaxLosses(target_shape=(48, 48, 1))
    tx = optax.nadam(LR)
    mesh = jax_make_mesh(num_data=num_data, num_model=2)
    state = {"params": params, "opt_state": tx.init(params)}
    st_sh = state_shardings(state, mesh)
    b_sh = batch_sharding(mesh)
    r_sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    norm = jnp.asarray([MEAN, STD], jnp.float32)

    def objective(p, lr, hr, mask):
        pred = jm.apply({"params": p}, lr, norm)
        return jl.by_name(loss)(hr, mask, pred), pred

    def step(state, lr, hr, mask):
        (value, pred), grads = jax.value_and_grad(objective, has_aux=True)(
            state["params"], lr, hr, mask)
        updates, opt_state = tx.update(grads, state["opt_state"],
                                       state["params"])
        new = {"params": optax.apply_updates(state["params"], updates),
               "opt_state": opt_state}
        return new, value, jnp.mean(jl.cpsnr(hr, mask, pred)), grads

    fn = jax.jit(step, in_shardings=(st_sh, b_sh, b_sh, b_sh),
                 out_shardings=(st_sh, r_sh, r_sh, st_sh["params"]))
    data = [jax.device_put(jnp.asarray(a), b_sh) for a in batch]
    state = jax.device_put(state, st_sh)
    losses, metrics = [], []
    for i in range(ranks.STEPS):
        state, value, metric, g = fn(state, *data)
        losses.append(float(value))
        metrics.append(float(metric))
        if i == 0:
            grads = convert.flatten_tree(g)
    return losses, metrics, grads, convert.flatten_tree(state["params"])


@pytest.fixture(scope="module")
def jax_steps(step_inputs):
    """{(num_data, loss): jax_mesh_steps(...)} of the meshes and losses
    the tests hold the port to."""
    params, batch = step_inputs
    tree = convert.to_tree(params["wdsr"])
    return {(d, loss): jax_mesh_steps(loss, tree, batch, d)
            for d, loss in ((1, "l1"), (2, "l1"), (2, "l1msssim"))}


def rel_norm(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def assert_params_close(got, want, grads):
    """Each parameter within rtol PARAM_RTOL / atol PARAM_ATOL of
    ``want``, but for the elements whose reference gradient ``grads`` is
    below TINY_GRAD, within 1e-2 x LR (module docstring)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tiny = np.abs(np.asarray(grads)) < TINY_GRAD
    bound = np.where(tiny, 1e-2 * LR, PARAM_ATOL + PARAM_RTOL * np.abs(want))
    excess = np.abs(got - want) - bound
    assert excess.max() <= 0, (np.unravel_index(excess.argmax(), got.shape),
                               excess.max(), int(tiny.sum()))


def assert_steps_match(got, losses, metrics, grads, params):
    """``got`` (a ``ranks.steps`` result) within the module's tolerances
    of the reference's losses, cPSNRs, gradients and parameters (keyed
    alike, by the port's names)."""
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["metrics"], metrics, atol=METRIC_ATOL)
    assert set(got["grads"]) == set(grads)
    for k, v in grads.items():
        assert got["grads"][k].shape == tuple(np.shape(v)), k
        assert rel_norm(got["grads"][k], v) < GRAD_TOL, k
    for k, v in params.items():
        assert_params_close(got["params"][k], v, grads[k])


def assert_matches_jax(got, jax_result):
    losses, metrics, grads, params = jax_result
    port_key = lambda tree: {k.replace("/", "."): v for k, v in tree.items()}
    assert_steps_match(got, losses, metrics, port_key(grads),
                       port_key(params))


def assert_matches_one_process(got, want):
    assert_steps_match(got, want["losses"], want["metrics"],
                       {k: v.numpy() for k, v in want["grads"].items()},
                       {k: v.numpy() for k, v in want["params"].items()})


def assert_replicated_equal(states):
    """Every replicated parameter equal to the bit on every rank; the
    split ones of the two model ranks differ (each holds its part)."""
    for k, v in states[0].items():
        for s in states[1:]:
            if shard_dim(k, v.dim()) is None:
                assert torch.equal(s[k], v), k
            else:
                assert s[k].shape == v.shape, k


# --------------------------------------------------------------------- #
# (a), (b): the sharding rule and the state's parts                     #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("cls,jcls", [(WDSRConv3D, JaxWDSR),
                                      (IWDSRConv3D, JaxIWDSR)],
                         ids=["wdsr", "iwdsr"])
def test_sharding_rule_is_jax_state_shardings(cls, jcls):
    """``shard_dim`` names, for every parameter and nadam moment of the
    model, the dimension that JAX's ``param_shardings`` /
    ``state_shardings`` put on 'model' (None where they replicate), on a
    (data 4, model 2) mesh; IWDSR is replicated whole."""
    net = dict(STEP_NET)
    jm = jcls(**net)
    x = jax.ShapeDtypeStruct((1, 22, 22, 9, 1), jnp.float32)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"]
    opt_state = jax.eval_shape(optax.nadam(LR).init, params)
    mesh = jax_make_mesh(num_data=4, num_model=2)
    state = state_shardings({"params": params, "opt_state": opt_state},
                            mesh)
    port = cls(**net).state_dict()
    dims = {k: shard_dim(k, v.dim()) for k, v in port.items()}
    assert convert.model_axes(param_shardings(params, mesh)) == dims
    assert convert.model_axes(state["params"]) == dims
    assert convert.model_axes(state["opt_state"]) == {
        "count": None, "mu": dims, "nu": dims}
    split = {k for k, d in dims.items() if d is not None}
    if cls is WDSRConv3D:
        assert split == {f"resBlock_{i}.{k}" for i in range(2) for k in (
            "expand.kernel_v", "expand.wn_g", "expand.bias",
            "decay.kernel_v")}
    else:
        assert not split


def test_state_parts_cover_the_whole_state():
    """``shard_state`` of a whole state and a nadam state on each rank of
    a (1, 2) mesh: the parts of a split entry, concatenated on its
    dimension, are the whole (C_mid / 2 channels each); the rest is kept
    as it is."""
    params = seeded(WDSRConv3D, STEP_NET, 4)
    state = {"params": params, **nadam_state(params, 5)}
    parts = [shard_state(state, Mesh(world=2, rank=r,
                                     device=torch.device("cpu"),
                                     model_size=2)) for r in (0, 1)]
    assert parts[0]["count"] is state["count"]
    for key in ("params", "mu", "nu"):
        for k, v in state[key].items():
            dim = shard_dim(k, v.dim())
            if dim is None:
                assert all(p[key][k] is v for p in parts), k
                continue
            assert parts[0][key][k].shape[dim] == v.shape[dim] // 2
            assert torch.equal(torch.cat([p[key][k] for p in parts], dim),
                               v), k


def test_state_round_trip_is_exact_on_two_ranks(one_by_two):
    """``gather_state(shard_state(s))`` on a (1, 2) mesh is ``s`` to the
    bit, for the parameters and the nadam moments."""
    res, _ = one_by_two
    assert res["roundtrip"] is True


# --------------------------------------------------------------------- #
# (c), (d): the train step                                               #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("tier", ["off", "flat"])
def test_one_by_two_step_matches_jax_and_one_process(one_by_two, jax_steps,
                                                      one_process, tier):
    """Two nadam steps on (data 1, model 2): JAX's step on
    make_mesh(1, 2) and the same tier in one process; the replicated
    parameters equal to the bit on both ranks."""
    res, out_dir = one_by_two
    assert_matches_jax(res[tier], jax_steps[(1, "l1")])
    assert_matches_one_process(res[tier], one_process[tier])
    assert_replicated_equal(per_rank(out_dir, tier, 2))


@pytest.mark.parametrize("loss", ["l1", "l1msssim"])
def test_two_by_two_flat_step_matches_jax_and_one_process(
        two_by_two, jax_steps, one_process, loss):
    """Two nadam steps of the flat tier on (data 2, model 2), 2 rows a
    data rank: JAX's step on make_mesh(2, 2) and one process.  l1msssim
    sums its per-shift terms over the data group alone (the model ranks
    hold the same rows); the replicated parameters of all four ranks are
    equal to the bit."""
    res, out_dir = two_by_two
    assert_matches_jax(res[loss], jax_steps[(2, loss)])
    assert_matches_one_process(
        res[loss], one_process["flat" if loss == "l1" else "msssim"])
    assert_replicated_equal(per_rank(out_dir, loss, 4))


# --------------------------------------------------------------------- #
# (e): the other variants on the model axis                              #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["fused_block", "remat", "t_replicated",
                                  "iwdsr"])
def test_other_variants_on_the_model_axis_match_one_process(
        one_by_two, one_process, name):
    """On (data 1, model 2): the off tier with fused_block (wide_bwd on
    each rank's channels) and with remat split the pair; the t tier with
    tensor_parallel=False, and IWDSR (outside JAX's name rule), run
    replicated, every parameter equal to the bit on both ranks.  Each
    within the module's tolerances of one process."""
    res, out_dir = one_by_two
    assert_matches_one_process(res[name], one_process[name])
    states = per_rank(out_dir, name, 2)
    assert_replicated_equal(states)
    split = name in ("fused_block", "remat")
    assert split == any(states[0][k].shape != v.shape
                        for k, v in res[name]["params"].items())
    if not split:
        for k in states[0]:
            assert torch.equal(states[0][k], states[1][k]), k


# --------------------------------------------------------------------- #
# (f), (g): checkpoints, fit and fit_device                              #
# --------------------------------------------------------------------- #

def tiny_trainer(ckpt_root):
    """One process's flat FIT_NET trainer over ckpt_root/ckpt, restored."""
    return ranks.trainer(None, seeded(WDSRConv3D, FIT_NET, 9), "l1",
                         ckpt_root, net=FIT_NET)


@pytest.mark.parametrize("loop", ["fit", "fit_device"])
def test_one_by_two_loops_match_one_process(one_by_two, one_process, loop):
    """fit and fit_device on (data 1, model 2), 2 epochs of 3 steps with
    validation every 2: the validation results and the final parameters
    within the module's tolerances of one process."""
    res, _ = one_by_two
    (got, got_params), (want, want_params) = res[loop], one_process[loop]
    assert got["steps"] == want["steps"] == 6
    assert got["val_loss"] == pytest.approx(want["val_loss"], rel=LOSS_RTOL)
    assert got["val_psnr"] == pytest.approx(want["val_psnr"],
                                            abs=METRIC_ATOL)
    for k, v in want_params.items():
        np.testing.assert_allclose(got_params[k], v, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def test_checkpoints_resume_across_layouts(one_by_two, one_process):
    """A checkpoint that rank 0 of (data 1, model 2) wrote holds the whole
    state: one process restores the ranks' final parameters to the bit.
    The reverse: the ranks restore one process's final checkpoint and
    hold its parameters to the bit, each rank its part."""
    res, out_dir = one_by_two
    tr = tiny_trainer(os.path.join(out_dir, "fit"))
    assert tr.step == 6
    final = res["fit"][1]
    for k, v in tr.params.items():
        assert torch.equal(v.detach(), final[k]), k
    step, restored = res["restored"]
    assert step == 6
    for k, v in one_process["fit"][1].items():
        assert torch.equal(restored[k], v), k
    parts = per_rank(out_dir, "restored", 2)
    assert_replicated_equal(parts)
    k = "resBlock_0.expand.kernel_v"
    assert torch.equal(torch.cat([p[k] for p in parts], -1), restored[k])


# --------------------------------------------------------------------- #
# (h): the CLI                                                           #
# --------------------------------------------------------------------- #

def stage5_tree(root):
    """tests/test_torch_train_cli.py's tree: the synthetic cfg (4 filters,
    C_mid 8, 1 block, batch 4, nadam, l1, 2 epochs), 8 training and 3
    validation patches."""
    os.makedirs(root, exist_ok=True)
    cfgp = write_cfg(str(root / "synth.cfg"), raw=str(root / "raw"),
                     out=str(root / "chkpt"), model_out=str(root / "mi"),
                     train_out=str(root / "to"), test_out=str(root / "te"))
    cfg = Config.from_file(cfgp)
    aug = cfg.stage_dir("augmentedPatchesDir")
    os.makedirs(aug, exist_ok=True)
    lr, hr, mask = synthetic_batch(11, seed=7)
    for split, sl in (("TRAIN", slice(0, 8)), ("TRAINVAL", slice(8, 11))):
        np.save(os.path.join(aug, f"{split}patchesLR_NIR.npy"), lr[sl])
        np.ma.masked_array(hr[sl], mask=mask[sl] == 0).dump(
            os.path.join(aug, f"{split}patchesHR_NIR.npy"))
    return cfgp, cfg


def logged(log_dir):
    import json
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [(r["tag"], r["step"], r["value"])
                for r in map(json.loads, f)]


def test_train_cli_on_the_model_axis(tmp_path):
    """``--mesh-data 1 --mesh-model 2`` (the flat tier by default) against
    ``--fused-stack flat`` in one process on the same tree: the logged
    values within 1e-5, the same checkpoints, and the last one restores in
    one process to the same parameters as one process's last one, within
    the module's tolerances."""
    runs = {}
    for mesh in (["--mesh-data", "1", "--mesh-model", "2"],
                 ["--fused-stack", "flat"]):
        cfgp, cfg = stage5_tree(tmp_path / mesh[-1])
        res = cli.main(["--cfg", cfgp, "--band", "NIR", "--device", "cpu",
                        "--eval-step", "2"] + mesh)["NIR"]
        assert res["steps"] == 4
        ckpts = list_checkpoints(cfg.ckpt_dir("NIR"))
        runs[mesh[-1]] = ([os.path.basename(p) for _, p in ckpts],
                          logged(cfg.log_dir("NIR")),
                          torch.load(ckpts[-1][1])["params"])
    got, want = runs["2"], runs["flat"]
    assert got[0] == want[0] and got[0][-1] == "step_00000004.pt"
    assert [r[:2] for r in got[1]] == [r[:2] for r in want[1]]
    for a, b in zip(got[1], want[1]):
        assert a[2] == pytest.approx(b[2], rel=1e-5), (a, b)
    for k, v in want[2].items():
        assert got[2][k].shape == v.shape, k
        np.testing.assert_allclose(got[2][k], v, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


# --------------------------------------------------------------------- #
# (i): refusals                                                          #
# --------------------------------------------------------------------- #

def test_model_axis_refusals(tmp_path):
    """The t tier on a model axis raises the JAX trainer's ValueError (in
    the CLI and in the trainer), unless tensor_parallel=False;
    --mesh-model without --mesh-data, and a C_mid that does not divide by
    the model size, raise ValueError."""
    with pytest.raises(ValueError, match="tensor parallel"):
        cli.parse_args(["--mesh-data", "1", "--mesh-model", "2",
                        "--fused-stack", "t"])
    with pytest.raises(ValueError, match="--mesh-model needs --mesh-data"):
        cli.parse_args(["--mesh-model", "2"])
    with pytest.raises(ValueError, match="--mesh-model needs --mesh-data"):
        cli.parse_args(["--mesh-model", "1"])
    with pytest.raises(ValueError, match="--mesh-model 0: want >= 1"):
        cli.parse_args(["--mesh-data", "1", "--mesh-model", "0"])
    opt = cli.parse_args(["--mesh-data", "2", "--mesh-model", "2"])
    assert (opt.fused_stack, opt.mesh_model) == ("flat", 2)
    opt = cli.parse_args(["--mesh-data", "2", "--mesh-model", "2",
                          "--plain"])
    assert opt.fused_stack == "off"

    def trainer(model, mesh, **kw):
        losses = ShiftCompensatedLosses(target_shape=(48, 48, 1), mesh=mesh)
        return ModelTrainer(model, losses.l1, losses.cpsnr,
                            build_optimizer("nadam", LR),
                            str(tmp_path / "ck"), str(tmp_path / "lg"),
                            mesh=mesh, **kw)

    cpu = torch.device("cpu")
    two = Mesh(world=2, rank=0, device=cpu, model_size=2)
    with pytest.raises(ValueError, match="tensor parallel"):
        trainer(WDSRConv3D(**FIT_NET, fused_stack="t"), two)
    tr = trainer(WDSRConv3D(**FIT_NET, fused_stack="t"), two,
                 tensor_parallel=False)
    assert not tr.sharded
    three = Mesh(world=3, rank=0, device=cpu, model_size=3)
    model = WDSRConv3D(**FIT_NET, fused_stack="flat")
    with pytest.raises(ValueError, match="expand.kernel_v: 8 "
                       "channels do not divide by the mesh's model size 3"):
        trainer(model, three)


# --------------------------------------------------------------------- #
# tools/time_model_axis.py (its measurements need the cards)             #
# --------------------------------------------------------------------- #

def test_time_model_axis_tree_and_refusal(tmp_path, monkeypatch):
    """The tool's stage-5 tree is one the train CLI reads (the cfg's
    directories under the root, its epochs, TRAIN_N + VAL_N patches), its
    meshes parse, and without a card it refuses to measure."""
    from probav_tpu_torch.tools import time_model_axis as tma

    monkeypatch.setattr(tma, "TRAIN_N", 8)
    monkeypatch.setattr(tma, "VAL_N", 3)
    cfgp, _ = stage5_tree(tmp_path / "src")
    path = tma.stage5_tree(cfgp, str(tmp_path / "tree"), 3)
    cfg = Config.from_file(path)
    assert cfg.epochs == 3
    assert cfg.ckpt_dir("NIR").startswith(str(tmp_path / "tree"))
    x, (hr, mask), val = cli.load_stage5(cfg, "NIR")
    assert x.shape == (8, 22, 22, 9, 1) and hr.shape == (8, 48, 48, 1)
    assert len(val[0]) == 3 and set(np.unique(mask)) <= {0.0, 1.0}
    assert tma.parse_meshes("1x2,2x2,") == [(1, 2), (2, 2)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA cards"):
        tma.main(["--out", str(tmp_path / "out")])
