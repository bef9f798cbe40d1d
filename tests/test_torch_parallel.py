"""The port's data axis (``probav_tpu_torch.parallel``, ``--mesh-data``) on
the CPU over gloo ranks, against the JAX package's ``make_mesh(num_data=2)``
mesh and against the port in one process.

The spawned ranks run the functions of ``tests/torch_parallel_ranks.py``
(no JAX there).  A spawn costs seconds, so one 2-rank run does every
2-rank library check (``two_ranks``, a module fixture) and the tests read
its results.  Tolerances are those of
``tests/test_torch_train_step.py::test_train_step_matches_jax_f32``: loss
1e-5 relative, cPSNR 1e-4 absolute, gradients 1e-4 of their largest
element, parameters after the step within 1e-2 x lr.  The JAX step is its
plain tier (its mesh math does not depend on the tier; its "t" tier needs
interpret mode); the port's is its "t" tier, which takes the kernels'
plain twins on the CPU.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import torch_parallel_ranks as ranks
from probav_tpu.infer import Resolver as JaxResolver
from probav_tpu.models import WDSRConv3D as JaxWDSR
from probav_tpu.ops import ShiftCompensatedLosses as JaxLosses
from probav_tpu.parallel import (batch_sharding, replicated_sharding)
from probav_tpu.parallel import make_mesh as jax_make_mesh
from probav_tpu_torch import convert, serve
from probav_tpu_torch.config import Config
from probav_tpu_torch.infer import Resolver
from probav_tpu_torch.models import WDSRConv3D
from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
from probav_tpu_torch.parallel import launch, make_mesh
from probav_tpu_torch.parallel.mesh import Mesh
from probav_tpu_torch.tools.profile_train import synthetic_batch
from probav_tpu_torch.train import cli
from synthetic_data import write_cfg

torch.set_num_threads(1)

LR = ranks.LR
MEAN, STD = ranks.STEP_NET["mean"], ranks.STEP_NET["std"]
LOSSES = ("l1", "l1msssim")
TTA_REPEATS = 2
DEADLINE = 240.0
# Shifts planted in the two halves of the step's batch (rows, columns), so
# that the two ranks' shares take their l1msssim minimum at other shifts.
PLANTED = ((2, 1), (-1, -2))


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(autouse=True)
def keep_tf32(monkeypatch):
    """The CLIs turn cuDNN's and cuBLAS's TF32 off in this process: restore
    both flags after each test."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def no_tensorboard(monkeypatch):
    """The trainers of this process write metrics.jsonl only, as the
    ranks' do (torch_parallel_ranks._no_tensorboard)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


# --------------------------------------------------------------------- #
# inputs                                                                 #
# --------------------------------------------------------------------- #

def seeded(net, seed, bias=0.0):
    """(the flax tree, the port's state_dict) of a seeded init of the
    port's model (flax's own init is slow here), its 1-D leaves moved by
    ``bias``."""
    m = WDSRConv3D(**net, fused_stack="off",
                   generator=torch.Generator().manual_seed(seed))
    state = {k: v.detach() + bias if v.ndim == 1 else v.detach().clone()
             for k, v in m.state_dict().items()}
    return convert.to_tree(state), state


@pytest.fixture(scope="module")
def step_inputs():
    """(JAX params, the port's state_dict, the global batch of 4): the
    truth of each half is the initial model's prediction shifted by that
    half's PLANTED shift, plus noise, its occluded pixels zeroed."""
    lr, _, mask = synthetic_batch(4, seed=21, hr_clear=0.9)
    params, state = seeded(ranks.STEP_NET, 0)
    model = WDSRConv3D(**ranks.STEP_NET, fused_stack="off")
    model.load_state_dict(state)
    with torch.no_grad():
        pred = model(torch.from_numpy(lr), torch.tensor([MEAN, STD])).numpy()
    r = np.random.default_rng(22)
    hr = np.concatenate([np.roll(pred[2 * i:2 * i + 2], s, axis=(1, 2))
                         for i, s in enumerate(PLANTED)])
    hr = (hr + r.normal(0, 30, hr.shape)).astype(np.float32)
    return params, state, (lr, hr * mask, mask)


def fit_data():
    """12 training patches (3 steps of 4 an epoch) and a ragged validation
    set of 6 (a batch of 4 and one of 2)."""
    r = np.random.default_rng(23)
    x = r.uniform(50, 150, (18, 22, 22, 9, 1)).astype(np.float32)
    hr = r.uniform(50, 150, (18, 48, 48, 1)).astype(np.float32)
    mask = np.ones_like(hr)
    return x[:12], hr[:12], mask[:12], x[12:], hr[12:], mask[12:]


def fit_params():
    return seeded(ranks.FIT_NET, 0)[1]


@pytest.fixture(scope="module")
def resolver_inputs():
    """tests/test_e2e.py's mesh resolver model (its 1-D leaves moved off
    their init) and 3 scenes of 64 patches."""
    r = np.random.default_rng(24)
    scenes = r.uniform(50, 150, (3, 64, 22, 22, 9, 1)).astype(np.float32)
    params, _ = seeded(ranks.RESOLVER_NET, 1, bias=0.05)
    return JaxWDSR(**ranks.RESOLVER_NET), params, scenes


@pytest.fixture(scope="module")
def two(tmp_path_factory, step_inputs, resolver_inputs):
    """Rank 0's results of ``torch_parallel_ranks.two_ranks`` and the
    directory of the per-rank files."""
    out_dir = str(tmp_path_factory.mktemp("two_ranks"))
    _, params, batch = step_inputs
    _, jparams, scenes = resolver_inputs
    spec = dict(out_dir=out_dir, losses=LOSSES, step_params=params,
                batch=batch, fit_params=fit_params(), fit_data=fit_data(),
                resolver_params=convert.to_state_dict(jparams),
                scenes=scenes, tta_repeats=TTA_REPEATS)
    res = launch(ranks.two_ranks, 2, spec, device="cpu", deadline=DEADLINE)
    return res, out_dir


def per_rank(out_dir, name, n=2):
    return [torch.load(os.path.join(out_dir, f"{name}_rank{r}.pt"),
                       weights_only=False) for r in range(n)]


def assert_ranks_equal(states):
    for s in states[1:]:
        assert s.keys() == states[0].keys()
        for k in s:
            assert np.array_equal(np.asarray(s[k]), np.asarray(states[0][k])), k


# --------------------------------------------------------------------- #
# the train step                                                         #
# --------------------------------------------------------------------- #

def jax_mesh_step(loss, params, batch):
    """(loss, cPSNR, gradients, parameters after) of one nadam step of the
    plain-tier JAX model, jitted over make_mesh(num_data=2): the batch
    sharded over 'data', the state replicated."""
    jm = JaxWDSR(**ranks.STEP_NET)
    jl = JaxLosses(target_shape=(48, 48, 1))
    tx = optax.nadam(LR)
    mesh = jax_make_mesh(num_data=2)
    b_sh, r_sh = batch_sharding(mesh), replicated_sharding(mesh)

    def step(params, opt_state, lr, hr, mask, norm):
        def objective(p):
            pred = jm.apply({"params": p}, lr, norm)
            return jl.by_name(loss)(hr, mask, pred), pred
        (value, pred), grads = jax.value_and_grad(objective, has_aux=True)(
            params)
        metric = jnp.mean(jl.cpsnr(hr, mask, pred))
        updates, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), value, metric, grads

    fn = jax.jit(step, in_shardings=(r_sh, r_sh, b_sh, b_sh, b_sh, r_sh),
                 out_shardings=(r_sh, r_sh, r_sh, r_sh))
    new, value, metric, grads = fn(params, tx.init(params),
                                   *map(jnp.asarray, batch),
                                   jnp.asarray([MEAN, STD], jnp.float32))
    return (float(value), float(metric), convert.flatten_tree(grads),
            convert.flatten_tree(new))


def assert_step_matches(got, loss_j, metric_j, g_j, p_j):
    assert got["loss"] == pytest.approx(loss_j, rel=1e-5)
    assert got["metric"] == pytest.approx(metric_j, abs=1e-4)
    assert set(g_j) == {k.replace(".", "/") for k in got["grads"]}
    for k, v in g_j.items():
        assert rel(got["grads"][k.replace("/", ".")], v) < 1e-4, k
    for k, v in p_j.items():
        diff = np.abs(got["params"][k.replace("/", ".")] - np.asarray(v))
        assert diff.max() < 1e-2 * LR, k


@pytest.mark.parametrize("loss", LOSSES)
def test_two_rank_step_matches_jax_mesh_step(two, step_inputs, loss):
    """The 2-rank step (2 rows a rank) is the JAX step on the global batch
    of 4 over make_mesh(num_data=2); every rank's parameters after it are
    equal to the bit.  For l1msssim this holds only because each rank's
    per-shift sums are summed over the ranks before the min, and because
    all_sum's backward scales by 2 against the gradient mean: with an
    identity backward the gradients would be half the JAX ones."""
    res, out_dir = two
    jparams, _, batch = step_inputs
    assert_step_matches(res[loss], *jax_mesh_step(loss, jparams, batch))
    assert_ranks_equal(per_rank(out_dir, f"step_{loss}"))


def test_msssim_rank_local_min_differs_from_the_global_loss(two,
                                                             step_inputs):
    """The witness that the l1msssim test above can fail: each half's own
    min over shifts, averaged, is another loss than the global batch's,
    by far more than the 1e-5 tolerance (the halves' planted shifts
    differ), and the 2-rank loss is the global one."""
    res, _ = two
    _, params, (lr, hr, mask) = step_inputs
    model = WDSRConv3D(**ranks.STEP_NET, fused_stack=True)
    model.load_state_dict(params)
    losses = ShiftCompensatedLosses(target_shape=(48, 48, 1))
    t = [torch.from_numpy(a) for a in (lr, hr, mask)]
    with torch.no_grad():
        pred = model(t[0], torch.tensor([MEAN, STD]))
        whole = float(losses.rev_msssim(t[1], t[2], pred))
        local = np.mean([float(losses.rev_msssim(t[1][s], t[2][s], pred[s]))
                         for s in (slice(0, 2), slice(2, 4))])
    assert res["l1msssim"]["loss"] == pytest.approx(whole, rel=1e-5)
    assert abs(local - whole) / whole > 1e-3, (local, whole)


def test_four_ranks_match_one_process(tmp_path, step_inputs, no_tensorboard):
    """data=4 at batch 8 (2 rows a rank) against the port's one-process
    step on the same batch; every rank's parameters equal to the bit."""
    _, params, _ = step_inputs
    lr, hr, mask = synthetic_batch(8, seed=25, hr_clear=0.9)
    batch = (lr, hr * mask, mask)
    spec = dict(out_dir=str(tmp_path), params=params, batch=batch)
    got = launch(ranks.four_ranks, 4, spec, device="cpu", deadline=DEADLINE)
    want = ranks.one_step(None, params, "l1", batch, str(tmp_path / "one"))
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["metric"] == pytest.approx(want["metric"], abs=1e-4)
    for k, v in want["grads"].items():
        assert rel(got["grads"][k], v) < 1e-4, k
    for k, v in want["params"].items():
        assert np.abs(got["params"][k] - v).max() < 1e-2 * LR, k
    assert_ranks_equal(per_rank(str(tmp_path), "step4", 4))


# --------------------------------------------------------------------- #
# fit, fit_device, resume                                                #
# --------------------------------------------------------------------- #

def logged(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [(r["tag"], r["step"], r["value"])
                for r in map(json.loads, f)]


def assert_logs_close(got, want):
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in want]
    for (tag, step, a), (_, _, b) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-5), (tag, step, a, b)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """{loop: (result, params, workdir, checkpoint writes)} of the tiny
    setup's fit and fit_device in this process."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        for loop in ("fit", "fit_device"):
            workdir = str(tmp_path_factory.mktemp("one_" + loop))
            writes = []
            res, params = ranks.fit_run(None, fit_params(), loop,
                                        fit_data(), workdir, writes)
            out[loop] = (res, params, workdir, writes)
    return out


@pytest.mark.parametrize("loop", ["fit", "fit_device"])
def test_two_rank_loops_match_one_process(two, one_process, loop):
    """2 epochs of 3 steps, validation every 2 and a ragged validation
    set: every logged loss and cPSNR of the 2-rank loop (training and
    validation) within 1e-5 of the same loop's in one process; the same
    checkpoints, written by rank 0 alone, once each; the parameters
    within 1e-2 x lr of one process's and equal to the bit on both ranks
    and between the 2-rank fit and fit_device."""
    res, out_dir = two
    want_res, want_params, want_dir, want_writes = one_process[loop]
    got = res[loop]
    assert got["steps"] == want_res["steps"] == 6
    assert got["val_psnr"] == pytest.approx(want_res["val_psnr"], rel=1e-5)
    assert got["val_loss"] == pytest.approx(want_res["val_loss"], rel=1e-5)
    assert_logs_close(logged(os.path.join(out_dir, loop, "logs")),
                      logged(os.path.join(want_dir, "logs")))
    writes = per_rank(out_dir, "writes")
    assert writes[0][loop] == want_writes and writes[1][loop] == []
    assert sorted(os.listdir(os.path.join(out_dir, loop, "ckpt"))) == \
        sorted(os.listdir(os.path.join(want_dir, "ckpt")))
    for k, v in per_rank(out_dir, loop)[0].items():
        assert np.abs(v.numpy() - want_params[k].numpy()).max() < 1e-2 * LR
    assert_ranks_equal([{k: v.numpy() for k, v in s.items()}
                        for s in per_rank(out_dir, loop)])
    fit_final = per_rank(out_dir, "fit")[0]
    for k, v in per_rank(out_dir, loop)[0].items():
        assert torch.equal(v, fit_final[k]), k


def test_two_rank_resume_is_exact(two):
    """A 2-rank fit restored from the uninterrupted run's step-2
    checkpoint (inside the first epoch of 3 steps) ends with the same
    parameters, to the bit, and logs the same values from the second
    epoch on (fit logs the running mean of the epoch's train values,
    which the restored run starts at step 3)."""
    res, out_dir = two
    assert res["resume"]["steps"] == res["fit"]["steps"]
    final = per_rank(out_dir, "fit")[0]
    for k, v in per_rank(out_dir, "resume")[0].items():
        assert torch.equal(v, final[k]), k
    full = logged(os.path.join(out_dir, "fit", "logs"))
    resumed = logged(os.path.join(out_dir, "resume", "logs"))
    assert [r[:2] for r in resumed] == [r[:2] for r in full if r[1] > 2]
    assert [r for r in resumed if r[1] > 3] == [r for r in full if r[1] > 3]
    assert per_rank(out_dir, "writes")[1]["resume"] == []


# --------------------------------------------------------------------- #
# the resolver                                                           #
# --------------------------------------------------------------------- #

def as_uint16(scenes):
    return np.clip(np.asarray(scenes), 0, 65535).astype(np.uint16) \
        .astype(np.int64)


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta2"])
def test_two_rank_resolver_matches_jax_mesh_and_one_process(
        two, resolver_inputs, tta):
    """3 scenes of 64 patches, each rank predicting 32 rows of each
    group's 192 (384 with TTA): equal to the bit to the one-process port
    (the gather adds zeros), and to the JAX resolver on
    make_mesh(num_data=2) within one count on at most 1e-4 of the pixels
    (XLA's and PyTorch's CPU convolutions sum in another order, which
    moves a value that lies within a rounding of .5 to the other
    integer)."""
    res, _ = two
    jm, params, scenes = resolver_inputs
    got = res["resolver"][tta]
    one = Resolver(WDSRConv3D(**ranks.RESOLVER_NET, fused_stack=True),
                   convert.to_state_dict(params), scene_size=384,
                   device="cpu")
    np.testing.assert_array_equal(
        got, np.stack(one.resolve_all(scenes, tta=tta,
                                      tta_repeats=TTA_REPEATS)))
    ref = JaxResolver(jm, params, scene_size=384,
                      mesh=jax_make_mesh(num_data=2)).resolve_all(
        scenes, progress=False, tta=tta, tta_repeats=TTA_REPEATS)
    diff = np.abs(as_uint16(got) - as_uint16(np.stack(ref)))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-4, (diff > 0).sum()


# --------------------------------------------------------------------- #
# the CLIs                                                               #
# --------------------------------------------------------------------- #

def stage5_tree(root, epochs=2):
    """tests/test_torch_train_cli.py's tree: the synthetic cfg (4 filters,
    1 block, batch 4, nadam, l1), 8 training and 3 validation patches."""
    os.makedirs(root, exist_ok=True)
    cfgp = write_cfg(str(root / "synth.cfg"), raw=str(root / "raw"),
                     out=str(root / "chkpt"), model_out=str(root / "mi"),
                     train_out=str(root / "to"), test_out=str(root / "te"))
    with open(cfgp) as f:
        text = f.read().replace("epochs=2", f"epochs={epochs}")
    with open(cfgp, "w") as f:
        f.write(text)
    cfg = Config.from_file(cfgp)
    aug = cfg.stage_dir("augmentedPatchesDir")
    os.makedirs(aug, exist_ok=True)
    lr, hr, mask = synthetic_batch(11, seed=7)
    for split, sl in (("TRAIN", slice(0, 8)), ("TRAINVAL", slice(8, 11))):
        np.save(os.path.join(aug, f"{split}patchesLR_NIR.npy"), lr[sl])
        np.ma.masked_array(hr[sl], mask=mask[sl] == 0).dump(
            os.path.join(aug, f"{split}patchesHR_NIR.npy"))
    return cfgp, cfg


def test_train_cli_on_two_ranks(tmp_path, no_tensorboard):
    """``--mesh-data 2`` against ``--mesh-data 0`` on the same tree: the
    logged values within 1e-5, the same checkpoints; then each resumes
    its own checkpoint for a third epoch, the 2-rank run in one process,
    and the two still agree."""
    runs = {}
    for n in (2, 0):
        cfgp, cfg = stage5_tree(tmp_path / f"mesh{n}")
        args = ["--cfg", cfgp, "--band", "NIR", "--device", "cpu",
                "--eval-step", "2", "--mesh-data", str(n)]
        res = cli.main(args)["NIR"]
        assert res["steps"] == 4
        stage5_tree(tmp_path / f"mesh{n}", epochs=3)
        res = cli.main(args[:-2])["NIR"]
        assert res["steps"] == 6
        runs[n] = (sorted(os.listdir(cfg.ckpt_dir("NIR"))),
                   logged(cfg.log_dir("NIR")))
    assert runs[2][0] == runs[0][0]
    assert runs[2][0][-1] == "step_00000006.pt"
    assert_logs_close(runs[2][1], runs[0][1])


@pytest.fixture
def serve_tree(tmp_path):
    """The synthetic cfg (4 filters, 1 block) with a 2-scene, 2x2-grid
    resolver input ([S, P, T, C, h, w]) and the parameters of a seeded
    init as .npz."""
    cfgp = write_cfg(str(tmp_path / "synth.cfg"), raw=str(tmp_path / "raw"),
                     out=str(tmp_path / "chkpt"),
                     model_out=str(tmp_path / "mi"),
                     train_out=str(tmp_path / "to"),
                     test_out=str(tmp_path / "te"))
    cfg = Config.from_file(cfgp)
    os.makedirs(cfg.stage_dir("resolverDir"))
    r = np.random.default_rng(40)
    lr = r.uniform(4000, 12000, (2, 4, 9, 1, 22, 22)).astype(np.float32)
    np.save(os.path.join(cfg.stage_dir("resolverDir"),
                         "TESTpatchesLR_NIR.npy"), lr)
    from probav_tpu_torch.models.wdsr import build_model
    model = build_model(cfg, "NIR", generator=torch.Generator()
                        .manual_seed(3))
    npz = str(tmp_path / "params.npz")
    convert.save_npz(npz, model.state_dict())
    return cfgp, cfg, npz


def test_serve_cli_on_two_ranks(serve_tree):
    """``--mesh-data 2``: rank 0 writes PNGs equal, byte for byte, to those
    of one process."""
    cfgp, cfg, npz = serve_tree
    args = ["--cfg", cfgp, "--band", "NIR", "--totest", "TEST", "--params",
            npz, "--device", "cpu"]
    out = {}
    for n in (2, 0):
        res = serve.main(args + ["--mesh-data", str(n)])
        out[n] = {os.path.basename(p): open(p, "rb").read()
                  for p in res["written"]}
        for p in res["written"]:
            os.unlink(p)
    assert list(out[2]) == ["imgset1306.png", "imgset1307.png"]
    assert out[2] == out[0]


# --------------------------------------------------------------------- #
# refusals                                                               #
# --------------------------------------------------------------------- #

@pytest.fixture
def one_process_group(tmp_path):
    """A gloo process group of this process alone."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_make_mesh_refuses_a_model_axis_and_a_wrong_world(one_process_group):
    """A mesh must cover the world: a model axis of 2 and a data axis of 2
    on a world of 1 are refused; (data 1, model 1) is the whole world,
    with no model group."""
    with pytest.raises(ValueError, match=r"mesh 1x2 needs 2 devices, "
                       "have 1"):
        make_mesh(num_data=1, num_model=2)
    with pytest.raises(ValueError, match=r"mesh 2x1 needs 2 devices, "
                       "have 1"):
        make_mesh(num_data=2)
    with pytest.raises(ValueError, match="mesh model axis 0"):
        make_mesh(num_data=1, num_model=0)
    for mesh in (make_mesh(), make_mesh(num_data=1, num_model=1)):
        assert mesh.shape == {"data": 1, "model": 1}
        assert (mesh.world, mesh.rank, mesh.data_index, mesh.model_index,
                mesh.data_size, mesh.model_size) == (1, 0, 0, 0, 1, 1)
        assert mesh.data_group is None and mesh.model_group is None
        assert mesh.device == torch.device("cpu")


def test_cli_refusals():
    """fusionNet trains in one process; the t tier does not compose with
    a model axis (the JAX trainer's ValueError), which flat, the default
    there, and off do; a model axis needs a data axis."""
    with pytest.raises(ValueError, match="tensor parallel"):
        cli.parse_args(["--mesh-data", "2", "--mesh-model", "2",
                        "--fused-stack", "t"])
    with pytest.raises(ValueError, match="--mesh-model needs --mesh-data"):
        cli.parse_args(["--mesh-model", "2"])
    with pytest.raises(ValueError, match="fusionNet trains in one process"):
        cli.parse_args(["--modelType", "fusionNet", "--mesh-data", "2"])
    opt = cli.parse_args(["--modelType", "iwdsr", "--mesh-data", "2"])
    assert opt.mesh_data == 2 and opt.mesh_model == 1
    opt = cli.parse_args(["--mesh-data", "2", "--mesh-model", "2"])
    assert (opt.mesh_model, opt.fused_stack) == (2, "flat")


def test_indivisible_batches_are_refused(tmp_path, no_tensorboard):
    """The cfg's batch of 4 on 3 ranks (before any rank starts), a
    trainer's batch and a scene's patch count on a mesh of 3."""
    cfgp, _ = stage5_tree(tmp_path)
    with pytest.raises(ValueError, match="batch size 4 does not divide by "
                       "the mesh's data size 3"):
        cli.main(["--cfg", cfgp, "--device", "cpu", "--mesh-data", "3"])
    mesh = Mesh(world=3, rank=0, device=torch.device("cpu"))
    model = WDSRConv3D(**ranks.FIT_NET, fused_stack=True)
    losses = ShiftCompensatedLosses(target_shape=(48, 48, 1), mesh=mesh)
    from probav_tpu_torch.train.optim import build_optimizer
    from probav_tpu_torch.train.trainer import ModelTrainer
    tr = ModelTrainer(model, losses.l1, losses.cpsnr,
                      build_optimizer("nadam", LR), str(tmp_path / "ck"),
                      str(tmp_path / "lg"), mesh=mesh)
    x, hr, mask, *val = fit_data()
    for loop in (tr.fit, tr.fit_device):
        with pytest.raises(ValueError, match="batch size 4 does not divide"):
            loop(x, [hr, mask], 4, 1, val_data=val)
    r = Resolver(model, scene_size=384, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="patches per scene 64 does not "
                       "divide"):
        r.resolve_all(np.zeros((1, 64, 22, 22, 9, 1), np.float32))


def test_batcher_rows_are_the_share_of_the_full_batches():
    """Each rank's ``Batcher(rows=batch_share)`` gathers exactly its rows
    of the batches that one process draws, epoch after epoch and on a
    resume; a share of ragged batches is refused."""
    from probav_tpu_torch.data.loader import Batcher

    x = np.arange(22 * 3).reshape(22, 3)
    full = list(Batcher((x, -x), 6, seed=4).repeat(2, skip=1))
    for rank in range(3):
        rows = slice(2 * rank, 2 * rank + 2)
        got = list(Batcher((x, -x), 6, seed=4, rows=rows).repeat(2, skip=1))
        assert len(got) == len(full) == 5
        for (gx, gy), (fx, fy) in zip(got, full):
            np.testing.assert_array_equal(gx, fx[rows])
            np.testing.assert_array_equal(gy, fy[rows])
    with pytest.raises(ValueError, match="rows of a batch need "
                       "drop_remainder"):
        Batcher((x,), 6, drop_remainder=False, rows=slice(0, 2))


def test_more_ranks_than_cards_are_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        launch(ranks.sleeping, 2, device="cuda")


def test_a_failing_rank_fails_the_run():
    """Rank 1 raises while rank 0 waits for it in an all-reduce: the
    parent re-raises rank 1's error, with its traceback, long before the
    deadline, and stops rank 0."""
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 1 fails on purpose") as info:
        launch(ranks.failing, 2, device="cpu", deadline=DEADLINE)
    assert time.monotonic() - t0 < DEADLINE / 4
    assert any("raised on rank 1" in note and "Traceback" in note
               for note in info.value.__notes__)


def test_the_deadline_stops_a_hung_run():
    with pytest.raises(TimeoutError, match="still running after 2.0 s"):
        launch(ranks.sleeping, 1, device="cpu", deadline=2.0)
