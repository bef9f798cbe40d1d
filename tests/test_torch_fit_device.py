"""The port's device-resident trainer loop (``ModelTrainer.fit_device``),
the train CLI's ``--device-data``, ``--remat`` and ``--profile-dir``
flags, and ``WDSRConv3D(remat=True)``, on the CPU.

``fit_device`` is held to the JAX package's ``fit_device`` (the same
converted init, data and seed, both on the "off" stack tier) with the
tolerances of ``tests/test_torch_train_step.py``: the logged per-chunk
loss to 1e-5 relative, cPSNR to 1e-4 absolute, the parameters to
1e-2 x lr.  Against the port's own ``fit`` (same init and seed) it is
equal to the bit: both draw the same permutations, gather the same rows
(numpy on the host, ``index_select`` on the device) and run the same
``train_step`` on the same values.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from probav_tpu.models import WDSRConv3D as JaxWDSR
from probav_tpu.ops import ShiftCompensatedLosses as JaxLosses
from probav_tpu.train import ModelTrainer as JaxTrainer
from probav_tpu.train import build_optimizer as jax_optimizer
from probav_tpu_torch import convert
from probav_tpu_torch.config import Config
from probav_tpu_torch.models.wdsr import WDSRConv3D
from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
from probav_tpu_torch.train import cli
from probav_tpu_torch.train.optim import build_optimizer
from probav_tpu_torch.train.trainer import ModelTrainer
from synthetic_data import write_cfg

torch.set_num_threads(1)

LR = 1e-3
NET = dict(scale=3, num_filters=4, num_res_blocks=1, exp_rate=2,
           decay_rate=0.8, num_img_lr=9, patch_size_lr=16, mean=100.0,
           std=50.0)


def tiny_data(seed, n=16):
    """The data of tests/test_train.py's tiny setup."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(50, 150, (n, 22, 22, 9, 1)).astype(np.float32)
    hr = rng.uniform(50, 150, (n, 48, 48, 1)).astype(np.float32)
    mask = np.ones_like(hr, dtype=np.float32)
    return x, hr, mask


def init_params(seed=0, **net):
    """A seeded init of the port's model, as a state_dict."""
    model = WDSRConv3D(**dict(NET, **net), fused_stack="off",
                       generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def tiny_trainer(workdir, params, tier="off", eval_step=2, **model_kw):
    """tests/test_train.py's tiny_setup in the port: 4 filters, 1 block,
    nadam 1e-3, the shift L1 loss, from the state_dict ``params``."""
    model = WDSRConv3D(**NET, fused_stack=tier, **model_kw)
    model.load_state_dict(params)
    losses = ShiftCompensatedLosses(target_shape=(48, 48, 1))
    tr = ModelTrainer(model, losses.l1, losses.cpsnr,
                      build_optimizer("nadam", LR),
                      str(workdir / "ckpt"), str(workdir / "logs"),
                      eval_step=eval_step, log_every=1,
                      loss_weighted_fn=losses.weighted("l1"), device="cpu")
    tr.init_state()
    return tr


def logged(log_dir, tag):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in recs if r["tag"] == tag]


def assert_same_state(a, b):
    """Parameters and optimizer state equal to the bit."""
    for k, v in a.params.items():
        assert torch.equal(b.params[k], v), k
    assert int(a.opt_state["count"]) == int(b.opt_state["count"])
    for key in ("mu", "nu"):
        for k, v in a.opt_state[key].items():
            assert torch.equal(b.opt_state[key][k], v), (key, k)


def test_fit_device_matches_jax_fit_device(tmp_path):
    x, hr, mask = tiny_data(41)
    losses = JaxLosses(target_shape=(48, 48, 1), use_pallas=False)
    jt = JaxTrainer(JaxWDSR(**NET), losses.l1, losses.cpsnr,
                    jax_optimizer("nadam", LR),
                    ckpt_dir=str(tmp_path / "jax" / "ckpt"),
                    log_dir=str(tmp_path / "jax" / "logs"), eval_step=2,
                    log_every=1, loss_per_sample_fn=losses.per_sample("l1"))
    jt.init_state(x[:1], rng_seed=3)
    # fit_device donates the state's buffers: convert them first.
    params = convert.to_state_dict(jax.tree.map(np.asarray,
                                                jt.state.params))
    val = [x[:8], hr[:8], mask[:8]]
    want = jt.fit_device(x, [hr, mask], batch_size=8, epochs=2,
                         val_data=val, val_steps=1, save_best_only=False,
                         seed=5)
    jt.logger_.flush()

    tr = tiny_trainer(tmp_path / "port", params)
    got = tr.fit_device(x, [hr, mask], batch_size=8, epochs=2, val_data=val,
                        val_steps=1, save_best_only=False, seed=5)
    assert got["steps"] == want["steps"] == 4
    assert got["epochs"] == want["epochs"]
    assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-5)
    assert got["val_psnr"] == pytest.approx(want["val_psnr"], abs=1e-4)
    for tag, check in (("Train loss", lambda a, b: a == pytest.approx(
            b, rel=1e-5)), ("Train PSNR", lambda a, b: a == pytest.approx(
                b, abs=1e-4))):
        g = logged(tmp_path / "port" / "logs", tag)
        w = logged(tmp_path / "jax" / "logs", tag)
        assert [s for s, _ in g] == [s for s, _ in w] == [2, 4]
        for (_, a), (_, b) in zip(g, w):
            assert check(a, b), (tag, a, b)
    for k, v in convert.flatten_tree(jt.state.params).items():
        diff = np.abs(tr.params[k.replace("/", ".")].detach().numpy() -
                      np.asarray(v))
        assert diff.max() < 1e-2 * LR, k


def test_fit_device_equals_fit_to_the_bit(tmp_path):
    x, hr, mask = tiny_data(43, n=12)
    params = init_params()
    val = [x[:4], hr[:4], mask[:4]]
    a = tiny_trainer(tmp_path / "fit", params, eval_step=100)
    a.fit(x, [hr, mask], 4, 2, val_data=val, val_steps=1,
          save_best_only=False, seed=9)
    b = tiny_trainer(tmp_path / "dev", params, eval_step=100)
    res = b.fit_device(x, [hr, mask], 4, 2, val_data=val, val_steps=1,
                       save_best_only=False, seed=9)
    assert res["steps"] == a.step == b.step == 6
    assert_same_state(a, b)


def test_fit_device_first_step_equals_train_step(tmp_path):
    """One full-batch step: fit_device's batch is the seed's permutation
    of the set, gathered on the device (tests/test_train.py's
    test_fit_device_matches_fit_first_step)."""
    x, hr, mask = tiny_data(13, n=8)
    params = init_params(11)
    a = tiny_trainer(tmp_path / "step", params)
    perm = np.random.default_rng(123).permutation(8)
    a.train_step(*(torch.from_numpy(v[perm]) for v in (x, hr, mask)))
    b = tiny_trainer(tmp_path / "dev", params)
    b.fit_device(x, [hr, mask], batch_size=8, epochs=1,
                 val_data=[x, hr, mask], val_steps=1, save_best_only=False,
                 seed=123)
    assert_same_state(a, b)


def test_resumed_fit_device_equals_the_uninterrupted_run(tmp_path):
    x, hr, mask = tiny_data(23)
    params = init_params(9)
    val = [x[:8], hr[:8], mask[:8]]
    kw = dict(val_data=val, val_steps=1, save_best_only=False, seed=77)
    full = tiny_trainer(tmp_path / "full", params)
    full.fit_device(x, [hr, mask], 8, 4, **kw)
    first = tiny_trainer(tmp_path / "resume", params)
    first.fit_device(x, [hr, mask], 8, 2, **kw)
    second = tiny_trainer(tmp_path / "resume", params)
    assert second.step == 4
    res = second.fit_device(x, [hr, mask], 8, 4, **kw)
    assert res["steps"] == 8
    assert_same_state(full, second)


@pytest.mark.parametrize("before,after", [("fit", "fit_device"),
                                          ("fit_device", "fit")])
def test_each_loop_resumes_the_others_checkpoint(tmp_path, before, after):
    """Two epochs in one loop, a restart, two more in the other: the state
    of four uninterrupted epochs (of either loop: they are equal)."""
    x, hr, mask = tiny_data(29, n=12)
    params = init_params(2)
    val = [x[:4], hr[:4], mask[:4]]
    kw = dict(val_data=val, val_steps=1, save_best_only=False, seed=8)
    full = tiny_trainer(tmp_path / "full", params)
    full.fit(x, [hr, mask], 4, 4, **kw)
    first = tiny_trainer(tmp_path / "mixed", params)
    getattr(first, before)(x, [hr, mask], 4, 2, **kw)
    second = tiny_trainer(tmp_path / "mixed", params)
    assert second.step == 6
    res = getattr(second, after)(x, [hr, mask], 4, 4, **kw)
    assert res["steps"] == 12
    assert_same_state(full, second)


def test_fit_device_resumes_mid_chunk(tmp_path):
    """A checkpoint off fit_device's chunk grid (``fit``'s at step 3;
    chunks of 2 steps): fit_device trains the rest of that chunk and ends
    on the uninterrupted run's state."""
    x, hr, mask = tiny_data(31)
    params = init_params(4)
    kw = dict(val_data=[x[:4], hr[:4], mask[:4]], val_steps=1,
              save_best_only=False, seed=6)
    full = tiny_trainer(tmp_path / "full", params)
    full.fit_device(x, [hr, mask], 2, 1, **kw)
    first = tiny_trainer(tmp_path / "mid", params, eval_step=3)
    first.fit(x, [hr, mask], 2, 1, **kw)      # saves at steps 3, 6 and 8
    for step, path in first.checkpoints():
        if step > 3:
            os.unlink(path)
    second = tiny_trainer(tmp_path / "mid", params)
    assert second.step == 3
    res = second.fit_device(x, [hr, mask], 2, 1, **kw)
    assert res["steps"] == 8
    assert_same_state(full, second)


def test_run_chunk_returns_the_steps_means(tmp_path):
    x, hr, mask = tiny_data(17, n=8)
    params = init_params()
    a = tiny_trainer(tmp_path / "a", params)
    b = tiny_trainer(tmp_path / "b", params)
    idx = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7], [3, 2, 1, 0]])
    data = a.resident((x, hr, mask))
    mean_loss, mean_psnr = a._run_chunk(data, idx)
    steps = [b.train_step(*(torch.from_numpy(v[r.numpy()])
                            for v in (x, hr, mask))) for r in idx]
    assert a.step == b.step == 3
    assert float(mean_loss) == pytest.approx(
        float(np.mean([float(s[0]) for s in steps])), rel=1e-6)
    assert float(mean_psnr) == pytest.approx(
        float(np.mean([float(s[1]) for s in steps])), rel=1e-6)
    assert_same_state(a, b)


# ---------------------------------------------------------------------- #
# --remat                                                                 #
# ---------------------------------------------------------------------- #

def remat_grads(x, params, tier, remat, fused_block=False):
    model = WDSRConv3D(**dict(NET, num_res_blocks=2), fused_stack=tier,
                       fused_block=fused_block, remat=remat)
    model.load_state_dict(params)
    out = model(torch.from_numpy(x))
    return torch.autograd.grad(out.square().mean(),
                               list(model.parameters()))


@pytest.mark.parametrize("fused_block", [False, True])
def test_remat_gradients_equal_the_stored_ones(fused_block, monkeypatch):
    import probav_tpu_torch.models.wdsr as wdsr

    x = tiny_data(3, n=2)[0]
    params = init_params(1, num_res_blocks=2)
    calls = []
    real = wdsr.checkpoint
    monkeypatch.setattr(wdsr, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want = remat_grads(x, params, "off", False, fused_block)
    assert calls == []
    got = remat_grads(x, params, "off", True, fused_block)
    assert len(calls) == 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("tier", ["t", "flat"])
def test_remat_changes_nothing_in_the_kernel_tiers(tier, monkeypatch):
    import probav_tpu_torch.models.wdsr as wdsr

    x = tiny_data(5, n=2)[0]
    params = init_params(2, num_res_blocks=2)
    monkeypatch.setattr(wdsr, "checkpoint", None)   # never called
    for g, w in zip(remat_grads(x, params, tier, True),
                    remat_grads(x, params, tier, False)):
        assert torch.equal(g, w)


def test_remat_leaves_the_forward_without_grad_alone():
    x = torch.from_numpy(tiny_data(7, n=2)[0])
    plain = WDSRConv3D(**NET, fused_stack="off",
                       generator=torch.Generator().manual_seed(0))
    remat = WDSRConv3D(**NET, fused_stack="off", remat=True,
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(plain(x), remat(x))


# ---------------------------------------------------------------------- #
# the CLI                                                                 #
# ---------------------------------------------------------------------- #

def stage5_tree(tmp_path, epochs=2):
    """A synthetic cfg (4 filters, 1 block, batch 4, nadam, l1) with
    ``epochs``, over 8 training and 3 validation patches."""
    from probav_tpu_torch.tools.profile_train import synthetic_batch

    cfgp = write_cfg(str(tmp_path / "synth.cfg"), raw=str(tmp_path / "raw"),
                     out=str(tmp_path / "chkpt"),
                     model_out=str(tmp_path / "mi"),
                     train_out=str(tmp_path / "to"),
                     test_out=str(tmp_path / "te"))
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


@pytest.mark.parametrize("model_type", ["patchNet", "iwdsr"])
def test_cli_device_data_trains_logs_checkpoints_and_resumes(tmp_path,
                                                             model_type):
    cfgp, cfg = stage5_tree(tmp_path)
    args = ["--cfg", cfgp, "--band", "NIR", "--device", "cpu",
            "--eval-step", "1", "--device-data", "--modelType", model_type]
    res = cli.main(args)["NIR"]
    assert res["steps"] == 4 and np.isfinite(res["val_loss"])
    ckpts = sorted(os.listdir(cfg.ckpt_dir("NIR")))
    assert ckpts[-1] == "step_00000004.pt"
    log_dir = cfg.log_dir("NIR")
    assert [s for s, _ in logged(log_dir, "Train loss")] == [1, 2, 3, 4]
    assert [s for s, _ in logged(log_dir, "Test PSNR")][-1] == 4
    stage5_tree(tmp_path, epochs=3)
    assert cli.main(args)["NIR"]["steps"] == 6


def test_cli_remat_trains(tmp_path):
    cfgp, cfg = stage5_tree(tmp_path)
    res = cli.main(["--cfg", cfgp, "--device", "cpu", "--plain",
                    "--remat"])["NIR"]
    assert res["steps"] == 4 and np.isfinite(res["train_loss"])


@pytest.mark.parametrize("model_type,flags", [
    ("fusionNet", ["--device-data"]), ("fusionNet", ["--remat"]),
    ("fusionNet", ["--profile-dir", "trace"]), ("iwdsr", ["--remat"]),
    ("patchNet", ["--device-data", "--profile-dir", "trace"]),
    ("patchNet", ["--remat"]), ("patchNet", ["--remat", "--fused-stack", "t"]),
    ("patchNet", ["--remat", "--fused-stack", "flat"])])
def test_cli_refuses_flags_a_run_does_not_have(tmp_path, model_type, flags):
    """train.py drops them silently; the port refuses them."""
    cfgp, _ = stage5_tree(tmp_path)
    with pytest.raises(ValueError, match=flags[0]):
        cli.main(["--cfg", cfgp, "--device", "cpu", "--modelType",
                  model_type] + flags)


def test_cli_takes_every_single_chip_flag_of_train_py(capsys):
    """train.py's flags but the mesh flags, --stack-loop and --cpu (not
    ported, by decision)."""
    with pytest.raises(SystemExit):
        cli.parse_args(["--help"])
    text = capsys.readouterr().out
    for flag in ("--cfg", "--band", "--modelType", "--bf16", "--fused-stack",
                 "--plain", "--remat", "--staged-decay", "--eval-step",
                 "--save-best-only", "--device-data", "--profile-dir"):
        assert flag in text, flag
