"""The port's train CLI (python3 -m probav_tpu_torch.train) on the CPU, on
a synthetic stage-5 tree: it trains a few steps, writes metrics.jsonl with
the reference's tags and a checkpoint, and a rerun with more epochs resumes
from that checkpoint; each cfg loss trains; --modelType iwdsr on the same
tree, and --modelType fusionNet on a two-band tree of served scenes."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from probav_tpu_torch.config import Config
from probav_tpu_torch.tools.profile_train import synthetic_batch
from probav_tpu_torch.train import cli
from synthetic_data import write_cfg

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stage5_tree(tmp_path, epochs=2):
    """The synthetic cfg (4 filters, 1 block, batch 4, nadam, l1) with
    ``epochs``, over 8 training and 3 validation patches."""
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


@pytest.fixture
def tf32_on(monkeypatch):
    """cuDNN's and cuBLAS's TF32 switched on (cuDNN's default), restored
    after the test."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)


def test_train_cli_trains_logs_checkpoints_and_resumes(tmp_path, tf32_on):
    """The float32 CLI also turns TF32 off (cuDNN and matmul), so its convs
    compute float32 products on the card."""
    cfgp, cfg = stage5_tree(tmp_path)
    args = ["--cfg", cfgp, "--band", "NIR", "--device", "cpu",
            "--eval-step", "2"]
    res = cli.main(args)["NIR"]
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert res["steps"] == 4 and np.isfinite(res["train_loss"])
    ckpts = sorted(os.listdir(cfg.ckpt_dir("NIR")))
    assert ckpts[-1] == "step_00000004.pt"
    with open(os.path.join(cfg.log_dir("NIR"), "metrics.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert tags == {"Train PSNR", "Train loss", "Test PSNR", "Test loss"}

    stage5_tree(tmp_path, epochs=3)
    res = cli.main(args)["NIR"]
    assert res["steps"] == 6
    assert sorted(os.listdir(cfg.ckpt_dir("NIR")))[-1] == "step_00000006.pt"


def test_train_cli_module_runs_and_refuses_cuda_without_a_card(tmp_path):
    """``python3 -m probav_tpu_torch.train`` is the entry point; its
    default device is the card, which this machine lacks."""
    cfgp, _ = stage5_tree(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "probav_tpu_torch.train",
                        "--cfg", cfgp], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def set_cfg(cfgp, old, new):
    with open(cfgp) as f:
        text = f.read()
    assert old in text
    with open(cfgp, "w") as f:
        f.write(text.replace(old, new))


def train_losses(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["value"] for r in recs if r["tag"] == "Train loss"]


@pytest.mark.parametrize("loss", ["sobel_l1_mix", "l1msssim"])
def test_train_cli_takes_each_cfg_loss(tmp_path, loss):
    """One epoch (2 steps) with the cfg's loss: finite losses, a
    checkpoint, and a finite validation loss over the ragged last batch
    (3 patches of 4)."""
    cfgp, cfg = stage5_tree(tmp_path, epochs=1)
    set_cfg(cfgp, "loss=l1", f"loss={loss}")
    res = cli.main(["--cfg", cfgp, "--device", "cpu", "--eval-step",
                    "2"])["NIR"]
    assert res["steps"] == 2
    assert np.isfinite(res["train_loss"]) and np.isfinite(res["val_loss"])
    assert sorted(os.listdir(cfg.ckpt_dir("NIR")))[-1] == "step_00000002.pt"
    assert all(np.isfinite(train_losses(cfg.log_dir("NIR"))))


def test_train_cli_model_type_iwdsr(tmp_path):
    """IWDSRConv3D on the stage-5 tree: its parameters in the checkpoint,
    a resume from it."""
    cfgp, cfg = stage5_tree(tmp_path)
    args = ["--cfg", cfgp, "--device", "cpu", "--modelType", "iwdsr",
            "--eval-step", "2"]
    res = cli.main(args)["NIR"]
    assert res["steps"] == 4 and np.isfinite(res["train_loss"])
    ck = torch.load(os.path.join(cfg.ckpt_dir("NIR"), "step_00000004.pt"),
                    weights_only=True)
    assert "mainConv1_in.gamma" in ck["params"]
    assert "convReducer_0.kernel_v" in ck["params"]
    stage5_tree(tmp_path, epochs=3)
    assert cli.main(args)["NIR"]["steps"] == 6


def served_tree(tmp_path, per_band=6, size=24):
    """A cfg (batch 4) whose TRAIN output dir holds ``per_band`` served
    scenes of each band, numbered as serving RED and NIR writes them, and
    whose resolverDir holds both bands' stage-2 truths (10% masked)."""
    from probav_tpu_torch.infer.resolver import write_submission
    from probav_tpu_torch.utils.io import dump_masked

    cfgp, cfg = stage5_tree(tmp_path, epochs=2)
    r = np.random.default_rng(5)
    resolver = cfg.stage_dir("resolverDir")
    os.makedirs(resolver, exist_ok=True)
    for band in ("RED", "NIR"):
        hr = r.uniform(4000, 12000, (per_band, size, size))
        served = (hr + r.normal(0, 200, hr.shape))[..., None]
        write_submission(served.astype(np.uint16), cfg.out_dir("TRAIN"),
                         band, "TRAIN", removed=())
        hidden = r.uniform(size=hr.shape) < 0.1
        dump_masked(np.ma.masked_array(hr[:, None, None], mask=hidden[
            :, None, None]).astype(np.float32),
            os.path.join(resolver, f"TRAINimgHR_{band}.npy"))
    return cfgp, cfg


def test_train_cli_model_type_fusion_net(tmp_path, monkeypatch):
    """FuseNetConv2D on 12 served scenes (split 0.2: 9 train, 3 val; batch
    4, two epochs: 4 steps), checkpoints and logs under the working
    directory, the served scenes paired with the truths RED first."""
    cfgp, cfg = served_tree(tmp_path)
    names = sorted(os.listdir(cfg.out_dir("TRAIN")))
    assert names[0] == "imgset0000.png" and names[-1] == "imgset0599.png"
    monkeypatch.chdir(tmp_path)
    res = cli.main(["--cfg", cfgp, "--device", "cpu", "--modelType",
                    "fusionNet"])["NIR"]
    assert res["steps"] == 4 and np.isfinite(res["train_loss"])
    assert np.isfinite(res["val_psnr"]) and res["val_psnr"] > 20
    ck = torch.load(os.path.join("fuseNetCkpt", "step_00000004.pt"),
                    weights_only=True)
    assert ck["params"]["conv1.kernel"].shape == (48, 48, 1, 64)
    assert os.path.isfile(os.path.join("fuseNetLogs", "metrics.jsonl"))


@pytest.mark.parametrize("model_type,flags", [
    ("iwdsr", ["--fused-stack", "t"]), ("iwdsr", ["--plain"]),
    ("fusionNet", ["--fused-stack", "off"]), ("fusionNet", ["--bf16"])])
def test_options_without_a_kernel_tier_are_refused(tmp_path, model_type,
                                                   flags):
    """The JAX CLI drops them silently; the port refuses them."""
    cfgp, _ = stage5_tree(tmp_path)
    with pytest.raises(ValueError, match=flags[0]):
        cli.main(["--cfg", cfgp, "--device", "cpu", "--modelType",
                  model_type] + flags)


def test_fused_stack_defaults_to_t_for_patch_net():
    assert cli.parse_args([]).fused_stack == "t"
    assert cli.parse_args(["--plain"]).fused_stack == "off"
    assert cli.parse_args(["--modelType", "iwdsr"]).fused_stack is None
    assert cli.parse_args(["--modelType", "iwdsr", "--bf16"]).bf16
