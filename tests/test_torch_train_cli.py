"""The port's train CLI (python3 -m probav_tpu_torch.train) on the CPU, on
a synthetic stage-5 tree: it trains a few steps, writes metrics.jsonl with
the reference's tags and a checkpoint, and a rerun with more epochs resumes
from that checkpoint."""

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


def test_unported_loss_is_refused(tmp_path):
    cfgp, _ = stage5_tree(tmp_path)
    with open(cfgp) as f:
        text = f.read().replace("loss=l1", "loss=l1msssim")
    with open(cfgp, "w") as f:
        f.write(text)
    with pytest.raises(NotImplementedError, match="l1msssim"):
        cli.main(["--cfg", cfgp, "--device", "cpu"])
