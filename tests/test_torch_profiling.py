"""The port's profiling helper (probav_tpu_torch/utils/profiling.py) and
``ModelTrainer.fit(profile_dir=...)`` on the CPU: what ``trace`` records
and writes, and the trace window of ``fit``."""

import json
import os

import numpy as np
import pytest
import torch
import torch.profiler

import probav_tpu_torch.utils.profiling as profiling
from probav_tpu_torch.models.wdsr import WDSRConv3D
from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
from probav_tpu_torch.train.optim import build_optimizer
from probav_tpu_torch.train.trainer import PROFILE_WINDOW, ModelTrainer

torch.set_num_threads(1)


@pytest.mark.parametrize("device,activity", [("cpu", "CPU"),
                                             ("cuda", "CUDA")])
def test_trace_records_the_activity_of_its_device(tmp_path, monkeypatch,
                                                  device, activity):
    """Work on the card is traced by its CUDA activity alone (the CPU
    activity slows a host-bound loop); work on the CPU by the CPU's."""
    made = []

    class FakeProfile:
        def __init__(self, activities):
            made.append(activities)
            self.calls = []

        def start(self):
            self.calls.append("start")

        def stop(self):
            self.calls.append("stop")

        def export_chrome_trace(self, path):
            assert self.calls == ["start", "stop"]
            open(path, "w").close()

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    with profiling.trace(str(tmp_path), device):
        pass
    assert made == [[getattr(torch.profiler.ProfilerActivity, activity)]]
    assert os.listdir(tmp_path) == [profiling.TRACE_FILE]


def test_trace_writes_one_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr"), "cpu"):
        torch.ones(4, 4).matmul(torch.ones(4, 4))
    assert os.listdir(tmp_path / "tr") == [profiling.TRACE_FILE]
    with open(tmp_path / "tr" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def tiny_trainer(tmp_path):
    model = WDSRConv3D(scale=3, num_filters=4, num_res_blocks=1, exp_rate=2,
                       decay_rate=0.8, num_img_lr=9, patch_size_lr=16,
                       mean=100.0, std=50.0, fused_stack="off",
                       generator=torch.Generator().manual_seed(0))
    losses = ShiftCompensatedLosses(target_shape=(48, 48, 1))
    tr = ModelTrainer(model, losses.l1, losses.cpsnr,
                      build_optimizer("nadam", 1e-3),
                      str(tmp_path / "ckpt"), str(tmp_path / "logs"),
                      eval_step=1000, log_every=1000,
                      loss_weighted_fn=losses.weighted("l1"), device="cpu")
    tr.init_state()
    return tr


def tiny_data(n):
    rng = np.random.default_rng(0)
    x = rng.uniform(50, 150, (n, 22, 22, 9, 1)).astype(np.float32)
    hr = rng.uniform(50, 150, (n, 48, 48, 1)).astype(np.float32)
    return x, hr, np.ones_like(hr)


@pytest.mark.parametrize("epochs,traced", [(22, 10), (2, 0), (15, 6)])
def test_fit_traces_its_profile_window(tmp_path, monkeypatch, epochs,
                                       traced):
    """One step an epoch: global steps 10 to 19 are traced, into one file;
    a run that ends before step 10 writes none, and one that ends inside
    the window still writes its trace."""
    assert PROFILE_WINDOW == (10, 20)
    x, hr, mask = tiny_data(1)
    tr = tiny_trainer(tmp_path)
    in_trace = []
    step = tr.train_step

    def spy(*batch):
        in_trace.append(torch._C._autograd._profiler_enabled())
        return step(*batch)

    tr.train_step = spy
    out = tmp_path / "profile"
    res = tr.fit(x, [hr, mask], 1, epochs, val_data=[x, hr, mask],
                 val_steps=1, profile_dir=str(out))
    assert res["steps"] == epochs
    assert sum(in_trace) == traced
    if traced:
        assert in_trace[9:9 + traced] == [True] * traced
        assert os.listdir(out) == [profiling.TRACE_FILE]
    else:
        assert not out.exists()
    assert not torch._C._autograd._profiler_enabled()
