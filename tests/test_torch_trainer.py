"""The port's trainer runtime (probav_tpu_torch/train/trainer.py) and its
batcher (probav_tpu_torch/data/loader.py) on the CPU: batches equal to the
JAX Batcher's, sample-accurate resume, exact padded evaluation, keep-5
checkpoints and the final save."""

import numpy as np
import pytest
import torch

from probav_tpu.data.loader import Batcher as JaxBatcher
from probav_tpu_torch.data.loader import Batcher, prefetch_to_device
from probav_tpu_torch.models.wdsr import WDSRConv3D
from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
from probav_tpu_torch.tools.profile_train import synthetic_batch
from probav_tpu_torch.train.metrics import Mean
from probav_tpu_torch.train.optim import build_optimizer
from probav_tpu_torch.train.trainer import MAX_TO_KEEP, ModelTrainer

torch.set_num_threads(1)


def test_batcher_matches_jax_batcher():
    x = np.arange(23)[:, None]
    y = -np.arange(23)[:, None]
    for drop in (True, False):
        a = Batcher((x, y), 4, seed=5, drop_remainder=drop)
        b = JaxBatcher((x, y), 4, seed=5, drop_remainder=drop)
        a.skip_epochs(2)
        b.skip_epochs(2)
        got = list(a.repeat(3, skip=1))
        want = list(b.repeat(3, skip=1))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for ga, wa in zip(g, w):
                np.testing.assert_array_equal(ga, wa)
        rng = lambda: np.random.default_rng((5, 7))
        for g, w in zip(a.epoch(rng=rng()), b.epoch(rng=rng())):
            np.testing.assert_array_equal(g[0], w[0])
        assert a.steps_per_epoch == b.steps_per_epoch


def test_prefetch_preserves_order_and_raises_producer_errors():
    x = np.arange(12)[:, None]
    batches = list(Batcher((x,), 4, shuffle=False).epoch())
    got = list(prefetch_to_device(iter(batches), "cpu"))
    assert [int(b[0][0, 0]) for b in got] == [0, 4, 8]
    assert all(torch.is_tensor(b[0]) for b in got)

    def broken():
        yield (x[:4],)
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(prefetch_to_device(broken(), "cpu"))


def test_mean_is_weighted_and_takes_tensors():
    m = Mean()
    m.update(torch.tensor(1.0), weight=8)
    m.update(5.0, weight=2)
    assert m.result() == pytest.approx(1.8)
    assert len(m) == 2
    m.reset()
    assert np.isnan(m.result())


def tiny_trainer(tmp_path, name="run", eval_step=1000):
    model = WDSRConv3D(scale=3, num_filters=4, num_res_blocks=1, exp_rate=2,
                       decay_rate=0.8, num_img_lr=9, patch_size_lr=16,
                       mean=8000.0, std=3000.0, fused_stack=True,
                       generator=torch.Generator().manual_seed(0))
    losses = ShiftCompensatedLosses(target_shape=(48, 48, 1))
    return ModelTrainer(model, losses.l1, losses.cpsnr,
                        build_optimizer("nadam", 1e-3),
                        str(tmp_path / name / "ckpt"),
                        str(tmp_path / name / "logs"), eval_step=eval_step,
                        log_every=1, loss_weighted_fn=losses.weighted("l1"),
                        device="cpu")


def data(n, seed=0):
    lr, hr, mask = synthetic_batch(n, seed=seed)
    return lr, hr * mask, mask


def recorded(trainer):
    """Record the first LR value of each training batch."""
    seen = []
    step = trainer.train_step

    def wrapped(lr, hr, mask):
        seen.append(float(lr[0, 0, 0, 0, 0]))
        return step(lr, hr, mask)

    trainer.train_step = wrapped
    return seen


def test_resumed_fit_sees_the_uninterrupted_stream(tmp_path):
    lr, hr, mask = data(6)
    val = [a[:2] for a in (lr, hr, mask)]
    full = tiny_trainer(tmp_path, "full")
    full.init_state()
    seen_full = recorded(full)
    res = full.fit(lr, [hr, mask], 2, 3, val_data=val, val_steps=1,
                   save_best_only=False)
    assert res["steps"] == 9

    first = tiny_trainer(tmp_path, "resume")
    first.init_state()
    seen = recorded(first)
    first.fit(lr, [hr, mask], 2, 1, val_data=val, val_steps=1,
              save_best_only=False)
    second = tiny_trainer(tmp_path, "resume")
    second.init_state()
    assert second.step == 3
    seen_second = recorded(second)
    res = second.fit(lr, [hr, mask], 2, 3, val_data=val, val_steps=1,
                     save_best_only=False)
    assert res["steps"] == 9
    assert len(seen) == 3 and seen + seen_second == seen_full
    for k, v in full.params.items():
        torch.testing.assert_close(second.params[k], v, rtol=0, atol=1e-6)


def test_padded_eval_equals_unpadded_on_real_rows(tmp_path):
    """5 validation samples at batch 4: the ragged batch of 1 is padded to
    4 with weight-0 rows; loss and cPSNR equal those of the 5 rows."""
    lr, hr, mask = data(5, seed=3)
    tr = tiny_trainer(tmp_path)
    tr.init_state()
    shapes = []
    step = tr.eval_step

    def spy(lr_b, hr_b, mask_b, w):
        shapes.append((len(lr_b), float(w.sum())))
        return step(lr_b, hr_b, mask_b, w)

    tr.eval_step = spy
    loss, psnr = tr.evaluate(Batcher((lr, hr, mask), 4, seed=1,
                                     drop_remainder=False), 8)
    assert shapes == [(4, 4.0), (4, 1.0)]
    losses = ShiftCompensatedLosses(target_shape=(48, 48, 1))
    with torch.no_grad():
        t = [torch.from_numpy(a) for a in (lr, hr, mask)]
        pred = tr.model(t[0], tr.norm)
        want_loss = float(losses.per_sample("l1")(t[1], t[2], pred).mean())
        want_psnr = float(losses.cpsnr(t[1], t[2], pred).mean())
    assert loss == pytest.approx(want_loss, rel=1e-5)
    assert psnr == pytest.approx(want_psnr, rel=1e-6)


def test_keep_five_checkpoints_and_final_save(tmp_path):
    lr, hr, mask = data(2)
    val = [a[:2] for a in (lr, hr, mask)]
    tr = tiny_trainer(tmp_path, eval_step=1)
    tr.init_state()
    tr.fit(lr, [hr, mask], 1, 4, val_data=val, val_steps=1,
           save_best_only=False)
    steps = [s for s, _ in tr.checkpoints()]
    assert len(steps) == MAX_TO_KEEP
    assert steps[-1] == tr.step == 8
    assert steps == list(range(4, 9))
    again = tiny_trainer(tmp_path)
    again.init_state()
    assert again.step == 8
    assert again.best_psnr == tr.best_psnr
    for k in ("mu", "nu"):
        for name, v in tr.opt_state[k].items():
            torch.testing.assert_close(again.opt_state[k][name], v)
