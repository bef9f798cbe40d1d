"""Training runtime: train/eval steps, checkpoint and resume, the eval loop
and logging (port of ``probav_tpu/train/trainer.py``, streamed ``fit``).

Behaviour kept from the JAX trainer (and its reference):
- sample-accurate resume: ``epochs`` is the total target; a restored run
  replays the permutation draws of completed epochs and skips the consumed
  batches of the current one, so interrupted and uninterrupted runs see the
  same batch stream;
- validation every ``eval_step`` steps of an epoch over ``val_steps``
  batches, on a subset drawn from (val seed, global step), so a resumed
  run scores the same samples at the same step;
- save-best-only gating on validation cPSNR, keep-5 checkpoints, and an
  always-final validation and save;
- a ragged last validation batch is padded to the full batch with weight-0
  rows when the model runs the "t" kernel stack (the JAX trainer pads for
  its "t" tier), so both the metric and the loss stay exact.

The step is eager PyTorch: forward, loss, ``torch.autograd.grad``, the
optimizer update (in place), then the metric under ``torch.no_grad``.
Checkpoints are ``torch.save`` files of (params, optimizer state, step,
best_psnr).  Not ported yet: ``fit_device`` (dataset resident on the
device), meshes and tensor parallelism.
"""

from __future__ import annotations

import itertools
import logging
import os
import re
import time
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from probav_tpu_torch.data.loader import Batcher, prefetch_to_device
from probav_tpu_torch.train.metrics import Mean, ScalarLogger
from probav_tpu_torch.train.optim import Optimizer, state_to

logger = logging.getLogger("probav_tpu_torch.train")

MAX_TO_KEEP = 5
_CKPT = re.compile(r"^step_(\d+)\.pt$")


def list_checkpoints(ckpt_dir: str) -> list:
    """(step, path) of the ``step_*.pt`` checkpoints in ckpt_dir, oldest
    first."""
    found = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return sorted(found)


def restore_params(ckpt_dir: str) -> dict:
    """The model parameters (a state_dict on the CPU) of the newest
    checkpoint that the trainer wrote under ckpt_dir (test.py's
    ``restore_params``)."""
    ckpts = list_checkpoints(ckpt_dir) if os.path.isdir(ckpt_dir) else []
    if not ckpts:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step, path = ckpts[-1]
    ck = torch.load(path, map_location="cpu", weights_only=True)
    logger.info("[ INFO ] Restored checkpoint at step %d.", step)
    return ck["params"]


class ModelTrainer:
    """Drives training of any ``nn.Module`` called as ``model(x, norm)``
    (``WDSRConv3D``, ``IWDSRConv3D``, ``FuseNetConv2D``) with
    shift-compensated losses.  ``norm`` is ``[model.mean, model.std]`` as
    data, ``[0, 1]`` for a model without them.

    ``loss_fn`` and ``metric_fn`` take (hr, mask, pred); ``loss_weighted_fn``
    (hr, mask, pred, w[B]) makes padded validation batches exact.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 metric_fn: Callable, optimizer: Optimizer, ckpt_dir: str,
                 log_dir: str, eval_step: int = 1000, log_every: int = 20,
                 loss_weighted_fn: Optional[Callable] = None,
                 device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.loss_w_fn = loss_weighted_fn
        self.metric_fn = metric_fn
        self.tx = optimizer
        self.eval_every = eval_step
        self.log_every = log_every
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.logger_ = ScalarLogger(log_dir)
        self.best_psnr = 1.0   # reference init
        self.params = dict(self.model.named_parameters())
        self.opt_state: Optional[dict] = None
        self.step = 0
        # Band normalization as data, as the JAX trainer passes it.
        self.norm = torch.tensor([getattr(model, "mean", 0.0),
                                  getattr(model, "std", 1.0)],
                                 dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ #
    # state init / checkpointing                                          #
    # ------------------------------------------------------------------ #

    def init_state(self, params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> None:
        """Start from the model's own (seeded) weights or ``params`` (a
        state_dict, e.g. ``convert.load_npz``), with a fresh optimizer
        state; then resume from the latest checkpoint if there is one."""
        if params is not None:
            self.model.load_state_dict(params)
        self.opt_state = state_to(self.tx.init(self.params), self.device)
        self.step = 0
        self.restore()

    def checkpoints(self) -> list:
        """(step, path) of the checkpoints in ckpt_dir, oldest first."""
        return list_checkpoints(self.ckpt_dir)

    def restore(self) -> bool:
        """Resume from the latest checkpoint."""
        ckpts = self.checkpoints()
        if not ckpts:
            return False
        step, path = ckpts[-1]
        ck = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(ck["params"])
        self.opt_state = state_to(ck["opt_state"], self.device)
        self.step = int(ck["step"])
        self.best_psnr = float(ck["best_psnr"])
        logger.info("[ INFO ] Model restored from checkpoint at step %d.",
                    self.step)
        return True

    def save(self) -> str:
        """Write the checkpoint of this step; keep the last MAX_TO_KEEP."""
        payload = {
            "params": {k: v.detach().cpu()
                       for k, v in self.model.state_dict().items()},
            "opt_state": state_to(self.opt_state, "cpu"),
            "step": self.step,
            "best_psnr": float(self.best_psnr),
        }
        path = os.path.join(self.ckpt_dir, f"step_{self.step:08d}.pt")
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for _, old in self.checkpoints()[:-MAX_TO_KEEP]:
            os.unlink(old)
        return path

    # ------------------------------------------------------------------ #
    # steps                                                               #
    # ------------------------------------------------------------------ #

    def loss_and_grads(self, lr, hr, mask):
        """(loss, pred, {name: gradient}) at the current parameters."""
        pred = self.model(lr, self.norm)
        loss = self.loss_fn(hr, mask, pred)
        grads = torch.autograd.grad(loss, list(self.params.values()))
        return loss, pred, dict(zip(self.params, grads))

    def train_step(self, lr, hr, mask):
        """One update; returns (loss, metric) as device scalars."""
        loss, pred, grads = self.loss_and_grads(lr, hr, mask)
        self.tx.step(self.params, grads, self.opt_state)
        with torch.no_grad():
            metric = self.metric_fn(hr, mask, pred.detach()).mean()
        self.step += 1
        return loss.detach(), metric

    @torch.no_grad()
    def eval_step(self, lr, hr, mask, w):
        """(loss, metric) with per-sample weights w [B]; rows with w == 0
        (padding) do not count."""
        pred = self.model(lr, self.norm)
        metric = (self.metric_fn(hr, mask, pred) * w).sum() / w.sum()
        if self.loss_w_fn is not None:
            loss = self.loss_w_fn(hr, mask, pred, w)
        else:
            loss = self.loss_fn(hr, mask, pred)
        return loss, metric

    # ------------------------------------------------------------------ #
    # fit loop                                                            #
    # ------------------------------------------------------------------ #

    def fit(self, x: np.ndarray, y: Sequence[np.ndarray], batch_size: int,
            epochs: int, val_data: Sequence[np.ndarray], val_steps: int = 64,
            save_best_only: bool = True, init_epoch: int = 0,
            seed: int = 17) -> dict:
        hr, mask = y
        if self.opt_state is None:
            self.init_state()
        train_batcher = Batcher((x, hr, mask), batch_size, seed=seed)
        # Validation keeps partial batches, as the reference does.
        val_batcher = Batcher(tuple(val_data), batch_size, seed=seed + 1,
                              drop_remainder=False)

        total_steps = max(1, len(x) // batch_size)
        global_step = self.step
        done_epochs = min(global_step // total_steps, epochs)
        step = global_step - done_epochs * total_steps
        epoch = init_epoch + done_epochs
        train_batcher.skip_epochs(done_epochs)

        train_loss, train_psnr = Mean("trainLoss"), Mean("trainPSNR")
        last = {"val_psnr": float("nan"), "val_loss": float("nan")}
        t_start = time.time()
        seen = 0

        logger.info("[ INFO ] Begin training...")
        stream = prefetch_to_device(
            train_batcher.repeat(epochs - done_epochs, skip=step),
            self.device)
        for lr_b, hr_b, mask_b in stream:
            if total_steps - step == 0:
                epoch += 1
                step = self.step % total_steps
                logger.info("[ *** NEW EPOCH *** ] Epoch number %d", epoch)
                train_loss.reset()
                train_psnr.reset()
            step += 1
            global_step += 1
            loss, metric = self.train_step(lr_b, hr_b, mask_b)
            train_loss.update(loss)
            train_psnr.update(metric)
            seen += len(lr_b)

            if global_step % self.log_every == 0 or step == total_steps:
                tl, tp = train_loss.result(), train_psnr.result()
                logger.info(
                    "[ EPOCH %d/%d ] - [ STEP %d/%d ] Loss: %.6f, cPSNR: %.3f",
                    epoch, epochs, step, total_steps, tl, tp)
                self.logger_.scalar("Train PSNR", tp, global_step)
                self.logger_.scalar("Train loss", tl, global_step)

            if step != 0 and step % self.eval_every == 0:
                val_loss, val_psnr = self.evaluate(val_batcher, val_steps)
                last.update(val_psnr=val_psnr, val_loss=val_loss)
                self.logger_.scalar("Test loss", val_loss, global_step)
                self.logger_.scalar("Test PSNR", val_psnr, global_step)
                logger.info("[ *** VAL *** ] loss: %.6f, PSNR: %.3f",
                            val_loss, val_psnr)
                self.logger_.flush()
                if save_best_only and val_psnr <= self.best_psnr:
                    continue
                self.best_psnr = max(self.best_psnr, val_psnr)
                logger.info("[ SAVE ] Saving checkpoint...")
                self.save()

        # Final validation and checkpoint, so that a short run still leaves
        # a restorable artifact (as the JAX trainer does).
        elapsed = time.time() - t_start
        if global_step > 0:
            val_loss, val_psnr = self.evaluate(val_batcher, val_steps)
            last.update(val_psnr=val_psnr, val_loss=val_loss)
            self.logger_.scalar("Test loss", val_loss, global_step)
            self.logger_.scalar("Test PSNR", val_psnr, global_step)
            if not save_best_only or val_psnr > self.best_psnr:
                self.best_psnr = max(self.best_psnr, val_psnr)
                self.save()
        self.logger_.flush()
        return {
            "steps": global_step,
            "epochs": epoch,
            "train_loss": train_loss.result(),
            "train_psnr": train_psnr.result(),
            "patches_per_sec": seen / elapsed if elapsed > 0 else 0.0,
            **last,
        }

    def evaluate(self, val_batcher: Batcher, val_steps: int) -> tuple:
        """(loss, cPSNR) over ``val_steps`` batches of the validation set."""
        test_loss, test_psnr = Mean("testLoss"), Mean("testPSNR")
        full = val_batcher.batch_size
        rng = np.random.default_rng((val_batcher.seed, self.step))
        src = itertools.islice(val_batcher.epoch(rng=rng), val_steps)
        pad_ragged = getattr(self.model, "fused_stack", "off") == "t"
        counts: list = []

        def padded(stream):
            for lr_b, hr_b, mask_b in stream:
                true_n = len(lr_b)
                w = np.ones(true_n, np.float32)
                if true_n != full and pad_ragged:
                    pad = lambda a: np.resize(np.asarray(a),
                                              (full,) + a.shape[1:])
                    lr_b, hr_b, mask_b = pad(lr_b), pad(hr_b), pad(mask_b)
                    w = np.resize(w, full)
                    w[true_n:] = 0.0
                counts.append(true_n)
                yield lr_b, hr_b, mask_b, w

        for i, (lr_b, hr_b, mask_b, w) in enumerate(
                prefetch_to_device(padded(src), self.device)):
            loss, metric = self.eval_step(lr_b, hr_b, mask_b, w)
            test_loss.update(loss, weight=counts[i])
            test_psnr.update(metric, weight=counts[i])
        return test_loss.result(), test_psnr.result()
