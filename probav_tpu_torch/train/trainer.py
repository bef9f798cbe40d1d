"""Training runtime: train/eval steps, checkpoint and resume, the eval loop
and logging (port of ``probav_tpu/train/trainer.py``: the streamed ``fit``
and the device-resident ``fit_device``).

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
  rows when the model runs the "t" kernel stack or under a mesh (the JAX
  trainer pads for its "t" tier and its mesh), so both the metric and the
  loss stay exact;
- ``fit(profile_dir=...)`` traces global steps 10 to 19
  (``PROFILE_WINDOW``, the JAX trainer's default ``profile_window``, which
  the port does not take as an argument) into that directory
  (``utils/profiling.trace``: a Chrome trace of the device's activity,
  where the JAX trainer writes an xplane).

The step is eager PyTorch: forward, loss, ``torch.autograd.grad``, the
optimizer update (in place), then the metric under ``torch.no_grad``.
``fit`` feeds it batches gathered on the host and copied to the device by
a prefetch thread.  ``fit_device`` keeps the dataset on the device and
gathers each batch there (``index_select``); the host draws the epoch
permutations (the same stream as ``fit``'s batcher for one seed), copies
each epoch's indices once, and reads back one (mean loss, mean cPSNR) pair
per chunk of ``min(eval_step, steps per epoch)`` steps.  The JAX trainer
runs a chunk as one ``lax.scan``; the port runs the same eager step in a
Python loop (``_run_chunk``) that reads nothing back.  Checkpoints are
``torch.save`` files of (params, optimizer state, step, best_psnr), the
same for both loops, so either resumes the other's.

Under a data mesh (``mesh=``, ``probav_tpu_torch.parallel``; one process a
device, started by ``parallel.launch``) every rank runs this trainer on its
equal share of each global batch, and the step is the one-device step on
the global batch:
- ``fit``: every rank's ``Batcher`` draws the same permutation and
  gathers only its ``batch_share`` of each batch on the host;
  ``fit_device``: every rank holds the whole dataset on its device (the
  JAX trainer shards it over 'data') and gathers its share of each step's
  indices;
- the gradients, the loss and the cPSNR of a step are averaged over the
  data group in one all-reduce of one flat buffer before the update, so
  the update, the logged values and the parameters are equal on every
  rank.  ``torch.autograd.grad`` fires no ``DistributedDataParallel``
  hook, so the trainer reduces itself; on NCCL the all-reduce reads
  nothing back to the host;
- validation pads every ragged batch, each rank scores its share, and the
  weighted sums are summed over the group (the losses do so themselves
  when built with the mesh, ``ShiftCompensatedLosses(mesh=...)``);
- the parameters, the optimizer state, the step and the best cPSNR are
  broadcast from rank 0 after ``init_state``; rank 0 alone writes
  checkpoints (a barrier follows each save), scalar logs and the profile
  trace; every rank restores the newest checkpoint.

On a mesh with a model axis (M > 1, ``tensor_parallel``, the JAX
trainer's argument) the trainer puts the model on it
(``WDSRConv3D.shard_``: each block's expand / decay pair split over the M
ranks of a model group, which see the same rows); ``IWDSRConv3D`` and
``FuseNetConv2D`` have no such pair and stay replicated.  Then:
- the state is drawn or broadcast whole and each rank keeps its part
  (``parallel.mesh.shard_state``); a checkpoint holds the whole state,
  gathered from the model group's parts before rank 0 writes it
  (``gather_state``), so it resumes under any mesh and in one process;
- a split parameter's gradient is averaged over the data group; every
  replicated one, with the loss and the cPSNR, over every rank of the
  mesh: the ranks of a model group hold them alike, so this is their mean
  over the data group, and it keeps the replicated parameters equal to
  the bit on every rank even where the card's convolution gradients are
  not deterministic;
- validation sums the metric's terms over every rank (the model
  ranks' alike, so the ratio is the data group's and equal on every
  rank, as the save-best decision after it must be).
The "t" tier refuses a model axis (the JAX trainer's ValueError);
``tensor_parallel=False`` replicates every parameter, so it runs.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import re
import time
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from probav_tpu_torch.data.loader import Batcher, prefetch_to_device
from probav_tpu_torch.parallel.mesh import (all_mean, barrier, batch_share,
                                            broadcast_, gather_state,
                                            shard_dim, shard_state)
from probav_tpu_torch.train.metrics import Mean, ScalarLogger
from probav_tpu_torch.train.optim import Optimizer, state_to
from probav_tpu_torch.utils.profiling import trace

logger = logging.getLogger("probav_tpu_torch.train")

# The global steps [start, stop) that ``fit(profile_dir=...)`` traces.
PROFILE_WINDOW = (10, 20)

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
    (hr, mask, pred, w[B]) makes padded validation batches exact.  With a
    ``mesh`` (``parallel.Mesh``) the trainer runs on ``mesh.device`` and
    ``device`` is ignored; ``tensor_parallel`` (with a model axis above 1)
    splits the model's expand / decay pairs over it (module docstring).
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 metric_fn: Callable, optimizer: Optimizer, ckpt_dir: str,
                 log_dir: str, eval_step: int = 1000, log_every: int = 20,
                 loss_weighted_fn: Optional[Callable] = None,
                 device="cuda", mesh=None, tensor_parallel: bool = True):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else \
            torch.device(device)
        # Whether this rank holds a part of some parameters.
        self.sharded = (mesh is not None and tensor_parallel
                        and mesh.model_size > 1 and hasattr(model, "shard_"))
        if self.sharded:
            model.shard_(mesh)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.loss_w_fn = loss_weighted_fn
        self.metric_fn = metric_fn
        self.tx = optimizer
        self.eval_every = eval_step
        self.log_every = log_every
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.logger_ = ScalarLogger(log_dir if self.is_chief else None)
        self.best_psnr = 1.0   # reference init
        self.params = dict(self.model.named_parameters())
        self.opt_state: Optional[dict] = None
        self.step = 0
        # Band normalization as data, as the JAX trainer passes it.
        self.norm = torch.tensor([getattr(model, "mean", 0.0),
                                  getattr(model, "std", 1.0)],
                                 dtype=torch.float32, device=self.device)

    @property
    def is_chief(self) -> bool:
        """Whether this process writes checkpoints and logs: rank 0 of a
        mesh, or the only process."""
        return self.mesh is None or self.mesh.is_chief

    # ------------------------------------------------------------------ #
    # state init / checkpointing                                          #
    # ------------------------------------------------------------------ #

    def init_state(self, params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> None:
        """Start from the model's own (seeded) weights or ``params`` (a
        state_dict, e.g. ``convert.load_npz``; the whole one on a model
        axis), with a fresh optimizer state; then resume from the latest
        checkpoint if there is one.  Under a mesh, rank 0's state is then
        broadcast to every rank."""
        if params is not None:
            self.model.load_state_dict(self._part(params))
        self.opt_state = state_to(self.tx.init(self.params), self.device)
        self.step = 0
        self.restore()
        if self.mesh is not None:
            self._broadcast_state()

    def _part(self, state: Mapping) -> Mapping:
        """This rank's part of a whole state (itself unless sharded)."""
        return shard_state(state, self.mesh) if self.sharded else state

    def _whole(self, state: Mapping) -> Mapping:
        """The whole state from the model group's parts (every rank of the
        group must call it; ``state`` itself unless sharded)."""
        return gather_state(state, self.mesh) if self.sharded else state

    def _broadcast_state(self) -> None:
        """Rank 0's parameters, optimizer state, step and best cPSNR on
        every rank, whatever their seeds or checkpoints: on a model axis
        the whole state is gathered, broadcast, and cut again."""
        # The parameters and moments (adam, nadam; sgd has none).
        mine = {"params": {k: p.detach() for k, p in self.params.items()},
                **{key: self.opt_state[key] for key in ("mu", "nu")
                   if key in self.opt_state}}
        whole = self._whole(mine)
        broadcast_([t for part in whole.values() for t in part.values()],
                   self.mesh)
        if self.sharded:
            new = self._part(whole)
            with torch.no_grad():
                for key, part in mine.items():
                    for k, t in part.items():
                        t.copy_(new[key][k])
        meta = torch.tensor([self.step, int(self.opt_state["count"]),
                             self.best_psnr], dtype=torch.float64,
                            device=self.device)
        broadcast_([meta], self.mesh)
        step, count, best = meta.tolist()
        self.step, self.best_psnr = int(step), best
        self.opt_state["count"] = torch.tensor(int(count), dtype=torch.int32)

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
        self.model.load_state_dict(self._part(ck["params"]))
        self.opt_state = state_to(self._part(ck["opt_state"]), self.device)
        self.step = int(ck["step"])
        self.best_psnr = float(ck["best_psnr"])
        logger.info("[ INFO ] Model restored from checkpoint at step %d.",
                    self.step)
        return True

    def save(self) -> str:
        """Write the checkpoint of this step; keep the last MAX_TO_KEEP.
        Under a mesh only rank 0 writes, and every rank waits for it; on a
        model axis the whole state is gathered first (by every rank)."""
        path = os.path.join(self.ckpt_dir, f"step_{self.step:08d}.pt")
        params = self._whole(self.model.state_dict())
        opt_state = self._whole(self.opt_state)
        if self.is_chief:
            self._write(path, params, opt_state)
        if self.mesh is not None:
            barrier(self.mesh)
        return path

    def _write(self, path: str, params: Mapping, opt_state: dict) -> None:
        payload = {
            "params": {k: v.detach().cpu() for k, v in params.items()},
            "opt_state": state_to(opt_state, "cpu"),
            "step": self.step,
            "best_psnr": float(self.best_psnr),
        }
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for _, old in self.checkpoints()[:-MAX_TO_KEEP]:
            os.unlink(old)

    # ------------------------------------------------------------------ #
    # steps                                                               #
    # ------------------------------------------------------------------ #

    def _local_grads(self, lr, hr, mask):
        """(loss, pred, {name: gradient}) of this process's batch."""
        pred = self.model(lr, self.norm)
        loss = self.loss_fn(hr, mask, pred)
        grads = torch.autograd.grad(loss, list(self.params.values()))
        return loss, pred, dict(zip(self.params, grads))

    def _data_mean(self, scalars: list, grads: dict) -> tuple:
        """The scalars and gradients averaged over the mesh's data group:
        in one all-reduce without a model axis; on one, the split
        gradients over the data group and the rest over every rank
        (module docstring)."""
        split = [k for k, g in grads.items()
                 if self.sharded and shard_dim(k, g.dim()) is not None]
        rest = [k for k in grads if k not in split]
        scalars = [v.detach().reshape(1) for v in scalars]
        out = all_mean(scalars + [grads[k] for k in rest], self.mesh,
                       over="world" if self.mesh.model_size > 1 else "data")
        means = dict(zip(rest, out[len(scalars):]))
        if split:
            means.update(zip(split, all_mean([grads[k] for k in split],
                                             self.mesh)))
        return [v[0] for v in out[:len(scalars)]], \
            {k: means[k] for k in grads}

    def loss_and_grads(self, lr, hr, mask):
        """(loss, pred, {name: gradient}) at the current parameters.  Under
        a mesh the loss and the gradients are the global batch's (averaged
        over the data group) and pred is this rank's share's."""
        loss, pred, grads = self._local_grads(lr, hr, mask)
        if self.mesh is not None:
            (loss,), grads = self._data_mean([loss], grads)
        return loss, pred, grads

    def train_step(self, lr, hr, mask):
        """One update; returns (loss, metric) as device scalars, the global
        batch's under a mesh."""
        loss, pred, grads = self._local_grads(lr, hr, mask)
        with torch.no_grad():
            metric = self.metric_fn(hr, mask, pred.detach()).mean()
        if self.mesh is not None:
            (loss, metric), grads = self._data_mean([loss, metric], grads)
        self.tx.step(self.params, grads, self.opt_state)
        self.step += 1
        return loss.detach(), metric

    @torch.no_grad()
    def eval_step(self, lr, hr, mask, w):
        """(loss, metric) with per-sample weights w [B]; rows with w == 0
        (padding) do not count.  Under a mesh, of the rows of every rank:
        ``loss_weighted_fn`` sums over the data group itself; the metric's
        sums, or a plain ``loss_fn``'s value, are reduced here, over every
        rank: a model group's ranks score the same rows, so the sums grow
        M-fold alike and their ratio is the data group's, the same on
        every rank (the save-best decision that follows must be: ``save``
        is collective)."""
        pred = self.model(lr, self.norm)
        num, den = (self.metric_fn(hr, mask, pred) * w).sum(), w.sum()
        if self.loss_w_fn is not None:
            loss = self.loss_w_fn(hr, mask, pred, w)
        else:
            loss = self.loss_fn(hr, mask, pred)
        if self.mesh is not None:
            mean_loss = [] if self.loss_w_fn else [loss / self.mesh.world]
            sums = torch.stack([num, den] + mean_loss)
            dist.all_reduce(sums)
            num, den = sums[0], sums[1]
            if mean_loss:
                loss = sums[2]
        return loss, num / den

    # ------------------------------------------------------------------ #
    # fit loop                                                            #
    # ------------------------------------------------------------------ #

    def fit(self, x: np.ndarray, y: Sequence[np.ndarray], batch_size: int,
            epochs: int, val_data: Sequence[np.ndarray], val_steps: int = 64,
            save_best_only: bool = True, init_epoch: int = 0,
            seed: int = 17, profile_dir: Optional[str] = None) -> dict:
        """Train ``epochs`` epochs (the total, counting restored steps) on
        batches gathered on the host.  With ``profile_dir``, the global
        steps of ``PROFILE_WINDOW`` run under ``utils.profiling.trace``
        into that directory; the device is synchronized before the trace
        stops, also where the run ends inside the window.  Under a mesh
        ``batch_size`` is the global batch (it must divide by the data
        size) and only rank 0 traces."""
        hr, mask = y
        share = self._share(batch_size)
        if self.opt_state is None:
            self.init_state()
        train_batcher = Batcher((x, hr, mask), batch_size, seed=seed,
                                rows=share)
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
        batches = train_batcher.repeat(epochs - done_epochs, skip=step)
        stream = prefetch_to_device(batches, self.device)
        world = 1 if self.mesh is None else self.mesh.data_size
        if not self.is_chief:
            profile_dir = None
        with contextlib.ExitStack() as profiling:
            for lr_b, hr_b, mask_b in stream:
                if total_steps - step == 0:
                    epoch += 1
                    step = self.step % total_steps
                    logger.info("[ *** NEW EPOCH *** ] Epoch number %d",
                                epoch)
                    train_loss.reset()
                    train_psnr.reset()
                step += 1
                global_step += 1
                if profile_dir is not None:
                    if global_step == PROFILE_WINDOW[0]:
                        profiling.enter_context(trace(profile_dir,
                                                      self.device))
                        # Runs first on close: the trace ends with the
                        # device's queue, also where the run ends early.
                        profiling.callback(self._sync)
                    elif global_step == PROFILE_WINDOW[1]:
                        profiling.close()
                loss, metric = self.train_step(lr_b, hr_b, mask_b)
                train_loss.update(loss)
                train_psnr.update(metric)
                seen += len(lr_b) * world

                if global_step % self.log_every == 0 or step == total_steps:
                    tl, tp = train_loss.result(), train_psnr.result()
                    logger.info(
                        "[ EPOCH %d/%d ] - [ STEP %d/%d ] Loss: %.6f, "
                        "cPSNR: %.3f", epoch, epochs, step, total_steps, tl,
                        tp)
                    self.logger_.scalar("Train PSNR", tp, global_step)
                    self.logger_.scalar("Train loss", tl, global_step)

                if step != 0 and step % self.eval_every == 0:
                    val_loss, val_psnr = self.evaluate(val_batcher,
                                                       val_steps)
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

    # ------------------------------------------------------------------ #
    # device-resident loop                                                #
    # ------------------------------------------------------------------ #

    def _share(self, n: int) -> slice:
        """This rank's rows of a global batch of n: all of them without a
        mesh; ValueError where n does not divide by the data size."""
        return slice(None) if self.mesh is None else \
            batch_share(self.mesh, n)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def resident(self, arrays: Sequence[np.ndarray]) -> tuple:
        """The arrays as float32 tensors on the device: one host-to-device
        copy each (on the CPU, the arrays' own memory where they are
        float32 already)."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                     .to(self.device) for a in arrays)

    def _run_chunk(self, data: Sequence[torch.Tensor], idx: torch.Tensor
                   ) -> tuple:
        """One train step for each row of ``idx`` ([K, batch] int64 on the
        device), its batch gathered from ``data`` (``resident``'s (x, hr,
        mask)) on the device.  Returns the steps' mean loss and mean cPSNR
        as device scalars; reads nothing back, so the host can run ahead
        of the device for the whole chunk."""
        losses, metrics = [], []
        for rows in idx:
            loss, metric = self.train_step(
                *(a.index_select(0, rows) for a in data))
            losses.append(loss)
            metrics.append(metric)
        return torch.stack(losses).mean(), torch.stack(metrics).mean()

    def fit_device(self, x: np.ndarray, y: Sequence[np.ndarray],
                   batch_size: int, epochs: int,
                   val_data: Sequence[np.ndarray], val_steps: int = 64,
                   save_best_only: bool = True, seed: int = 17) -> dict:
        """Train with the dataset resident on the device (the JAX
        trainer's ``fit_device``).

        ``rng = np.random.default_rng(seed)`` draws one permutation an
        epoch, cut to ``[steps per epoch, batch_size]``: the batches of
        ``fit``'s ``Batcher(seed=seed)``, in the same order.  Each epoch's
        indices go to the device once; the steps run in chunks of
        ``min(eval_step, steps per epoch)`` (``_run_chunk``), each followed
        by one readback of its mean loss and cPSNR, which are logged at the
        chunk's last global step.  Validation (and the save-best-gated
        checkpoint) follows a chunk that crosses a multiple of
        ``eval_step``; a final validation and save end the run.  Resume
        replays the permutation draws of completed epochs and skips the
        steps done in the current one (the JAX trainer skips whole chunks,
        which is the same wherever a checkpoint lies on a chunk boundary,
        as both loops' checkpoints do at equal ``eval_step``).

        Under a mesh every rank holds the whole dataset on its device (the
        JAX trainer shards it over 'data') and gathers its
        ``batch_share`` of each step's indices."""
        hr, mask = y
        share = self._share(batch_size)
        if self.opt_state is None:
            self.init_state()
        data = self.resident((x, hr, mask))
        n = len(x)
        steps_per_epoch = max(1, n // batch_size)
        chunk = min(self.eval_every, steps_per_epoch)
        rng = np.random.default_rng(seed)
        val_batcher = Batcher(tuple(val_data), batch_size, seed=seed + 1,
                              drop_remainder=False)

        global_step = self.step
        done_epochs = global_step // steps_per_epoch
        for _ in range(done_epochs):
            rng.permutation(n)
        resume_step = global_step - done_epochs * steps_per_epoch
        last = {"val_psnr": float("nan"), "val_loss": float("nan")}
        t_start = time.time()
        seen = 0
        logger.info("[ INFO ] Begin training (dataset on %s)...",
                    self.device)
        for epoch in range(done_epochs, epochs):
            perm = rng.permutation(n)[:steps_per_epoch * batch_size]
            perm = perm.reshape(steps_per_epoch, batch_size)[:, share]
            perm = torch.from_numpy(np.ascontiguousarray(perm)).to(
                self.device)
            first = resume_step if epoch == done_epochs else 0
            for start in range(0, steps_per_epoch, chunk):
                idx = perm[max(start, first):start + chunk]
                if len(idx) == 0:
                    continue
                mean_loss, mean_psnr = self._run_chunk(data, idx)
                k = len(idx)
                global_step += k
                seen += k * batch_size
                tl, tp = float(mean_loss), float(mean_psnr)
                self.logger_.scalar("Train loss", tl, global_step)
                self.logger_.scalar("Train PSNR", tp, global_step)
                logger.info("[ EPOCH %d/%d ] step %d loss %.6f cPSNR %.3f",
                            epoch, epochs, global_step, tl, tp)
                if global_step % self.eval_every < k:
                    val_loss, val_psnr = self.evaluate(val_batcher,
                                                       val_steps)
                    last.update(val_psnr=val_psnr, val_loss=val_loss)
                    self.logger_.scalar("Test loss", val_loss, global_step)
                    self.logger_.scalar("Test PSNR", val_psnr, global_step)
                    logger.info("[ *** VAL *** ] loss: %.6f, PSNR: %.3f",
                                val_loss, val_psnr)
                    if not save_best_only or val_psnr > self.best_psnr:
                        self.best_psnr = max(self.best_psnr, val_psnr)
                        self.save()
        elapsed = time.time() - t_start
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
            "epochs": epochs,
            "patches_per_sec": seen / elapsed if elapsed > 0 else 0.0,
            **last,
        }

    def evaluate(self, val_batcher: Batcher, val_steps: int) -> tuple:
        """(loss, cPSNR) over ``val_steps`` batches of the validation set.
        Under a mesh every batch is padded to the full size and each rank
        scores its share of it."""
        test_loss, test_psnr = Mean("testLoss"), Mean("testPSNR")
        full = val_batcher.batch_size
        rng = np.random.default_rng((val_batcher.seed, self.step))
        src = itertools.islice(val_batcher.epoch(rng=rng), val_steps)
        pad_ragged = self.mesh is not None or \
            getattr(self.model, "fused_stack", "off") == "t"
        share = self._share(full)
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
                yield lr_b[share], hr_b[share], mask_b[share], w[share]

        for i, (lr_b, hr_b, mask_b, w) in enumerate(
                prefetch_to_device(padded(src), self.device)):
            loss, metric = self.eval_step(lr_b, hr_b, mask_b, w)
            test_loss.update(loss, weight=counts[i])
            test_psnr.update(metric, weight=counts[i])
        return test_loss.result(), test_psnr.result()
