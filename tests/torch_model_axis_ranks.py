"""What the ranks of ``tests/test_torch_model_axis.py`` run, and the
one-process runs they are held to.

``parallel.launch`` starts each rank as a fresh process that imports this
module by name to find its function, so it imports no JAX.  Each rank
function takes the rank's mesh first; what the test checks comes back as
rank 0's result, and each rank's own parameters go to a file under the
given directory.  The trainers write ``metrics.jsonl`` only
(``torch_parallel_ranks._no_tensorboard``).
"""

import os
import shutil

import numpy as np
import torch

from probav_tpu_torch.parallel.mesh import (barrier, batch_share,
                                            gather_state, shard_state)
from torch_parallel_ranks import FIT_NET, LR, STEP_NET, _no_tensorboard

STEPS = 2


def build(net, tier="flat", fused_block=False, remat=False, model="wdsr"):
    from probav_tpu_torch.models.wdsr import IWDSRConv3D, WDSRConv3D

    if model == "iwdsr":
        return IWDSRConv3D(**net)
    return WDSRConv3D(**net, fused_stack=tier, fused_block=fused_block,
                      remat=remat)


def trainer(mesh, params, loss, workdir, net=STEP_NET, tensor_parallel=True,
            **model):
    """A trainer of the model ``build(net, **model)`` from the whole
    state_dict ``params``, the named cfg loss, nadam LR."""
    from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
    from probav_tpu_torch.train.optim import build_optimizer
    from probav_tpu_torch.train.trainer import ModelTrainer

    losses = ShiftCompensatedLosses(target_shape=(48, 48, 1), mesh=mesh)
    tr = ModelTrainer(build(net, **model), losses.by_name(loss),
                      losses.cpsnr, build_optimizer("nadam", LR),
                      os.path.join(workdir, "ckpt"),
                      os.path.join(workdir, "logs"), log_every=1,
                      loss_weighted_fn=losses.weighted(loss), device="cpu",
                      mesh=mesh, tensor_parallel=tensor_parallel)
    tr.init_state(params)
    return tr


def whole_params(tr):
    """The trainer's parameters as one process holds them (gathered from
    the model group where they are split; every rank must call it)."""
    return {k: v.detach().clone() for k, v in
            tr._whole({k: p.detach() for k, p in tr.params.items()}).items()}


def steps(mesh, params, loss, batch, workdir, **kw):
    """The gradients at ``params`` (whole), then STEPS train steps on the
    global ``batch``: {losses, metrics, grads, params (whole), local (this
    rank's own parameters)}."""
    tr = trainer(mesh, params, loss, workdir, **kw)
    share = slice(None) if mesh is None else batch_share(mesh, len(batch[0]))
    t = [torch.from_numpy(np.ascontiguousarray(a[share])) for a in batch]
    _, _, grads = tr.loss_and_grads(*t)
    losses, metrics = [], []
    for _ in range(STEPS):
        loss_v, metric = tr.train_step(*t)
        losses.append(float(loss_v))
        metrics.append(float(metric))
    tr.logger_.close()
    return dict(losses=losses, metrics=metrics,
                grads={k: v.clone() for k, v in tr._whole(grads).items()},
                params=whole_params(tr),
                local={k: v.detach().clone() for k, v in tr.params.items()})


def fit_run(mesh, params, loop, data, workdir):
    """tests/test_torch_parallel.py's tiny fit (FIT_NET, batch 4, 2 epochs
    of 3 steps, validation every 2), ``flat`` tier."""
    x, hr, mask, xv, hrv, mv = data
    tr = trainer(mesh, params, "l1", workdir, net=FIT_NET)
    tr.eval_every = 2
    res = getattr(tr, loop)(x, [hr, mask], 4, 2, val_data=[xv, hrv, mv],
                            save_best_only=False, seed=9)
    tr.logger_.close()
    return res, whole_params(tr)


def _save_rank(out_dir, name, mesh, value):
    torch.save(value, os.path.join(out_dir, f"{name}_rank{mesh.rank}.pt"))


# (name, keyword arguments of ``steps``) of the (1, 2) mesh's step checks.
ONE_BY_TWO = (
    ("off", dict(tier="off")),
    ("flat", dict(tier="flat")),
    ("fused_block", dict(tier="off", fused_block=True)),
    ("remat", dict(tier="off", remat=True)),
    ("t_replicated", dict(tier="t", tensor_parallel=False)),
    ("iwdsr", dict(model="iwdsr")),
)


def one_by_two(mesh, spec):
    """Every check of the (data 1, model 2) mesh in one run: the state cut
    and put together again, the step variants of ONE_BY_TWO, fit and
    fit_device, and a restore of a one-process checkpoint."""
    _no_tensorboard()
    out_dir, result = spec["out_dir"], {}
    state = spec["state"]
    back = gather_state(shard_state(state, mesh), mesh)
    result["roundtrip"] = all(
        torch.equal(back[key][k].view(torch.int32),
                    state[key][k].view(torch.int32))
        for key in ("params", "mu", "nu") for k in state[key])
    for name, kw in ONE_BY_TWO:
        got = steps(mesh, spec["params"][kw.get("model", "wdsr")], "l1",
                    spec["batch"], os.path.join(out_dir, name), **kw)
        _save_rank(out_dir, name, mesh, got.pop("local"))
        result[name] = got
    for loop in ("fit", "fit_device"):
        result[loop] = fit_run(mesh, spec["fit_params"], loop,
                               spec["fit_data"], os.path.join(out_dir, loop))
    # A checkpoint of one process: restored, it gives that process's
    # parameters on the model axis.
    restore_dir = os.path.join(out_dir, "restore")
    if mesh.is_chief:
        os.makedirs(os.path.join(restore_dir, "ckpt"))
        shutil.copy(spec["one_ckpt"], os.path.join(restore_dir, "ckpt"))
    barrier(mesh)
    tr = trainer(mesh, spec["fit_params"], "l1", restore_dir, net=FIT_NET)
    result["restored"] = (tr.step, whole_params(tr))
    _save_rank(out_dir, "restored", mesh,
               {k: v.detach().clone() for k, v in tr.params.items()})
    return result


def two_by_two(mesh, spec):
    """The (data 2, model 2) mesh: the flat tier's steps with each loss of
    ``spec["losses"]``."""
    _no_tensorboard()
    result = {}
    for loss in spec["losses"]:
        got = steps(mesh, spec["params"], loss, spec["batch"],
                    os.path.join(spec["out_dir"], f"{loss}_{mesh.rank}"),
                    tier="flat")
        _save_rank(spec["out_dir"], loss, mesh, got.pop("local"))
        result[loss] = got
    return result
