"""What the ranks of ``tests/test_torch_parallel.py`` run.

``parallel.launch`` starts each rank as a fresh process that imports this
module by name to find its function, so it imports no JAX.  Each function
takes the rank's mesh first; what the test checks comes back as rank 0's
result, or, per rank, in files under the given directory.  The trainers
of the ranks write ``metrics.jsonl`` only: each rank function blocks
``torch.utils.tensorboard``, whose import (TensorFlow) takes ~20 s a
process here.
"""

import os
import sys
import time

import numpy as np
import torch

from probav_tpu_torch.parallel.mesh import batch_share

LR = 1e-3
# tests/test_torch_train_step.py's geometry.
STEP_NET = dict(scale=3, num_filters=8, num_res_blocks=2, exp_rate=2,
                decay_rate=0.8, num_img_lr=9, patch_size_lr=16,
                mean=8000.0, std=3000.0)
# tests/test_torch_fit_device.py's tiny setup.
FIT_NET = dict(scale=3, num_filters=4, num_res_blocks=1, exp_rate=2,
               decay_rate=0.8, num_img_lr=9, patch_size_lr=16, mean=100.0,
               std=50.0)
# tests/test_e2e.py's mesh resolver (384x384 scenes of 8x8 patches).
RESOLVER_NET = FIT_NET


def _no_tensorboard():
    sys.modules["torch.utils.tensorboard"] = None


def step_trainer(mesh, params, loss, workdir, net=None):
    """A "t"-tier trainer (the plain twins on the CPU) from the
    state_dict ``params`` with the named cfg loss, nadam LR."""
    from probav_tpu_torch.models.wdsr import WDSRConv3D
    from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
    from probav_tpu_torch.train.optim import build_optimizer
    from probav_tpu_torch.train.trainer import ModelTrainer

    model = WDSRConv3D(**(net or STEP_NET), fused_stack=True)
    model.load_state_dict(params)
    losses = ShiftCompensatedLosses(target_shape=(48, 48, 1), mesh=mesh)
    tr = ModelTrainer(model, losses.by_name(loss), losses.cpsnr,
                      build_optimizer("nadam", LR),
                      os.path.join(workdir, "ckpt"),
                      os.path.join(workdir, "logs"), log_every=1,
                      loss_weighted_fn=losses.weighted(loss), device="cpu",
                      mesh=mesh)
    tr.init_state()
    return tr


def one_step(mesh, params, loss, batch, workdir):
    """(loss, cPSNR, gradients, parameters after the step) of one train
    step on the global ``batch``; this rank takes its share of it."""
    tr = step_trainer(mesh, params, loss, workdir)
    share = slice(None) if mesh is None else batch_share(mesh, len(batch[0]))
    t = [torch.from_numpy(np.ascontiguousarray(a[share])) for a in batch]
    _, _, grads = tr.loss_and_grads(*t)
    loss_v, metric = tr.train_step(*t)
    tr.logger_.close()
    return dict(loss=float(loss_v), metric=float(metric),
                grads={k: v.numpy().copy() for k, v in grads.items()},
                params={k: v.detach().numpy().copy()
                        for k, v in tr.params.items()})


def _save_rank(out_dir, name, mesh, value):
    torch.save(value, os.path.join(out_dir, f"{name}_rank{mesh.rank}.pt"))


def fit_trainer(mesh, params, workdir, writes):
    """tests/test_torch_fit_device.py's tiny trainer, "t" tier, eval every
    2 steps; ``writes`` counts the checkpoints this rank writes."""
    tr = step_trainer(mesh, params, "l1", workdir, net=FIT_NET)
    tr.eval_every = 2
    write = tr._write

    def counted(path, *state):
        writes.append(os.path.basename(path))
        write(path, *state)

    tr._write = counted
    return tr


def fit_run(mesh, params, loop, data, workdir, writes):
    x, hr, mask, xv, hrv, mv = data
    tr = fit_trainer(mesh, params, workdir, writes)
    res = getattr(tr, loop)(x, [hr, mask], 4, 2, val_data=[xv, hrv, mv],
                            save_best_only=False, seed=9)
    tr.logger_.close()
    return res, {k: v.detach().clone() for k, v in tr.params.items()}


def two_ranks(mesh, spec):
    """Every 2-rank check of the test module in one run (a spawn costs
    seconds): the train step for each loss, fit and fit_device with a
    resume, and the resolver with and without TTA."""
    _no_tensorboard()
    out_dir = spec["out_dir"]
    result = {}
    for loss in spec["losses"]:
        got = one_step(mesh, spec["step_params"], loss, spec["batch"],
                       os.path.join(out_dir, f"step_{loss}_r{mesh.rank}"))
        _save_rank(out_dir, f"step_{loss}", mesh, got["params"])
        result[loss] = got

    writes = {}
    for loop in ("fit", "fit_device"):
        writes[loop] = []
        res, params = fit_run(mesh, spec["fit_params"], loop,
                              spec["fit_data"],
                              os.path.join(out_dir, loop), writes[loop])
        _save_rank(out_dir, loop, mesh, params)
        result[loop] = res
    # Resume: a fresh run directory holding only the uninterrupted fit's
    # step-2 checkpoint; the run restores it and goes on to the end.
    resume_dir = os.path.join(out_dir, "resume")
    if mesh.is_chief:
        os.makedirs(os.path.join(resume_dir, "ckpt"))
        name = "step_00000002.pt"
        os.link(os.path.join(out_dir, "fit", "ckpt", name),
                os.path.join(resume_dir, "ckpt", name))
    from probav_tpu_torch.parallel.mesh import barrier
    barrier(mesh)
    writes["resume"] = []
    res, params = fit_run(mesh, spec["fit_params"], "fit", spec["fit_data"],
                          resume_dir, writes["resume"])
    _save_rank(out_dir, "resume", mesh, params)
    result["resume"] = res
    _save_rank(out_dir, "writes", mesh, writes)

    result["resolver"] = resolve(mesh, spec["resolver_params"],
                                 spec["scenes"], spec["tta_repeats"])
    return result


def resolve(mesh, params, scenes, tta_repeats):
    """{tta: scenes} of Resolver.resolve_all with and without TTA, and
    under "scene_tta" resolve_scene_tta of the first scene."""
    from probav_tpu_torch.infer import Resolver
    from probav_tpu_torch.models import WDSRConv3D

    r = Resolver(WDSRConv3D(**RESOLVER_NET, fused_stack=True), params,
                 scene_size=384, device="cpu", mesh=mesh)
    out = {tta: np.stack(r.resolve_all(scenes, tta=tta,
                                       tta_repeats=tta_repeats))
           for tta in (False, True)}
    out["scene_tta"] = r.resolve_scene_tta(scenes[0], repeats=tta_repeats)
    return out


def four_ranks(mesh, spec):
    """One l1 train step at batch 8 on 4 ranks; every rank's parameters
    after it go to a file."""
    _no_tensorboard()
    got = one_step(mesh, spec["params"], "l1", spec["batch"],
                   os.path.join(spec["out_dir"], f"r{mesh.rank}"))
    _save_rank(spec["out_dir"], "step4", mesh, got["params"])
    return got


def failing(mesh):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    import torch.distributed as dist
    dist.all_reduce(torch.ones(1))
    return "unreachable"


def sleeping(mesh):
    time.sleep(600)
