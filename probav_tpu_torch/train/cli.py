"""Training CLI of the PyTorch port (counterpart of ``train.py``).

    python3 -m probav_tpu_torch.train --cfg cfg/p16t9c85r12.cfg --band NIR \\
        [--modelType {patchNet,fusionNet,iwdsr}] [--bf16] [--staged-decay] \\
        [--eval-step N] [--save-best-only] [--device cuda] \\
        [--fused-stack {off,flat,t}] [--plain] [--remat] [--device-data] \\
        [--profile-dir DIR] [--mesh-data N] [--mesh-model M]

``patchNet`` (the default) and ``iwdsr`` load the stage-5 arrays from the
cfg's ``augmentedPatchesDir`` (pickled masked arrays:
``TRAINpatchesLR_<band>.npy``, ``TRAINpatchesHR_<band>.npy`` and their
``TRAINVAL`` twins), build the band's ``WDSRConv3D`` or ``IWDSRConv3D``
from a seeded init, take epochs, batch size, learning rate, optimizer and
loss (``l1``, ``l2``, ``sobel_l1_mix`` or ``l1msssim``) from the cfg, and
train with checkpoint auto-resume.  ``fusionNet`` trains ``FuseNetConv2D``
(v3) on served 384x384 TRAIN scenes: the PNGs of the cfg's TRAIN output
dir, in name order, against the stage-2 truths ``TRAINimgHR_RED.npy`` then
``TRAINimgHR_NIR.npy`` (so the scenes are both bands' served TRAIN scenes,
RED first, as serving RED and NIR into that dir writes them), split by the
cfg's ``split``, float32, loss ``l1``, checkpoints in ``fuseNetCkpt`` and
logs in ``fuseNetLogs`` under the working directory (as train.py).

``--fused-stack`` picks the WDSR-B stack tier of ``patchNet``, as
train.py's flag does: ``t`` (its default) runs it on the hand-written CUDA
kernels, forward and backward; ``flat`` runs a plain forward and the
``wide_bwd`` kernel in each block's backward; ``off`` (or ``--plain``) the
plain PyTorch blocks.  ``iwdsr`` and ``fusionNet`` have no kernel tier: an
explicit ``--fused-stack`` or ``--plain`` with them raises ValueError, as
does ``--bf16`` with ``fusionNet`` (train.py drops them silently).
``--device-data`` (``patchNet`` and ``iwdsr``) trains with
``ModelTrainer.fit_device``: the stage-5 arrays are copied to the device
once, each batch is gathered there, and the host reads back one loss and
cPSNR per chunk of ``min(eval_step, steps per epoch)`` steps.  The JAX CLI
runs each chunk as one ``lax.scan``; the port runs the same eager steps,
with no CUDA graph.  ``--remat`` (``patchNet`` with ``--plain``)
recomputes each block's forward in the backward in the ``off`` tier
(``torch.utils.checkpoint``); the ``t`` and ``flat`` tiers save only
narrow residuals, so ``--remat`` with them raises ValueError (train.py
ignores it there).
``--profile-dir`` (``patchNet`` and ``iwdsr``) traces global steps 10 to
19 of the streamed loop into that directory as a Chrome trace
(``trace.json``; train.py writes an xplane).  ``--device-data``,
``--remat`` and ``--profile-dir`` with ``fusionNet``, ``--remat`` with
``iwdsr`` and ``--profile-dir`` with ``--device-data`` (whose loop has no
trace window, as in the JAX trainer) raise ValueError; train.py drops
them silently.  ``--device`` defaults to ``cuda`` and fails without
a card; ``--device cpu`` runs the kernels' plain versions.  ``--band
BOTH`` runs NIR, then RED.

``--mesh-data N`` (N >= 1; 0, the default, runs one process, as train.py)
trains ``patchNet`` or ``iwdsr`` data-parallel on N ranks started by
``probav_tpu_torch.parallel.launch``: NCCL with rank r on ``cuda:r`` (N
at most the card count), or gloo with one thread a rank under ``--device
cpu``.  Each rank runs the step (and its kernels) on its share of every
batch of the cfg's batch size, which must divide by N; the gradients are
averaged over the ranks, rank 0 writes the checkpoints and logs, and
``main`` returns rank 0's results (``train/trainer.py``).  With
``--device-data`` each rank holds the whole dataset on its card.
``--mesh-model M`` (M >= 1, with ``--mesh-data N``) lays N x M ranks out
as a (data, model) mesh: the M ranks of a model group take the same
share of each batch, and ``patchNet``'s blocks split their expand /
decay pair over them (tensor parallelism, ``parallel/mesh.py``), each
rank running the ``flat`` tier's ``wide_bwd`` on its C_mid / M channels;
C_mid must divide by M.  The tier then defaults to ``flat``; ``off``
(``--plain``) takes the axis too, and an explicit ``--fused-stack t``
raises the JAX trainer's ValueError.  ``iwdsr`` has no expand / decay
pair and runs replicated on the model axis.  ``--mesh-model`` without
``--mesh-data`` (train.py drops it there) and ``fusionNet`` with
``--mesh-data`` (train.py drops the mesh there) raise ValueError.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

logger = logging.getLogger("probav_tpu_torch.train")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", default="cfg/p16t9c85r12.cfg")
    p.add_argument("--band", default="NIR",
                   help="NIR | RED | BOTH (sequential per-band runs)")
    p.add_argument("--modelType", default="patchNet",
                   choices=("patchNet", "fusionNet", "iwdsr"))
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute dtype (default float32)")
    p.add_argument("--staged-decay", action="store_true",
                   help="lr, lr/2 from epoch 10, lr/10 from epoch 20")
    p.add_argument("--eval-step", type=int, default=1000)
    p.add_argument("--save-best-only", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--fused-stack", choices=("off", "flat", "t"),
                   default=None,
                   help="patchNet's block-stack tier: t (the default; "
                        "kernels, forward and backward), flat (wide_bwd "
                        "backward), off (plain)")
    p.add_argument("--plain", action="store_true",
                   help="alias of --fused-stack off")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block's forward in the backward "
                        "(with --plain; activation-memory saver)")
    p.add_argument("--device-data", action="store_true",
                   help="keep the dataset in device memory and gather the "
                        "batches there (ModelTrainer.fit_device)")
    p.add_argument("--profile-dir", default=None,
                   help="write a trace of steps 10-19 into this directory")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel ranks, one a device (0: one process)")
    p.add_argument("--mesh-model", type=int, default=None,
                   help="tensor-parallel ranks of each model group (with "
                        "--mesh-data; default 1)")
    opt = p.parse_args(argv)
    if opt.mesh_data < 0:
        raise ValueError(f"--mesh-data {opt.mesh_data}: want 0 (one "
                         "process) or a rank count")
    if opt.mesh_model is not None:
        if opt.mesh_model < 1:
            raise ValueError(f"--mesh-model {opt.mesh_model}: want >= 1")
        if not opt.mesh_data:
            raise ValueError("--mesh-model needs --mesh-data N (N >= 1): "
                             "the mesh is N x M ranks")
    opt.mesh_model = opt.mesh_model or 1
    if opt.mesh_data and opt.modelType == "fusionNet":
        raise ValueError("--mesh-data: --modelType fusionNet trains in one "
                         "process")
    if opt.device_data and opt.profile_dir:
        raise ValueError("--device-data has no trace window: "
                         "--profile-dir traces the streamed loop")
    if opt.modelType != "patchNet":
        fusion = opt.modelType == "fusionNet"
        given = [f for f, on in (("--fused-stack", opt.fused_stack),
                                 ("--plain", opt.plain),
                                 ("--remat", opt.remat),
                                 ("--bf16", opt.bf16 and fusion),
                                 ("--device-data", opt.device_data and
                                  fusion),
                                 ("--profile-dir", opt.profile_dir and
                                  fusion)) if on]
        if given:
            raise ValueError(f"{' and '.join(given)}: --modelType "
                             f"{opt.modelType} has no such option")
    elif opt.plain:
        opt.fused_stack = "off"
    elif opt.fused_stack is None:
        opt.fused_stack = "flat" if opt.mesh_model > 1 else "t"
    elif opt.fused_stack == "t" and opt.mesh_model > 1:
        from probav_tpu_torch.parallel.mesh import MODEL_AXIS_T_REFUSAL
        raise ValueError(MODEL_AXIS_T_REFUSAL)
    if opt.remat and opt.modelType == "patchNet" and opt.fused_stack != "off":
        raise ValueError(f"--remat: the {opt.fused_stack!r} stack saves only "
                         "narrow residuals and would ignore it; it acts in "
                         "the off tier (--plain)")
    return opt


def load_stage5(cfg, band: str):
    """(x_train, [hr, mask], [x_val, hr_val, mask_val]) as float32 arrays;
    the masks are 1 on clear HR pixels (train.py:91-102)."""
    d = cfg.stage_dir("augmentedPatchesDir")
    load = lambda name: np.load(os.path.join(d, f"{name}_{band}.npy"),
                                allow_pickle=True)
    x_tr, x_val = load("TRAINpatchesLR"), load("TRAINVALpatchesLR")
    y_tr, y_val = load("TRAINpatchesHR"), load("TRAINVALpatchesHR")
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    mask = lambda a: np.asarray(~np.ma.getmaskarray(a), dtype=np.float32)
    return (f32(x_tr), [f32(y_tr), mask(y_tr)],
            [f32(x_val), f32(y_val), mask(y_val)])


def patch_net(cfg, band: str, opt, mesh=None) -> dict:
    """WDSRConv3D (patchNet) or IWDSRConv3D (iwdsr) on the stage-5
    patches; on ``mesh`` (this rank's) where given."""
    import torch

    from probav_tpu_torch.models.wdsr import build_model
    from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
    from probav_tpu_torch.train.optim import build_optimizer
    from probav_tpu_torch.train.trainer import ModelTrainer

    logger.info("[ INFO ] Loading data...")
    x_train, y_train, val = load_stage5(cfg, band)
    logger.info("[ INFO ] Building model...")
    model = build_model(cfg, band,
                        dtype=torch.bfloat16 if opt.bf16 else torch.float32,
                        fused_stack=opt.fused_stack, remat=opt.remat,
                        model_type="iwdsr" if opt.modelType == "iwdsr"
                        else "wdsr",
                        generator=torch.Generator().manual_seed(0))
    steps_per_epoch = max(1, len(x_train) // cfg.batch_size)
    tx = build_optimizer(cfg.optimizer, cfg.learning_rate,
                         steps_per_epoch=steps_per_epoch,
                         use_staged_decay=opt.staged_decay)
    target = cfg.hr_patch_size
    losses = ShiftCompensatedLosses(target_shape=(target, target, 1),
                                    mesh=mesh)
    trainer = ModelTrainer(
        model, losses.by_name(cfg.loss), losses.cpsnr, tx,
        ckpt_dir=cfg.ckpt_dir(band), log_dir=cfg.log_dir(band),
        eval_step=opt.eval_step, loss_weighted_fn=losses.weighted(cfg.loss),
        device=opt.device, mesh=mesh)
    trainer.init_state()
    if opt.device_data:
        result = trainer.fit_device(x_train, y_train, cfg.batch_size,
                                    cfg.epochs, val_data=val,
                                    save_best_only=opt.save_best_only)
    else:
        result = trainer.fit(x_train, y_train, cfg.batch_size, cfg.epochs,
                             val_data=val, save_best_only=opt.save_best_only,
                             profile_dir=opt.profile_dir)
    trainer.logger_.close()
    logger.info("[ SUCCESS ] %s", result)
    logger.info("[ SUCCESS ] Checkpoints in %s", cfg.ckpt_dir(band))
    return result


def fusion_net(cfg, band: str, opt) -> dict:
    """FuseNetConv2D on the served TRAIN scenes against their stage-2
    truths (train.py's ``fusion_net``)."""
    import torch

    from probav_tpu_torch.data.augment import split_patches
    from probav_tpu_torch.evaluation.compare import (load_hr_scenes,
                                                     load_scene_dir)
    from probav_tpu_torch.models.wdsr import build_model
    from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
    from probav_tpu_torch.train.optim import build_optimizer
    from probav_tpu_torch.train.trainer import ModelTrainer

    sr_dir = cfg.out_dir("TRAIN")
    logger.info("[ INFO ] Loading SR data from %s...", sr_dir)
    inputs = load_scene_dir(sr_dir)
    hr = load_hr_scenes(cfg.preprocessing_out)[:len(inputs)]
    x_tr, x_val, y_tr, y_val = split_patches(
        np.ma.masked_array(inputs, mask=np.zeros_like(inputs, bool)), hr,
        cfg.split)
    model = build_model(cfg, band, model_type="fusenet",
                        generator=torch.Generator().manual_seed(0))
    size = hr.shape[1]
    losses = ShiftCompensatedLosses(target_shape=(size, size, 1))
    trainer = ModelTrainer(
        model, losses.l1, losses.cpsnr,
        build_optimizer(cfg.optimizer, cfg.learning_rate),
        ckpt_dir="fuseNetCkpt", log_dir="fuseNetLogs",
        loss_weighted_fn=losses.weighted("l1"), device=opt.device)
    trainer.init_state()
    f32 = lambda a: np.asarray(a, np.float32)
    mask = lambda a: np.asarray(~np.ma.getmaskarray(a), np.float32)
    result = trainer.fit(f32(x_tr), [f32(y_tr), mask(y_tr)], cfg.batch_size,
                         cfg.epochs,
                         val_data=[f32(x_val), f32(y_val), mask(y_val)])
    trainer.logger_.close()
    logger.info("[ SUCCESS ] %s", result)
    return result


def rank_main(mesh, opt, bands, log_level) -> dict:
    """One rank of ``--mesh-data`` (and ``--mesh-model``): {band:
    patch_net's result} (``cli_rank`` sets up its logging and
    precision)."""
    from probav_tpu_torch.config import Config
    from probav_tpu_torch.parallel.launch import cli_rank

    cli_rank(mesh, opt, log_level)
    cfg = Config.from_file(opt.cfg)
    return {band: patch_net(cfg, band, opt, mesh) for band in bands}


def main(argv=None) -> dict:
    """Run the CLI; returns {band: fit result} (rank 0's with
    --mesh-data)."""
    opt = parse_args(argv)
    import torch

    from probav_tpu_torch.config import Config
    from probav_tpu_torch.parallel.launch import launch, set_tf32
    from probav_tpu_torch.parallel.mesh import check_divisible

    set_tf32(opt)
    if torch.device(opt.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    cfg = Config.from_file(opt.cfg)
    bands = ["NIR", "RED"] if opt.band.upper() == "BOTH" else [opt.band]
    if opt.mesh_data:
        check_divisible("the cfg's batch size", cfg.batch_size,
                        opt.mesh_data)
        return launch(rank_main, opt.mesh_data * opt.mesh_model, opt, bands,
                      logging.getLogger().getEffectiveLevel(),
                      device=opt.device, num_model=opt.mesh_model)
    run = fusion_net if opt.modelType == "fusionNet" else patch_net
    return {band: run(cfg, band, opt) for band in bands}
