"""Training CLI of the PyTorch port (counterpart of ``train.py``).

    python3 -m probav_tpu_torch.train --cfg cfg/p16t9c85r12.cfg --band NIR \\
        [--modelType {patchNet,fusionNet,iwdsr}] [--bf16] [--staged-decay] \\
        [--eval-step N] [--save-best-only] [--device cuda] \\
        [--fused-stack {off,flat,t}] [--plain]

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
``--device`` defaults to ``cuda`` and fails without a card; ``--device
cpu`` runs the kernels' plain versions.  ``--band BOTH`` runs NIR, then
RED.
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
    opt = p.parse_args(argv)
    if opt.modelType != "patchNet":
        given = [f for f, on in (("--fused-stack", opt.fused_stack),
                                 ("--plain", opt.plain),
                                 ("--bf16", opt.bf16 and
                                  opt.modelType == "fusionNet")) if on]
        if given:
            raise ValueError(f"{' and '.join(given)}: --modelType "
                             f"{opt.modelType} has no such option (it has no "
                             "kernel tier)")
    elif opt.plain:
        opt.fused_stack = "off"
    elif opt.fused_stack is None:
        opt.fused_stack = "t"
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


def patch_net(cfg, band: str, opt) -> dict:
    """WDSRConv3D (patchNet) or IWDSRConv3D (iwdsr) on the stage-5
    patches."""
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
                        fused_stack=opt.fused_stack,
                        model_type="iwdsr" if opt.modelType == "iwdsr"
                        else "wdsr",
                        generator=torch.Generator().manual_seed(0))
    steps_per_epoch = max(1, len(x_train) // cfg.batch_size)
    tx = build_optimizer(cfg.optimizer, cfg.learning_rate,
                         steps_per_epoch=steps_per_epoch,
                         use_staged_decay=opt.staged_decay)
    target = cfg.hr_patch_size
    losses = ShiftCompensatedLosses(target_shape=(target, target, 1))
    trainer = ModelTrainer(
        model, losses.by_name(cfg.loss), losses.cpsnr, tx,
        ckpt_dir=cfg.ckpt_dir(band), log_dir=cfg.log_dir(band),
        eval_step=opt.eval_step, loss_weighted_fn=losses.weighted(cfg.loss),
        device=opt.device)
    trainer.init_state()
    result = trainer.fit(x_train, y_train, cfg.batch_size, cfg.epochs,
                         val_data=val, save_best_only=opt.save_best_only)
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


def main(argv=None) -> dict:
    """Run the CLI; returns {band: fit result}."""
    opt = parse_args(argv)
    import torch

    from probav_tpu_torch.config import Config

    if not opt.bf16:   # float32 products in float32: no one-pass TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if torch.device(opt.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    cfg = Config.from_file(opt.cfg)
    bands = ["NIR", "RED"] if opt.band.upper() == "BOTH" else [opt.band]
    run = fusion_net if opt.modelType == "fusionNet" else patch_net
    return {band: run(cfg, band, opt) for band in bands}
