"""The five-stage resumable preprocessing pipeline (port of
``probav_tpu/data/pipeline.py``).

Rebuild of the reference's offline data pipeline (utils/dataGenerator.py:33-273)
with the same stage structure, resume mechanism (the cfg ``ckpt`` list), and
artifact/directory contract — training (train.py:39-42) and inference
(test.py:37) load these exact file names:

  stage 1  raw PNGs                  -> arrayDir/{TRAIN,TEST}{img,msk}{LR,HR}_<band>.npy
  stage 2  register + scene QC + top-k -> trimmedArrayDir/ (+ resolverDir/TRAINimgHR)
  stage 3  reflect-pad + patching    -> patchesDir/
  stage 4  patch QC + replacement    -> trimmedPatchesDir/ + resolverDir/
  stage 5  split + augment           -> augmentedPatchesDir/

Differences from the reference, by design:
- the hot loops (registration FFTs, patch extraction, QC scans) are batched
  numpy/torch instead of per-frame Python+torch; registration runs on the
  card by default (``registration_backend='torch'``, ``device='cuda'``),
  where the JAX package's default is the host (its 'numpy' backend);
- randomness (frame resampling, permutation augment) uses an explicit seeded
  Generator so runs are reproducible;
- missing optional cfg keys degrade gracefully (``num_low_res_imgs_pre``
  defaults to ``num_low_res_imgs``; absent ``low_res_patch_thresholds`` skips
  the LR patch-threshold passes) instead of KeyErroring like the reference
  would on e.g. cfg/p16t12c85r12.cfg.

Each stage's artifacts equal the JAX pipeline's (same file names, data,
masks, shapes and dtypes): the frames and permutations come from the same
numpy Generators on the host, ``np.random.default_rng([seed, stage])``.
``run`` returns the host seconds of each stage and of registration, and
the scene counts, from which the CLI logs its rates.
"""

from __future__ import annotations

import gc
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np

from probav_tpu_torch.config import BAND_OFFSETS, Config
from probav_tpu_torch.data import augment as aug
from probav_tpu_torch.data import ingest, qc
from probav_tpu_torch.ops.patches import extract_patches_np
from probav_tpu_torch.ops.registration import register_images
from probav_tpu_torch.utils.io import dump_masked, load_npy

logger = logging.getLogger("probav_tpu_torch.data")


def _patch_scenes(img_msk: np.ma.masked_array, patch: int,
                  stride: int) -> np.ma.masked_array:
    """[S, T, C, H, W] -> [S, nP, T, C, p, p] float32, unfold patch order."""
    data = np.asarray(img_msk, dtype=np.float32)
    mask = np.ma.getmaskarray(img_msk)
    p_img = extract_patches_np(data, patch, stride)      # [S,T,C,nP,p,p]
    p_msk = extract_patches_np(mask, patch, stride)
    p_img = p_img.transpose(0, 3, 1, 2, 4, 5)            # [S,nP,T,C,p,p]
    p_msk = p_msk.transpose(0, 3, 1, 2, 4, 5)
    return np.ma.masked_array(p_img, mask=p_msk)


def _reflect_pad_hw(img_msk: np.ma.masked_array, pad: int) -> np.ma.masked_array:
    cfgp = [(0, 0)] * (img_msk.ndim - 2) + [(pad, pad), (pad, pad)]
    data = np.pad(np.asarray(img_msk), cfgp, "reflect")
    mask = np.pad(np.ma.getmaskarray(img_msk), cfgp, "reflect")
    return np.ma.masked_array(data, mask=mask)


def run(cfg: Config, band: str, ckpts: Optional[Sequence[int]] = None,
        registration_tech: str = "freq", registration_backend: str = "torch",
        device="cuda", seed: int = 0, progress: bool = True,
        outlier_threshold: Optional[float] = None,
        outlier_min_frames: int = 9) -> dict:
    """Run the requested pipeline stages for one band.

    ``registration_backend`` 'torch' registers on ``device``; 'numpy' on
    the host.  ``outlier_threshold`` enables the legacy v1 outlier-pixel
    filter (utils/utils.py:492-531): LR frames with any pixel above it are
    dropped before registration; train scenes left with <9 frames are
    removed (and recorded in removedTrainSets for submission numbering);
    test scenes are never removed — they must produce submissions.

    Returns {"seconds": {stage: s}, "scenes": {stage: n}, "register_s":
    s}: the host seconds of each stage run, the scenes it took (stage 1:
    every band and split ingested; stage 2: the band's train and test
    scenes registered), and the seconds spent registering.
    """
    ckpts = list(ckpts if ckpts is not None else cfg.ckpt)
    stats = {"seconds": {}, "scenes": {}, "register_s": 0.0}
    clock = time.perf_counter

    def register(img, msk):
        t0 = clock()
        out = register_images(img, msk, tech=registration_tech,
                              progress=progress,
                              backend=registration_backend, device=device)
        stats["register_s"] += clock() - t0
        return out
    # Independent per-stage streams so resuming a single stage (the ckpt
    # mechanism's whole point) draws the same randomness as a full run.
    stage_rng = {s: np.random.default_rng([seed, s]) for s in (1, 2, 3, 4, 5)}

    array_dir = cfg.stage_dir("arrayDir")
    trimmed_dir = cfg.stage_dir("trimmedArrayDir")
    patches_dir = cfg.stage_dir("patchesDir")
    trimmed_patches_dir = cfg.stage_dir("trimmedPatchesDir")
    resolver_dir = cfg.stage_dir("resolverDir")
    augmented_dir = cfg.stage_dir("augmentedPatchesDir")
    for d in (array_dir, trimmed_dir, patches_dir, trimmed_patches_dir,
              resolver_dir, augmented_dir):
        os.makedirs(d, exist_ok=True)

    k_pre = cfg.get("num_low_res_imgs_pre", cfg.num_low_res_imgs)

    # ---------------- stage 1: raw ingest ------------------------------ #
    if 1 in ckpts:
        t0 = clock()
        logger.info("Loading and dumping raw data...")
        ingested = 0
        for b in ("NIR", "RED"):
            for is_train in (True, False):
                try:
                    ingested += ingest.load_and_save_raw_data(
                        cfg.raw_data, array_dir, b,
                        is_grayscale=cfg.is_grayscale, is_train_data=is_train,
                        progress=progress)
                except FileNotFoundError:
                    if b == band:
                        raise
                    logger.warning("band %s raw data missing; skipping", b)
        stats["seconds"][1] = clock() - t0
        stats["scenes"][1] = ingested

    # ---------------- stage 2: registration + scene QC + top-k --------- #
    if 2 in ckpts:
        t0 = clock()
        logger.info("Loading %s dataset...", band)
        (img_lr, msk_lr, img_hr, msk_hr), (img_lr_t, msk_lr_t) = \
            ingest.load_data(array_dir, band)

        kept = np.arange(len(img_lr))
        outlier_removed = np.array([], dtype=np.int64)
        if outlier_threshold is not None:
            img_lr, msk_lr, kept, outlier_removed, ndrop = \
                qc.remove_outlier_frames(img_lr, msk_lr, outlier_threshold,
                                         min_frames=outlier_min_frames)
            logger.info("[ INFO ] Outlier filter (> %s): dropped %d train "
                        "LR frames, removed %d scenes", outlier_threshold,
                        ndrop, len(outlier_removed))
            img_lr_t, msk_lr_t, _, intact_t, ndrop_t = \
                qc.remove_outlier_frames(img_lr_t, msk_lr_t,
                                         outlier_threshold,
                                         min_frames=outlier_min_frames,
                                         drop_scenes=False)
            logger.info("[ INFO ] Outlier filter: dropped %d test LR "
                        "frames (%d scenes kept intact below 9 frames)",
                        ndrop_t, len(intact_t))

        logger.info("Registering %s train frames...", band)
        all_lr = register(img_lr, msk_lr)
        all_hr = qc.convert_to_masked_array(img_hr, msk_hr)
        # The HR dump keeps EVERY scene (id -> row alignment contract for
        # evaluation); outlier-removed scenes are trimmed only afterwards.
        dump_masked(all_hr, os.path.join(resolver_dir,
                                         f"TRAINimgHR_{band}.npy"))
        all_hr = all_hr[kept]

        trm_lr, trm_hr, removed = qc.remove_corrupted_train_sets(
            all_lr, all_hr, cfg.low_res_threshold)
        # Map clarity-removal indices back through the outlier filter's
        # kept subset, then merge both removal sources into one id list.
        removed = np.sort(np.concatenate(
            [outlier_removed, kept[np.asarray(removed, dtype=np.int64)]]))
        start = BAND_OFFSETS[("TRAIN", band)]
        np.savetxt(cfg.removed_sets_path(band),
                   np.asarray(removed, dtype=np.float64) + start)
        if len(removed):
            print(f"[ WARNING ] Imgsets {removed} were removed")
        trm_lr = qc.pick_clear_frames_per_set(
            trm_lr, k_pre, cfg.low_res_threshold, stage_rng[2])

        logger.info("Registering %s test frames...", band)
        all_lr_test = register(img_lr_t, msk_lr_t)
        trm_lr_test = qc.remove_corrupted_test_sets(all_lr_test,
                                                    cfg.low_res_threshold)
        trm_lr_test = qc.pick_clear_frames_per_set(
            trm_lr_test, k_pre, cfg.low_res_threshold, stage_rng[2])

        logger.info("Saving %s trimmed dataset...", band)
        dump_masked(trm_lr, os.path.join(trimmed_dir, f"TRAINimgLR_{band}.npy"))
        dump_masked(trm_hr, os.path.join(trimmed_dir, f"TRAINimgHR_{band}.npy"))
        dump_masked(trm_lr_test,
                    os.path.join(trimmed_dir, f"TESTimgLR_{band}.npy"))
        stats["scenes"][2] = len(all_lr) + len(all_lr_test)
        del all_lr, all_hr, trm_lr, trm_hr, all_lr_test, trm_lr_test
        gc.collect()
        stats["seconds"][2] = clock() - t0

    # ---------------- stage 3: patch generation ------------------------ #
    if 3 in ckpts:
        t0 = clock()
        pad = cfg.max_shift // 2
        lr_patch = cfg.patch_size + cfg.max_shift

        train_lr_width = None
        for split_key, stride in (("TEST", cfg.patch_size),
                                  ("TRAIN", cfg.patch_stride)):
            logger.info("Generating %s %s LR patches...", split_key, band)
            lr = load_npy(os.path.join(trimmed_dir,
                                       f"{split_key}imgLR_{band}.npy"))
            if split_key == "TRAIN":
                train_lr_width = lr.shape[-1]   # pre-pad width, for scale
            if cfg.max_shift > 0:
                lr = _reflect_pad_hw(lr, pad)
            patches = _patch_scenes(lr, lr_patch, stride)
            dump_masked(patches, os.path.join(
                patches_dir, f"{split_key}patchesLR_{band}.npy"))
            del lr, patches
            gc.collect()

        logger.info("Generating TRAIN %s HR patches...", band)
        hr = load_npy(os.path.join(trimmed_dir, f"TRAINimgHR_{band}.npy"))
        scale_up = hr.shape[-1] // train_lr_width
        hr_patch = cfg.patch_size * scale_up
        patches_hr = _patch_scenes(hr, hr_patch, hr_patch)
        dump_masked(patches_hr, os.path.join(
            patches_dir, f"TRAINpatchesHR_{band}.npy"))
        del hr, patches_hr
        gc.collect()
        stats["seconds"][3] = clock() - t0

    # ---------------- stage 4: patch QC + replacement ------------------ #
    if 4 in ckpts:
        t0 = clock()
        thresholds = cfg.get("low_res_patch_thresholds", []) or []
        lr_test = load_npy(os.path.join(patches_dir,
                                        f"TESTpatchesLR_{band}.npy"))
        lr_train = load_npy(os.path.join(patches_dir,
                                         f"TRAINpatchesLR_{band}.npy"))
        for i, thr in enumerate(thresholds):
            print(f"[ ***** TEST LR THRESHOLD {thr} PASS {i + 1} ***** ]")
            lr_test = qc.pick_clear_patches_lr(lr_test, cfg.num_low_res_imgs,
                                               thr)
            print(f"[ ***** TRAIN LR THRESHOLD {thr} PASS {i + 1} ***** ]")
            lr_train = qc.pick_clear_patches_lr(lr_train,
                                                cfg.num_low_res_imgs, thr)

        dump_masked(lr_test, os.path.join(resolver_dir,
                                          f"TESTpatchesLR_{band}.npy"))
        dump_masked(lr_train, os.path.join(resolver_dir,
                                           f"TRAINpatchesLR_{band}.npy"))

        hr_train = load_npy(os.path.join(patches_dir,
                                         f"TRAINpatchesHR_{band}.npy"))
        logger.info("Removing corrupted %s patch sets...", band)
        lr_train, hr_train = qc.remove_corrupted_train_patch_sets(
            lr_train, hr_train, cfg.high_res_threshold)
        lr_flat, hr_flat = qc.pick_clear_patches(lr_train, hr_train,
                                                 cfg.high_res_threshold)

        # Model layout: LR [N, h, w, T, C]; HR [N, H, W, 1]
        # (dataGenerator.py:209-214).
        lr_flat = lr_flat.transpose(0, 3, 4, 1, 2)
        hr_flat = hr_flat.transpose(0, 3, 4, 1, 2).squeeze(4)

        dump_masked(lr_test, os.path.join(trimmed_patches_dir,
                                          f"TESTpatchesLR_{band}.npy"))
        dump_masked(lr_flat, os.path.join(trimmed_patches_dir,
                                          f"TRAINpatchesLR_{band}.npy"))
        dump_masked(hr_flat, os.path.join(trimmed_patches_dir,
                                          f"TRAINpatchesHR_{band}.npy"))
        del lr_test, lr_train, hr_train, lr_flat, hr_flat
        gc.collect()
        stats["seconds"][4] = clock() - t0

    # ---------------- stage 5: split + augment ------------------------- #
    if 5 in ckpts:
        t0 = clock()
        lr = load_npy(os.path.join(trimmed_patches_dir,
                                   f"TRAINpatchesLR_{band}.npy"))
        hr = load_npy(os.path.join(trimmed_patches_dir,
                                   f"TRAINpatchesHR_{band}.npy"))
        logger.info("Splitting %s train patches...", band)
        lr_tr, lr_val, hr_tr, hr_val = aug.split_patches(lr, hr, cfg.split)

        dump_masked(lr_val, os.path.join(augmented_dir,
                                         f"TRAINVALpatchesLR_{band}.npy"))
        dump_masked(hr_val, os.path.join(augmented_dir,
                                         f"TRAINVALpatchesHR_{band}.npy"))
        del lr_val, hr_val

        n_perm = cfg.get("num_low_res_permute", 0)
        lr_tr = aug.augment_by_shuffling(lr_tr, n_perm, stage_rng[5])
        hr_tr = aug.tile_hr_for_permutations(hr_tr, n_perm)
        if cfg.get("to_flip", False):
            lr_tr = aug.augment_by_flipping(lr_tr)
            hr_tr = aug.augment_by_flipping(hr_tr)
        if cfg.get("to_rotate", False):
            lr_tr = aug.augment_by_rotating(lr_tr)
            hr_tr = aug.augment_by_rotating(hr_tr)

        logger.info("Saving %s augmented patches (LR %s, HR %s)...",
                    band, lr_tr.shape, hr_tr.shape)
        dump_masked(lr_tr, os.path.join(augmented_dir,
                                        f"TRAINpatchesLR_{band}.npy"))
        dump_masked(hr_tr, os.path.join(augmented_dir,
                                        f"TRAINpatchesHR_{band}.npy"))
        del lr_tr, hr_tr
        gc.collect()
        stats["seconds"][5] = clock() - t0
    return stats
