"""Random patch sampling with clarity rejection (legacy v1 capability;
port of ``probav_tpu/data/random_patches.py``).

The reference's pre-rewrite pipeline (utils/utils.py:158-268, 277-385) drew
random patch positions per scene and rejected draws whose LR or HR clarity
fell below threshold, up to MAX_TRIAL attempts — an alternative to the
deterministic grid tiling of the v2 pipeline (dataGenerator stage 3).  The
v1 code is dead/unrunnable in the reference (undefined globals, an indexing
bug at utils.py:261); this is a clean, seeded rebuild of the capability.

Shapes follow the v2 contract so downstream QC/augment/training work
unchanged: LR [N, k, C, h, w] masked, HR [N, 1, C, H, W] masked.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def sample_scene_patches(lr: np.ma.masked_array, hr: np.ma.masked_array,
                         patch_size: int, max_shift: int, scale: int,
                         num_patches: int, clarity_threshold: float,
                         rng: np.random.Generator,
                         max_trials: int = 100000
                         ) -> Tuple[np.ma.masked_array, np.ma.masked_array]:
    """Sample ``num_patches`` random aligned LR/HR patch pairs of one scene.

    lr: [T, C, H, W] masked (registered frames); hr: [1, C, sH, sW] masked.
    LR patches are (patch_size + max_shift)^2 with the reflect-pad border the
    grid pipeline uses; HR patches are (patch_size * scale)^2.  A draw is
    accepted when the HR patch and at least one LR frame meet the clarity
    threshold.
    """
    t, c, h, w = lr.shape
    pad = max_shift // 2
    lr_patch = patch_size + max_shift
    hr_patch = patch_size * scale

    lr_data = np.pad(np.asarray(lr, dtype=np.float32),
                     [(0, 0), (0, 0), (pad, pad), (pad, pad)], "reflect")
    lr_mask = np.pad(np.ma.getmaskarray(lr),
                     [(0, 0), (0, 0), (pad, pad), (pad, pad)], "reflect")
    hr_data = np.asarray(hr, dtype=np.float32)
    hr_mask = np.ma.getmaskarray(hr)

    out_lr, out_lr_m, out_hr, out_hr_m = [], [], [], []
    trials = 0
    while len(out_lr) < num_patches and trials < max_trials:
        trials += 1
        y = int(rng.integers(0, h - patch_size + 1))
        x = int(rng.integers(0, w - patch_size + 1))
        hy, hx = y * scale, x * scale

        hr_m = hr_mask[:, :, hy:hy + hr_patch, hx:hx + hr_patch]
        hr_occl = np.count_nonzero(hr_m) / (hr_patch * hr_patch)
        if hr_occl >= (1.0 - clarity_threshold):
            continue
        lr_m = lr_mask[:, :, y:y + lr_patch, x:x + lr_patch]
        frame_occl = np.count_nonzero(
            lr_m, axis=(1, 2, 3)) / (lr_patch * lr_patch)
        if not (frame_occl < (1.0 - clarity_threshold)).any():
            continue

        out_lr.append(lr_data[:, :, y:y + lr_patch, x:x + lr_patch])
        out_lr_m.append(lr_m)
        out_hr.append(hr_data[:, :, hy:hy + hr_patch, hx:hx + hr_patch])
        out_hr_m.append(hr_m)

    if not out_lr:
        raise RuntimeError(
            f"no acceptable patches after {max_trials} trials "
            f"(threshold {clarity_threshold})")
    mk = lambda d, m: np.ma.masked_array(np.stack(d), mask=np.stack(m))
    return mk(out_lr, out_lr_m), mk(out_hr, out_hr_m)


def sample_patch_dataset(lr_scenes, hr_scenes, patch_size: int,
                         max_shift: int, scale: int, patches_per_scene: int,
                         clarity_threshold: float,
                         seed: int = 0,
                         max_trials: int = 100000):
    """Random-sampled dataset over all scenes.

    lr_scenes: [S, T, C, H, W] masked; hr_scenes: [S, 1, C, sH, sW] masked.
    Returns (LR [N, T, C, h, w], HR [N, 1, C, H, W]) masked arrays with
    N <= S * patches_per_scene (scenes that reject everything contribute
    fewer).
    """
    rng = np.random.default_rng(seed)
    lrs, hrs = [], []
    for s in range(len(lr_scenes)):
        try:
            plr, phr = sample_scene_patches(
                lr_scenes[s], hr_scenes[s], patch_size, max_shift, scale,
                patches_per_scene, clarity_threshold, rng, max_trials)
        except RuntimeError:
            continue
        lrs.append(plr)
        hrs.append(phr)
    if not lrs:
        raise RuntimeError("every scene rejected all random patch draws")
    return np.ma.concatenate(lrs), np.ma.concatenate(hrs)
