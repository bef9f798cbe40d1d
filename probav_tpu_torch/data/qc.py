"""Quality control: scene filtering, top-k frame pick, patch cleaning
(port of ``probav_tpu/data/qc.py``).

Rebuild of the reference's mask-driven QC (utils/dataGenerator.py:326-515,
681-841), with the per-frame Python loops replaced by vectorized numpy over
whole scenes/patch-sets.  Semantics preserved exactly:

- "clear enough" means occluded-fraction < (1 - clarity_threshold), where the
  occluded count is over the frame's full [C, H, W] mask but the denominator
  is H*W only (reference quirk, dataGenerator.py:760-762);
- scenes are dropped only if NO LR frame is clear enough;
- the top-k frame pick first removes frames below the threshold and, if fewer
  than k remain, resamples random permutations of the clear frames until k
  ("duplicates as regularization", dataGenerator.py:811-821);
- patch-level frame replacement keeps frames >= threshold, falls back to all
  frames when none survive, tiles ceil(k/len) copies, re-sorts by clearness,
  keeps exactly k (dataGenerator.py:362-409);
- HR patches below the threshold are dropped, and whole scenes are dropped
  when every HR patch fails (dataGenerator.py:412-515).

Randomness is injected via an explicit ``numpy.random.Generator`` (the
reference used the global numpy RNG, i.e. irreproducible runs).  The
stage-4 frame selection runs in the port's native build (``_native``),
with no fallback: ``_select_frame_indices_py`` is its plain twin, which
the tests hold it to.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


def occluded_fraction(mask: np.ndarray) -> np.ndarray:
    """Occluded-pixel fraction per frame: mask [..., C, H, W] -> [...]."""
    c, h, w = mask.shape[-3:]
    return np.count_nonzero(mask, axis=(-3, -2, -1)) / (h * w)


def is_frame_clear(mask: np.ndarray, clarity_threshold: float) -> np.ndarray:
    return occluded_fraction(mask) < (1.0 - clarity_threshold)


# --------------------------------------------------------------------- #
# scene-level QC (stage 2)                                               #
# --------------------------------------------------------------------- #

def scene_keep_mask(img_msk_lr, clarity_threshold: float) -> np.ndarray:
    """True per scene iff at least one LR frame is clear enough."""
    return np.array([
        bool(is_frame_clear(np.ma.getmaskarray(scene), clarity_threshold).any())
        for scene in img_msk_lr
    ], dtype=bool)   # dtype pinned: an empty list would default to float


def remove_corrupted_train_sets(img_msk_lr, img_msk_hr,
                                clarity_threshold: float):
    keep = scene_keep_mask(img_msk_lr, clarity_threshold)
    removed = np.arange(len(img_msk_lr))[~keep]
    return img_msk_lr[keep], img_msk_hr[keep], removed


def remove_outlier_frames(img_lr, msk_lr, threshold: float,
                          min_frames: int = 9, drop_scenes: bool = True):
    """Legacy v1 outlier-pixel filter (reference utils/utils.py:492-531).

    Drops LR frames containing any pixel above ``threshold`` (PROBA-V data
    is 14-bit in 16-bit arrays; sensible thresholds are 32000-60000), then
    drops scenes left with fewer than ``min_frames`` LR frames.  The
    reference counts the HR image toward its train threshold of 10 — the
    same effective LR minimum of 9 used here for both splits.

    ``drop_scenes=False`` keeps an under-threshold scene's ORIGINAL frames
    instead of removing it — used for the test split, where every scene
    must still produce a submission image.

    img_lr/msk_lr: stage-1 raw scene stacks — object arrays (ragged frame
    counts) or regular [S, T, C, H, W] arrays.
    Returns (img_lr', msk_lr', kept_idx, removed_idx, frames_dropped);
    with ``drop_scenes=False`` kept_idx covers every scene and removed_idx
    lists the ones left intact.
    """
    from probav_tpu_torch.data.ingest import _object_array

    out_img, out_msk, kept, removed = [], [], [], []
    dropped = 0
    for s in range(len(img_lr)):
        frames = np.asarray(img_lr[s])
        masks = np.asarray(msk_lr[s])
        keep = ~(frames > threshold).any(axis=tuple(range(1, frames.ndim)))
        if int(keep.sum()) < min_frames:
            removed.append(s)
            if not drop_scenes:
                kept.append(s)
                out_img.append(frames)
                out_msk.append(masks)
            continue
        dropped += int((~keep).sum())
        kept.append(s)
        out_img.append(frames[keep])
        out_msk.append(masks[keep])
    return (_object_array(out_img), _object_array(out_msk),
            np.asarray(kept, dtype=np.int64),
            np.asarray(removed, dtype=np.int64), dropped)


def remove_corrupted_test_sets(img_msk_lr, clarity_threshold: float):
    keep = scene_keep_mask(img_msk_lr, clarity_threshold)
    return img_msk_lr[keep]


# --------------------------------------------------------------------- #
# top-k clearest frame pick (stage 2)                                    #
# --------------------------------------------------------------------- #

def pick_clear_frames(scene: np.ma.masked_array, k: int,
                      clarity_threshold: float,
                      rng: np.random.Generator) -> Tuple[np.ma.masked_array, int]:
    """One scene [T, C, H, W] -> exactly k clearest frames (+dup count)."""
    clear = is_frame_clear(np.ma.getmaskarray(scene), clarity_threshold)
    filtered = scene[clear]
    if len(filtered) == 0:
        # The pipeline guarantees at least one clear frame per surviving
        # scene (remove_corrupted_train_sets runs first), but this is
        # public API: an all-occluded scene must fail loudly, not spin
        # forever resampling an empty pool.
        raise ValueError(
            f"no frame passes clarity threshold {clarity_threshold}; "
            "run remove_corrupted_train_sets first or lower the threshold")
    order = np.argsort(np.ma.getmaskarray(filtered).sum(axis=(1, 2, 3)),
                       kind="stable")
    ranked = filtered[order]
    dup = 0
    if k < len(ranked):
        return ranked[:k], 0
    dup = k - len(ranked)
    picked = [ranked]
    total = len(ranked)
    while total < k:
        perm = rng.permutation(len(filtered))
        picked.append(filtered[perm])
        total += len(filtered)
    return np.ma.concatenate(picked)[:k], dup


def pick_clear_frames_per_set(img_msk_lr, k: int, clarity_threshold: float,
                              rng: Optional[np.random.Generator] = None,
                              verbose: bool = True) -> np.ma.masked_array:
    """All scenes -> [numImgSet, k, C, H, W] (dataGenerator.py:766-795)."""
    rng = rng or np.random.default_rng(0)
    out, dups = [], 0
    num_frames_total = 0
    for scene in img_msk_lr:
        picked, d = pick_clear_frames(scene, k, clarity_threshold, rng)
        out.append(picked[None])
        dups += d
        num_frames_total += len(scene)
    if verbose and num_frames_total:
        print(f"[ INFO ] Among the all the LR images, "
              f"{dups / num_frames_total * 100:.2f}% are duplicates of "
              f"high quality frames.")
    return np.ma.concatenate(out)


# --------------------------------------------------------------------- #
# patch-level QC (stage 4)                                               #
# --------------------------------------------------------------------- #

def select_frame_indices(occ_counts: np.ndarray, k: int,
                         clarity_threshold: float, hw: int
                         ) -> Tuple[np.ndarray, int, int]:
    """Frame-replacement selection as pure index logic.

    occ_counts: [S, P, T] int64 occluded-pixel counts per frame.
    Returns (idx [S, P, k] int32, num_dirty, num_unreplaced) reproducing
    removeAndReplaceDirtyFrames exactly (dataGenerator.py:362-409): keep
    frames with occluded fraction < 1-threshold (original order), fall back
    to all frames when none survive, tile ceil(k/len) copies, stable-sort
    the tiled list by occlusion, take the first k.  Runs the native build;
    a failed build raises.
    """
    from probav_tpu_torch.data import _native
    return _native.select_frames(occ_counts, k, clarity_threshold, hw)


def _select_frame_indices_py(occ_counts, k, clarity_threshold, hw):
    """The plain Python twin of the native selector."""
    s, p, t = occ_counts.shape
    limit = (1.0 - clarity_threshold) * hw
    idx = np.empty((s, p, k), dtype=np.int32)
    dirty = 0
    unreplaced = 0
    for si in range(s):
        for pi in range(p):
            occ = occ_counts[si, pi]
            good = [ti for ti in range(t) if occ[ti] < limit]
            if not good:
                good = list(range(t))
                dirty += t
                unreplaced += t
            else:
                dirty += t - len(good)
            copies = math.ceil(k / len(good))
            tiled = good * copies
            order = sorted(range(len(tiled)), key=lambda i: occ[tiled[i]])
            idx[si, pi] = [tiled[i] for i in order[:k]]
    return idx, dirty, unreplaced


def pick_clear_patches_lr(patches_lr: np.ma.masked_array, k: int,
                          clarity_threshold: float,
                          verbose: bool = True) -> np.ma.masked_array:
    """[numImgSet, numPatch, T, C, h, w] -> same with exactly k frames.

    One vectorized occlusion pass over the data, then index-only selection
    (native C++) and a single gather, which replace the reference's
    per-frame Python/numpy loop.
    """
    num_sets, num_patches, t = patches_lr.shape[:3]
    h, w = patches_lr.shape[-2:]
    mask = np.ma.getmaskarray(patches_lr)
    occ = np.count_nonzero(mask, axis=(-3, -2, -1)).astype(np.int64)
    idx, dirty_all, unreplaced_all = select_frame_indices(
        occ, k, clarity_threshold, h * w)

    gather = idx[..., None, None, None]
    data = np.take_along_axis(np.asarray(patches_lr), gather, axis=2)
    msk = np.take_along_axis(mask, gather, axis=2)
    out = np.ma.masked_array(data, mask=msk)
    if verbose:
        frac = dirty_all / (num_sets * num_patches * t) * 100
        level = "WARNING" if frac > 50 else "INFO"
        print(f"[ {level} ] {frac:.2f}% of the patches did not pass the "
              f"{clarity_threshold} threshold.")
        if dirty_all:
            print(f"[ {level} ] Among those patches, "
                  f"{unreplaced_all / dirty_all * 100:.2f}% were not replaced!")
    return out


def patch_keep_mask(patches_hr: np.ma.masked_array,
                    clarity_threshold: float) -> np.ndarray:
    """Per-patch keep flag from HR clarity: [N, 1, C, H, W] -> [N] bool."""
    c, h, w = patches_hr.shape[-3:]
    occl = np.count_nonzero(np.ma.getmaskarray(patches_hr),
                            axis=(-4, -3, -2, -1)) / (h * w)
    return occl < (1.0 - clarity_threshold)


def remove_corrupted_train_patch_sets(patches_lr, patches_hr,
                                      clarity_threshold: float):
    """Drop whole scenes whose every HR patch fails (dataGenerator.py:494-515)."""
    keep = np.array([
        bool(patch_keep_mask(scene_hr, clarity_threshold).any())
        for scene_hr in patches_hr
    ])
    return patches_lr[keep], patches_hr[keep]


def pick_clear_patches(patches_lr, patches_hr, clarity_threshold: float):
    """Flatten scenes and drop individual HR-dirty patches
    (dataGenerator.py:412-435).  Returns ([N*, T, C, h, w], [N*, 1, C, H, W]).
    """
    s0 = patches_lr.shape
    s1 = patches_hr.shape
    flat_lr = patches_lr.reshape((-1,) + s0[2:])
    flat_hr = patches_hr.reshape((-1,) + s1[2:])
    keep = patch_keep_mask(flat_hr, clarity_threshold)
    return flat_lr[keep], flat_hr[keep]


def convert_to_masked_array(img_sets: np.ndarray,
                            msk_sets: np.ndarray) -> np.ma.masked_array:
    """Pair HR images with SM masks (dataGenerator.py:681-699).

    [numImgSet, 1, C, H, W] x2 -> masked array of the same shape with
    mask=True at occluded pixels (~SM).
    """
    data = np.asarray(img_sets, dtype=np.float64)
    occluded = ~(np.asarray(msk_sets) > 0)
    return np.ma.masked_array(data, mask=occluded)
