"""Stage 5: train/val split and augmentation (port of
``probav_tpu/data/augment.py``).

Rebuild of splitPatches / augmentBy* (utils/dataGenerator.py:276-323):

- the split reproduces sklearn ``train_test_split(test_size=split,
  random_state=17)`` fold membership (bit-compatible with the reference)
  in plain numpy — see ``split_indices``;
- temporal-permutation augmentation concatenates ``num_permute`` random
  frame-order shuffles of the LR stack (HR side is tiled to match);
- flip (V, H, VH) and rot90 (x1, x2, x3) quadruple the set each.

LR layout here is the model layout [N, H, W, T, C]; HR is [N, H, W, 1].
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def split_indices(n_samples: int, split: float,
                  seed: int = 17) -> List[np.ndarray]:
    """(train_idx, val_idx) with sklearn fold membership, without sklearn.

    Reproduces ``sklearn.model_selection.train_test_split(test_size=split,
    random_state=seed)`` exactly (same legacy ``RandomState(seed)``
    permutation, same ceil/floor size rounding) so the reference's
    random_state=17 membership (dataGenerator.py:282-284) is preserved —
    but without paying sklearn's multi-second import in the pipeline
    process.  Parity with real sklearn is pinned by the JAX package's
    tests, and this copy is held to that one.
    """
    import math

    n_test = int(math.ceil(split * n_samples))
    # sklearn with train_size=None takes the complement of the test fold,
    # NOT floor((1-split)*n) — the two differ when (1-split)*n rounds down
    # past an exact integer (e.g. n=90, split=0.3: floor(63.0 - eps) = 62
    # but sklearn keeps 63), which would silently drop a training sample.
    n_train = n_samples - n_test
    perm = np.random.RandomState(seed).permutation(n_samples)
    return [perm[n_test:n_test + n_train], perm[:n_test]]


def split_patches(patches_lr: np.ma.masked_array,
                  patches_hr: np.ma.masked_array,
                  split: float, seed: int = 17) -> List[np.ma.masked_array]:
    """Deterministic train/val split (dataGenerator.py:276-286)."""
    tr, va = split_indices(len(patches_lr), split, seed)

    def take(arr, idx):
        return np.ma.masked_array(np.asarray(arr)[idx],
                                  mask=np.ma.getmaskarray(arr)[idx])

    return [take(patches_lr, tr), take(patches_lr, va),
            take(patches_hr, tr), take(patches_hr, va)]


def augment_by_shuffling(patch_lr: np.ma.masked_array, num_permute: int,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ma.masked_array:
    """Concat temporal permutations of [N, H, W, T, C] LR stacks."""
    if num_permute == 0:
        return patch_lr
    rng = rng or np.random.default_rng(0)
    t = patch_lr.shape[3]
    cache = [patch_lr]
    for _ in range(num_permute):
        idx = rng.permutation(t)
        cache.append(patch_lr[:, :, :, idx, :])
    return np.ma.concatenate(cache)


def augment_by_flipping(patches: np.ma.masked_array) -> np.ma.masked_array:
    flip_v = patches[:, ::-1]
    flip_h = patches[:, :, ::-1]
    flip_vh = patches[:, ::-1, ::-1]
    return np.ma.concatenate((patches, flip_v, flip_h, flip_vh))


def augment_by_rotating(patches: np.ma.masked_array) -> np.ma.masked_array:
    r90 = np.rot90(patches, k=1, axes=(1, 2))
    r180 = np.rot90(patches, k=2, axes=(1, 2))
    r270 = np.rot90(patches, k=3, axes=(1, 2))
    return np.ma.concatenate((patches, r90, r180, r270))


def tile_hr_for_permutations(patches_hr: np.ma.masked_array,
                             num_permute: int) -> np.ma.masked_array:
    """HR counterpart of temporal permutation: plain tiling along N
    (dataGenerator.py:261); data and mask are tiled in lockstep.
    """
    if num_permute == 0:
        return patches_hr
    reps = (num_permute + 1,) + (1,) * (patches_hr.ndim - 1)
    return np.ma.masked_array(np.tile(np.asarray(patches_hr), reps),
                              mask=np.tile(np.ma.getmaskarray(patches_hr), reps))
