"""Stage 1: raw dataset ingest (port of ``probav_tpu/data/ingest.py``).

Rebuild of loadAndSaveRawData/loadData (utils/dataGenerator.py:844-941):
walk ``<raw>/{train|test}/<band>/imgset*``, read the LR frames (``LR*.png``),
their quality masks (``QM*.png``), and for training scenes the HR image
(``HR.png``) + status mask (``SM.png``), stack each scene to
``[numFrames, C, H, W]``, and dump one object array per artifact into
``arrayDir`` under the reference's exact file names.

Scenes have ragged frame counts (9-19 LR frames), so the per-band stacks are
numpy object arrays of per-scene ``[T_i, C, H, W]`` arrays, identical to
what the reference pickles.  PNGs are read with the port's own decoder
(``utils/png.read_png``), which gives imageio's values and dtypes.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import List, Tuple

import numpy as np

from probav_tpu_torch.utils.io import dump_masked, load_npy
from probav_tpu_torch.utils.png import read_png

logger = logging.getLogger("probav_tpu_torch.data")


def _read(path: str, grayscale: bool) -> np.ndarray:
    img = read_png(path)
    return img[None] if grayscale else img.transpose(2, 0, 1)


def _scene_stack(dir_name: str, pattern: str, grayscale: bool) -> np.ndarray:
    files = sorted(glob.glob(os.path.join(dir_name, pattern)))
    return np.array([_read(f, grayscale) for f in files])


def _object_array(scenes: List[np.ndarray]) -> np.ndarray:
    """Stack scenes; ragged frame counts produce an object array."""
    try:
        return np.array(scenes)
    except ValueError:
        out = np.empty(len(scenes), dtype=object)
        for i, s in enumerate(scenes):
            out[i] = s
        return out


def load_and_save_raw_data(raw_data_dir: str, array_dir: str, band: str,
                           is_grayscale: bool = True,
                           is_train_data: bool = True,
                           progress: bool = False) -> int:
    """Ingest one band of one split and dump the big arrays; returns the
    number of scenes."""
    os.makedirs(array_dir, exist_ok=True)
    key = "TRAIN" if is_train_data else "TEST"
    split_dir = os.path.join(raw_data_dir, key.lower(), band)
    dir_list = sorted(glob.glob(os.path.join(split_dir, "imgset*")))
    if not dir_list:
        raise FileNotFoundError(f"no imgset* under {split_dir}")

    img_lr, msk_lr, img_hr, msk_hr = [], [], [], []
    for n, d in enumerate(dir_list, 1):
        img_lr.append(_scene_stack(d, "LR*.png", is_grayscale))
        msk_lr.append(_scene_stack(d, "QM*.png", is_grayscale))
        if is_train_data:
            img_hr.append(_read(os.path.join(d, "HR.png"), is_grayscale))
            msk_hr.append(_read(os.path.join(d, "SM.png"), is_grayscale))
        if progress and (n % 100 == 0 or n == len(dir_list)):
            logger.info("[ INFO ] Ingested %d/%d %s %s scenes", n,
                        len(dir_list), key, band)

    dump_masked(_object_array(img_lr),
                os.path.join(array_dir, f"{key}imgLR_{band}.npy"))
    dump_masked(_object_array(msk_lr),
                os.path.join(array_dir, f"{key}mskLR_{band}.npy"))
    if is_train_data:
        # HR arrays get an explicit frame axis of 1: [numImgSet, 1, C, H, W].
        dump_masked(np.expand_dims(np.array(img_hr), 1),
                    os.path.join(array_dir, f"{key}imgHR_{band}.npy"))
        dump_masked(np.expand_dims(np.array(msk_hr), 1),
                    os.path.join(array_dir, f"{key}mskHR_{band}.npy"))
    return len(dir_list)


def load_data(array_dir: str, band: str) -> Tuple[tuple, tuple]:
    """Reload stage-1 artifacts (dataGenerator.py:844-871)."""
    if not os.path.exists(array_dir):
        raise FileNotFoundError(array_dir)
    g = lambda n: load_npy(os.path.join(array_dir, f"{n}_{band}.npy"))
    train = (g("TRAINimgLR"), g("TRAINmskLR"), g("TRAINimgHR"),
             g("TRAINmskHR"))
    test = (g("TESTimgLR"), g("TESTmskLR"))
    return train, test
