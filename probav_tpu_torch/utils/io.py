"""Array persistence between pipeline stages (the port's copy of
``probav_tpu/utils/io.py``'s ``dump_masked`` and ``load_npy``).

Stage artifacts are pickled numpy (masked) arrays with the reference's
file-name contract (``*.npy`` written by ``ndarray.dump``), so they load
only with ``allow_pickle``.  They hold numpy objects only, never tensors,
so the port's artifacts and the JAX package's load in either package.
Load only files that this pipeline wrote: unpickling can run arbitrary
code.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np


def dump_masked(arr: Any, path: str) -> None:
    """Persist a numpy (masked) array with pickle, like
    ``ndarray.dump(protocol=4)``."""
    if not isinstance(arr, np.ndarray):
        raise TypeError(f"{path}: stage artifacts are numpy arrays, got "
                        f"{type(arr).__name__}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr.dump(path, protocol=4)


def load_npy(path: str) -> Any:
    """A stage artifact: an ndarray, or a masked array where the stage
    pickled one (the HR ground truth of stage 2)."""
    return np.load(path, allow_pickle=True)
