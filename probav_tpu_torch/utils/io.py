"""Array persistence between pipeline stages (the port's copy of
``probav_tpu/utils/io.py``'s loader).

Stage artifacts are pickled numpy (masked) arrays with the reference's
file-name contract (``*.npy`` written by ``ndarray.dump``), so they load
only with ``allow_pickle``.  Load only files that this pipeline wrote:
unpickling can run arbitrary code.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def load_npy(path: str) -> Any:
    """A stage artifact: an ndarray, or a masked array where the stage
    pickled one (the HR ground truth of stage 2)."""
    return np.load(path, allow_pickle=True)
