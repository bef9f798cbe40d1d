"""Config layer: parser for the reference ``.cfg`` dialect plus a typed view.

The port's own copy of ``probav_tpu/config.py`` (stdlib only), so that the
port imports nothing of the JAX package; ``tests/test_torch_config.py``
holds the two copies to equal results.

The cfg format is INI-like: four sections ``[Directories] [Train] [Net]
[Preprocessing]``, per-section typed coercion of values, a whitelist of
supported keys, and a single flat dict as the result (the reference's
utils/parseConfig.py).  ``Config`` wraps the flat dict with attribute
access, derived directory paths and per-band dataset statistics.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List

# Keys the reference accepts (parseConfig.py:62-67).  Anything else is an error.
SUPPORTED_KEYS = frozenset({
    "type", "raw_data", "preprocessing_out", "model_out", "batch_size",
    "epochs", "learning_rate", "optimizer", "split", "num_res_blocks",
    "num_low_res_imgs", "num_low_res_imgs_pre", "scale", "num_filters",
    "kernel_size", "exp_rate", "decay_rate", "is_grayscale", "max_shift",
    "patch_size", "patch_stride", "low_res_patch_thresholds",
    "low_res_threshold", "high_res_threshold", "num_low_res_permute",
    "to_flip", "to_rotate", "ckpt", "test_out", "train_out", "loss",
})

# Hard-coded per-band dataset statistics used for in-graph normalization
# (reference train.py:47-52, test.py:40-45).
BAND_STATS = {
    "NIR": (8075.2045, 3160.7272),
    "RED": (5266.2245, 3431.8614),
}

# Scene-numbering offsets for submission writing (reference test.py:79-90)
# and removed-set bookkeeping (dataGenerator.py:78).
BAND_OFFSETS = {
    ("TRAIN", "RED"): 0,
    ("TRAIN", "NIR"): 594,
    ("TEST", "RED"): 1160,
    ("TEST", "NIR"): 1306,
}


def _coerce(section: str, key: str, raw: str) -> Any:
    """Per-section typed coercion, matching parseConfig.py:31-59."""
    val = raw.strip()
    if section == "Preprocessing":
        if "ckpt" in key:
            return [int(x) for x in val.split(",")]
        if "low_res_patch_thresholds" in key:
            return [float(x) for x in val.split(",")]
        if "low_res_threshold" in key or "high_res_threshold" in key:
            return float(val)
        if "to_flip" in key or "to_rotate" in key:
            return bool(int(val))
        return int(val)
    if section == "Net":
        if "decay_rate" in key:
            return float(val)
        if "is_grayscale" in key:
            return bool(int(val))
        return int(val)
    if section == "Train":
        if "learning_rate" in key or "split" in key:
            return float(val)
        if "optimizer" in key or "loss" in key:
            return val
        return int(val)
    # Directories (and any other section): raw strings.
    return val


def resolve_cfg_path(path: str) -> str:
    """Reference path resolution: append ``.cfg``, fall back to ``cfg/``."""
    if not path.endswith(".cfg"):
        path += ".cfg"
    if not os.path.exists(path) and os.path.exists(os.path.join("cfg", path)):
        path = os.path.join("cfg", path)
    return path


def parse_cfg(path: str) -> Dict[str, Any]:
    """Parse a reference-format cfg file into one flat dict.

    Reproduces parseConfig.py semantics: comment lines start with ``#``,
    section headers are ``[Name]``, later sections/keys override earlier ones
    when flattened, and unsupported keys raise.
    """
    path = resolve_cfg_path(path)
    with open(path, "r") as f:
        lines = [ln.strip() for ln in f.read().split("\n")]
    lines = [ln for ln in lines if ln and not ln.startswith("#")]

    section = None
    flat: Dict[str, Any] = {}
    seen: List[str] = []
    for line in lines:
        if line.startswith("["):
            section = line[1:-1].strip()
            continue
        if section is None:
            raise ValueError(f"Key before any [Section] header in {path!r}: {line!r}")
        key, _, raw = line.partition("=")
        key = key.strip()
        seen.append(key)
        flat[key] = _coerce(section, key, raw)

    unsupported = sorted(set(seen) - SUPPORTED_KEYS)
    if unsupported:
        raise ValueError(f"Unsupported fields {unsupported} in {path}")
    return flat


# Stage directory names under ``preprocessing_out`` (dataGenerator.py:39-44).
STAGE_DIRS = (
    "arrayDir", "trimmedArrayDir", "patchesDir",
    "trimmedPatchesDir", "resolverDir", "augmentedPatchesDir",
)


@dataclass
class Config:
    """Typed attribute view over the flat cfg dict, plus derived values."""

    flat: Dict[str, Any] = field(default_factory=dict)
    cfg_path: str = ""

    @classmethod
    def from_file(cls, path: str) -> "Config":
        return cls(flat=parse_cfg(path), cfg_path=resolve_cfg_path(path))

    def __getattr__(self, name: str) -> Any:
        try:
            return self.flat[name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name: str) -> Any:
        return self.flat[name]

    def __contains__(self, name: str) -> bool:
        return name in self.flat

    def get(self, name: str, default: Any = None) -> Any:
        return self.flat.get(name, default)

    # -- derived values ----------------------------------------------------

    @property
    def basename(self) -> str:
        """Cfg file basename used to derive ckpt/log/output dir names."""
        return os.path.basename(self.cfg_path).split(".")[0]

    @property
    def lr_input_size(self) -> int:
        """Model LR input spatial size: patch + max_shift (modelsTF.py:19)."""
        return self.flat["patch_size"] + self.flat["max_shift"]

    @property
    def hr_patch_size(self) -> int:
        return self.flat["patch_size"] * self.flat["scale"]

    def stage_dir(self, name: str) -> str:
        assert name in STAGE_DIRS, name
        return os.path.join(self.flat["preprocessing_out"], name)

    def ckpt_dir(self, band: str) -> str:
        return os.path.join(self.flat["model_out"], f"ckpt_{self.basename}", band)

    def log_dir(self, band: str) -> str:
        return os.path.join(self.flat["model_out"], f"logs_{self.basename}", band)

    def removed_sets_path(self, band: str) -> str:
        """Cfg-anchored removedTrainSets<BAND>.txt location.

        The reference writes this file CWD-relative (dataGenerator.py:98),
        which made every CLI's behavior depend on the invocation directory;
        anchoring it under ``preprocessing_out`` removes the footgun while
        ``load_removed_sets``'s CWD fallback keeps reference-produced trees
        working.
        """
        return os.path.join(self.flat["preprocessing_out"],
                            f"removedTrainSets{band.upper()}.txt")

    def out_dir(self, totest: str) -> str:
        key = "test_out" if totest.upper() == "TEST" else "train_out"
        return f"{self.flat[key]}_{self.basename}"

    def band_stats(self, band: str) -> tuple:
        return BAND_STATS[band.upper()]
