"""Carry parameters between the JAX package and the port.

A flax parameter tree of ``WDSRConv3D`` (nested dicts of arrays, as
``model.init(...)["params"]`` or an orbax restore gives it) or the flat
``"a/b/c"``-keyed dict that an ``.npz`` written by
``tools/jax_params_to_npz.py`` holds becomes the port's ``state_dict``, and
back.  The port's modules carry the flax names and the flax layouts
(``kernel_v [kh, kw, (kt,) I, O]``, ``wn_g``, ``bias``), so the mapping is
a renaming: ``"resBlock_0/expand/kernel_v"`` is ``"resBlock_0.expand.
kernel_v"``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/c": float32 array}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v, dtype=np.float32)
    return flat


def to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested) or flat "a/b/c" dict -> port state_dict."""
    nested = any(isinstance(v, Mapping) for v in params.values())
    flat = flatten_tree(params) if nested else {
        k: np.asarray(v, dtype=np.float32) for k, v in params.items()}
    return {k.replace("/", "."): torch.from_numpy(np.array(v))
            for k, v in flat.items()}


def to_flat(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Port state_dict -> flat {"a/b/c": float32 array} (the .npz form)."""
    return {k.replace(".", "/"): t.detach().float().cpu().numpy()
            for k, t in state.items()}


def to_tree(state: Mapping[str, torch.Tensor]) -> dict:
    """Port state_dict -> nested dicts of numpy arrays (the flax tree)."""
    tree: dict = {}
    for key, arr in to_flat(state).items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        return to_state_dict({k: z[k] for k in z.files})


def save_npz(path: str, state: Mapping[str, torch.Tensor]) -> None:
    np.savez(path, **to_flat(state))
