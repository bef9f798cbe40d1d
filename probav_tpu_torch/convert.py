"""Carry parameters between the JAX package and the port.

A flax parameter tree of ``WDSRConv3D``, ``IWDSRConv3D`` or
``FuseNetConv2D`` (nested dicts of arrays, as ``model.init(...)["params"]``
or an orbax restore gives it) or the flat ``"a/b/c"``-keyed dict that an
``.npz`` written by ``tools/jax_params_to_npz.py`` holds becomes the port's
``state_dict``, and back.  The port's modules carry the flax names and the
flax layouts (``WNConv``'s ``kernel_v [kh, kw, (kt,) I, O]``, ``wn_g``,
``bias``; ``Conv``'s ``kernel [kh, kw, I, O]``, ``bias``;
``InstanceNorm``'s ``gamma``, ``beta``), so the mapping is a renaming:
``"resBlock_0/expand/kernel_v"`` is ``"resBlock_0.expand.kernel_v"``, and
IWDSR's ``"expConv_0_in/gamma"`` (each conv's norm a sibling named
``<conv>_in``) is ``"expConv_0_in.gamma"``.

An optax adam/nadam state (its ``count``, ``mu`` and ``nu`` trees) maps to
the port's optimizer state and back the same way, so a JAX checkpoint can
go on training in the port.
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


def _adam_part(opt_state):
    """The (count, mu, nu) element of an optax adam/nadam state: the
    ``ScaleByAdamState`` itself, a chain tuple holding it, or the same as
    plain dicts/lists (an orbax restore without a target)."""
    if isinstance(opt_state, Mapping):
        if {"count", "mu", "nu"} <= set(opt_state):
            return opt_state
        opt_state = list(opt_state.values())
    if {"count", "mu", "nu"} <= set(getattr(opt_state, "_fields", ())):
        return {k: getattr(opt_state, k) for k in ("count", "mu", "nu")}
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            try:
                return _adam_part(part)
            except ValueError:
                pass
    raise ValueError("no optax adam state (count, mu, nu) found")


def opt_state_from_optax(opt_state) -> dict:
    """An optax adam/nadam state -> the port's optimizer state
    (``probav_tpu_torch.train.optim``): count, and mu/nu keyed like the
    port's parameters."""
    adam = _adam_part(opt_state)
    return {"count": torch.tensor(int(np.asarray(adam["count"])),
                                  dtype=torch.int32),
            "mu": to_state_dict(adam["mu"]), "nu": to_state_dict(adam["nu"])}


def opt_state_to_optax(state: Mapping, like=None):
    """The port's optimizer state -> optax's.

    Without ``like``: ``{"count": int32, "mu": tree, "nu": tree}`` of numpy
    arrays (the flax tree layout).  With ``like`` (an optax state of the
    same optimizer, e.g. ``optax.nadam(lr).init(params)``): that structure
    with its adam part replaced, and any schedule count set to ``count``."""
    count = np.asarray(int(state["count"]), np.int32)
    tree = {"count": count, "mu": to_tree(state["mu"]),
            "nu": to_tree(state["nu"])}
    if like is None:
        return tree

    def fill(node):
        fields = getattr(node, "_fields", None)    # a NamedTuple state
        if fields is None:
            return (tuple(fill(n) for n in node)
                    if isinstance(node, tuple) else node)
        if {"count", "mu", "nu"} <= set(fields):
            return node._replace(**tree)
        if "count" in fields:                       # ScaleByScheduleState
            return node._replace(count=count)
        return node

    return fill(like)
