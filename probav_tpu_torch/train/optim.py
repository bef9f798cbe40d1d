"""Optimizers from the cfg, written to optax's update rules (port of
``probav_tpu/train/optim.py``).

``nadam`` is ``optax.nadam``, i.e. ``optax.adam(..., nesterov=True)`` with
b1 0.9, b2 0.999, eps 1e-8, eps_root 0; ``adam`` the same without
Nesterov; ``sgd`` plain ``-lr * g``.  ``torch.optim.NAdam`` is a different
algorithm (momentum decay, another bias correction), so it is not used.

The state is a dict ``{"count": int32 scalar, "mu": {name: f32}, "nu":
{name: f32}}`` (adam/nadam) or ``{"count": ...}`` (sgd), keyed like the
parameters.  ``count`` counts updates; a schedule is evaluated at the count
before the update, as optax's ``scale_by_schedule`` does.  Unlike optax,
``step`` updates the parameters and the state in place.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Union

import torch

Schedule = Callable[[int], float]

# optax.adam / optax.nadam defaults (eps_root is 0, so it is left out).
B1, B2, EPS = 0.9, 0.999, 1e-8


def staged_decay(base_lr: float, steps_per_epoch: int) -> Schedule:
    """lr for epochs [0, 10), lr/2 for [10, 20), lr/10 afterwards
    (``optax.piecewise_constant_schedule`` with scales 0.5 and 0.2)."""
    b1, b2 = 10 * steps_per_epoch, 20 * steps_per_epoch

    def schedule(count: int) -> float:
        v = base_lr
        if count >= b1:
            v = v * 0.5
        if count >= b2:
            v = v * 0.2
        return v

    return schedule


class Optimizer:
    """adam | nadam | sgd at a constant or scheduled learning rate."""

    def __init__(self, name: str, learning_rate: Union[float, Schedule]):
        if name not in ("adam", "nadam", "sgd"):
            raise ValueError(f"unknown optimizer {name!r} "
                             "(want adam|nadam|sgd)")
        self.name = name
        self.learning_rate = learning_rate

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        count = torch.zeros((), dtype=torch.int32)
        if self.name == "sgd":
            return {"count": count}
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)
                         for k, p in params.items()}
        return {"count": count, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor], state: dict) -> None:
        """One update of ``params`` (in place) from ``grads``."""
        count = int(state["count"])
        step_size = -self.lr(count)
        if self.name == "sgd":
            for k, p in params.items():
                p.add_(grads[k].float() * step_size)
        else:
            b1, b2 = B1, B2
            # 1 - decay**count in float32, as optax's bias correction;
            # the values are exact float32s, so a Python float carries them.
            bias = lambda decay, n: (1 - torch.tensor(
                decay, dtype=torch.float32) ** n).item()
            bc1, bc1_next, bc2 = bias(b1, count + 1), bias(b1, count + 2), \
                bias(b2, count + 1)
            for k, p in params.items():
                g = grads[k].float()
                mu = state["mu"][k].mul_(b1).add_((1 - b1) * g)
                nu = state["nu"][k].mul_(b2).add_((1 - b2) * g.square())
                if self.name == "nadam":
                    mu_hat = b1 * (mu / bc1_next) + (1 - b1) * (g / bc1)
                else:
                    mu_hat = mu / bc1
                u = mu_hat / (torch.sqrt(nu / bc2) + EPS)
                p.add_(u * step_size)
        state["count"] = torch.tensor(count + 1, dtype=torch.int32)


def build_optimizer(name: str, learning_rate: float,
                    steps_per_epoch: Optional[int] = None,
                    use_staged_decay: bool = False) -> Optimizer:
    lr = (staged_decay(learning_rate, steps_per_epoch)
          if use_staged_decay and steps_per_epoch else learning_rate)
    return Optimizer(name, lr)


def state_to(state: dict, device) -> dict:
    """The optimizer state with its moment tensors on ``device``."""
    out = {"count": state["count"]}
    for key in ("mu", "nu"):
        if key in state:
            out[key] = {k: v.to(device) for k, v in state[key].items()}
    return out

