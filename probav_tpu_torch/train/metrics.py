"""Metrics accumulation and experiment logging (port of
``probav_tpu/train/metrics.py``).

- ``Mean``: a weighted streaming mean that keeps device tensors as they
  are until ``result()``, so logging adds no per-step host sync;
- ``ScalarLogger``: ``metrics.jsonl`` always, with the reference's tags
  ('Train PSNR', 'Train loss', 'Test PSNR', 'Test loss'), and TensorBoard
  event files when ``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch


class Mean:
    """Weighted streaming mean over scalars (floats or 0-d tensors)."""

    def __init__(self, name: str = "mean"):
        self.name = name
        self._values = []     # (value, weight) pairs not yet reduced
        self._carry = None    # (weighted sum, weight total, n) folded

    def update(self, value, weight: float = 1.0) -> None:
        self._values.append((value, float(weight)))

    def result(self) -> float:
        total, count, n = self._carry if self._carry else (0.0, 0.0, 0)
        if self._values:
            batch, self._values = self._values, []
            tensors = [(v, w) for v, w in batch if torch.is_tensor(v)]
            if tensors:
                dev = tensors[0][0].device
                vals = torch.stack([v.detach().float().to(dev)
                                    for v, _ in tensors])
                ws = torch.tensor([w for _, w in tensors],
                                  dtype=torch.float32, device=dev)
                total += float((vals * ws).sum())     # one host sync
            total += sum(float(v) * w for v, w in batch
                         if not torch.is_tensor(v))
            count += sum(w for _, w in batch)
            n += len(batch)
            self._carry = (total, count, n)
        if count == 0:
            return float("nan")
        return total / count

    def reset(self) -> None:
        self._values.clear()
        self._carry = None

    def __len__(self) -> int:
        return len(self._values) + (self._carry[2] if self._carry else 0)


class ScalarLogger:
    """JSONL scalar logger, plus TensorBoard where it is installed.  With
    ``log_dir`` None it writes nothing (the ranks of a mesh but rank 0)."""

    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self._jsonl = self._tb = None
        if log_dir is None:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir)
        except Exception:      # the module or its tensorboard dependency
            self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is None:
            return
        value = float(value)
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": value, "step": int(step),
             "time": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag.replace(" ", "_"), value, step)

    def flush(self) -> None:
        if self._jsonl is not None:
            self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
