"""The data axis of a device mesh over ``torch.distributed`` ranks (port of
``probav_tpu/parallel/mesh.py``).

The JAX package lays a ``(data, model)`` mesh over the chips of one
process and lets the SPMD partitioner insert the collectives.  The port
runs one process (rank) a device, each running the hand-written kernels on
its share of the batch, and writes the collectives itself:

- a global batch of B rows is split into N equal shares of B / N rows
  (``batch_share``);
- gradients are averaged over the data group as one flat buffer
  (``all_mean``), so every rank applies the same update and the parameters
  stay equal on every rank;
- a loss coupled across the batch (the reversed MS-SSIM of ``l1msssim``)
  sums its per-shift terms over the group before its min (``all_sum``);
- predictions are gathered by a sum of zeroed buffers into which each rank
  writes its rows (``gather_rows``): gloo reduces and broadcasts CUDA
  tensors but gathers none, NCCL takes CUDA tensors only.

Only the ``data`` axis is ported.  The ``model`` axis (tensor parallelism
of the wide expand/decay convs) is the next slice in ROADMAP.md, so
``make_mesh`` refuses ``num_model > 1``.  ``parallel/launch.py`` starts
the ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

TENSOR_PARALLEL_REFUSAL = (
    "tensor parallelism (a mesh 'model' axis > 1, --mesh-model > 1) is not "
    "ported: the port runs the data axis only; the model axis is the next "
    "bring-up slice in ROADMAP.md (queue 1, item 4a)")


@dataclass(frozen=True)
class Mesh:
    """This rank's place on a (data, model = 1) mesh: the data axis is the
    whole default process group, so the collectives below run on it, and
    ``device`` is the device this rank computes on.
    """
    world: int
    rank: int
    device: torch.device

    @property
    def data_index(self) -> int:
        """The rank's index on the data axis (the JAX mesh's name for
        ``rank`` while the model axis is 1)."""
        return self.rank

    @property
    def shape(self) -> dict:
        return {"data": self.world, "model": 1}

    @property
    def is_chief(self) -> bool:
        """Rank 0 writes checkpoints, logs and outputs."""
        return self.rank == 0


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              device=None) -> Mesh:
    """The mesh of this rank over the initialized default process group:
    ``num_data`` (default: the world size) ranks on the data axis.
    ``device`` defaults to the current CUDA device where the group's
    backend is NCCL, else the CPU."""
    if num_model > 1:
        raise ValueError(TENSOR_PARALLEL_REFUSAL)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(probav_tpu_torch.parallel.launch starts one)")
    world = dist.get_world_size()
    if num_data is None:
        num_data = max(1, world // num_model)
    need = num_data * num_model
    if need != world:
        raise ValueError(f"mesh {num_data}x{num_model} needs {need} devices, "
                         f"have {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(world=world, rank=dist.get_rank(), device=torch.device(device))


def check_divisible(what: str, n: int, num_data: int) -> None:
    """Raise ValueError unless ``n`` rows split into ``num_data`` equal
    shares."""
    if n % num_data:
        raise ValueError(f"{what} {n} does not divide by the mesh's data "
                         f"size {num_data}")


def batch_share(mesh: Mesh, n: int) -> slice:
    """The rows of a global batch of ``n`` that this rank owns."""
    check_divisible("batch size", n, mesh.world)
    k = n // mesh.world
    return slice(k * mesh.rank, k * (mesh.rank + 1))


def all_mean(tensors: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """The tensors (of one floating dtype) averaged over the data group, in
    one all-reduce of one flat buffer; returns views of it, shaped as the
    inputs."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(mesh.world)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


class _AllSum(torch.autograd.Function):
    """Sum over the data group; its backward scales by the group's size.

    Every rank computes the same function of the sums, so the cotangent is
    the same on every rank, and the sum's derivative with respect to this
    rank's terms is 1.  The trainer averages the ranks' gradients
    (``all_mean``), so each rank returns N times its share's gradient:
    their mean is the gradient of the global loss."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.world = mesh.world
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g * ctx.world, None


def all_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the data group (differentiable, see ``_AllSum``)."""
    return _AllSum.apply(x, mesh)


def gather_rows(local: torch.Tensor, n: int, mesh: Mesh) -> torch.Tensor:
    """The [n, ...] tensor whose ``batch_share`` rows on each rank are that
    rank's ``local``: every rank writes its rows into a zeroed buffer and
    the buffers are summed (x + 0 is x, so the rows are exact)."""
    out = torch.zeros((n,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    out[batch_share(mesh, n)] = local
    dist.all_reduce(out)
    return out


def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Overwrite the tensors (of one dtype) with rank 0's, in one broadcast
    of one flat buffer."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.broadcast(flat, 0)
    with torch.no_grad():
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view_as(t))


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the data group."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()
