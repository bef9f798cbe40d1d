"""Data and tensor parallelism over ``torch.distributed`` ranks (port of
``probav_tpu/parallel``): the mesh and its collectives (``mesh.py``) and
the rank launcher (``launch.py``)."""

from probav_tpu_torch.parallel.launch import launch
from probav_tpu_torch.parallel.mesh import (
    Mesh,
    all_mean,
    all_sum,
    barrier,
    batch_share,
    broadcast_,
    check_divisible,
    gather_rows,
    gather_state,
    make_mesh,
    shard_dim,
    shard_state,
)

__all__ = [
    "Mesh", "all_mean", "all_sum", "barrier", "batch_share", "broadcast_",
    "check_divisible", "gather_rows", "gather_state", "launch", "make_mesh",
    "shard_dim", "shard_state",
]
