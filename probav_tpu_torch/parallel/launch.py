"""Start N ranks of a function over ``torch.distributed`` and return rank
0's result.

    launch(fn, n, *args, device="cuda")   # fn(mesh, *args) on each rank
    launch(fn, d * m, *args, num_model=m)  # on a (d, m) mesh

Each rank is a process started with ``spawn``.  The ranks meet through a
``FileStore`` in a temporary directory (no TCP port to choose or to
collide), join a process group and call ``fn(make_mesh(n // num_model,
num_model, device=...), *args)``.  The backend is NCCL on CUDA, where
rank r computes on ``cuda:r`` and N may not exceed the card count, and
gloo on the CPU, where each rank takes one thread.  ``backend="gloo"``
with ``device="cuda"`` puts every rank on the card of its rank modulo the
card count (on one card, all of them): gloo reduces and broadcasts CUDA
tensors through the host, so it serves checks, not speed.

A rank that raises writes its exception and traceback; the parent stops
the other ranks (they may wait in a collective) and raises that exception
with the traceback as a note.  ``PG_TIMEOUT_S`` bounds each collective,
and ``deadline`` (seconds, None for none) bounds the whole run in the
parent, so a hung rank fails the run instead of stalling it.

``cli_rank`` sets up a CLI's rank: what a spawned process does not
inherit from the parent that parsed the flags.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch

POLL_S = 0.05
PG_TIMEOUT_S = 1800.0   # a collective that waits longer raises on its rank


def set_tf32(opt) -> None:
    """float32 products in float32 (no one-pass TF32) unless ``opt.bf16``:
    the CLIs' precision policy, set in the parent and again in each rank."""
    if not opt.bf16:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def cli_rank(mesh, opt, log_level) -> None:
    """Set up a CLI's rank: log lines tagged with the rank, rank 0 at the
    launching process's ``log_level`` and the others warnings only; and
    ``set_tf32(opt)``."""
    logging.basicConfig(format=f"%(asctime)s - rank {mesh.rank} - "
                        "%(message)s",
                        level=log_level if mesh.is_chief else logging.WARNING)
    set_tf32(opt)


def _rank_main(call: bytes, rank: int, n: int, num_model: int, device: str,
               backend: str, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from probav_tpu_torch.parallel.mesh import make_mesh

    out = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        fn, args = pickle.loads(call)
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
            torch.set_num_threads(1)
        store = dist.FileStore(store_path, n)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        result = fn(make_mesh(n // num_model, num_model, device=dev),
                    *args)
        dist.destroy_process_group()
        payload = ("ok", result if rank == 0 else None)
    except BaseException as exc:      # reported to the parent, then re-raised
        # Reported before the group closes with the process: the other
        # ranks' collectives fail after this, and their reports come later.
        tb = traceback.format_exc()
        try:
            payload = ("error", exc, tb)
            pickle.dumps(payload)
        except Exception:
            payload = ("error", RuntimeError(f"{type(exc).__name__}: {exc}"),
                       tb)
        with open(out + ".tmp", "wb") as f:
            pickle.dump(payload, f)
        os.replace(out + ".tmp", out)
        raise
    with open(out + ".tmp", "wb") as f:
        pickle.dump(payload, f)
    os.replace(out + ".tmp", out)


def _failure(out_dir: str, procs: list) -> BaseException:
    """The first exception a rank reported (a rank that fails leaves the
    others failing in their collectives after it), with its traceback as
    a note; else a RuntimeError naming the first rank that exited
    non-zero."""
    reported = []
    for rank in range(len(procs)):
        path = os.path.join(out_dir, f"rank{rank}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                payload = pickle.load(f)
            if payload[0] == "error":
                reported.append((os.stat(path).st_mtime_ns, rank, payload))
    if reported:
        _, rank, payload = min(reported)
        exc = payload[1]
        exc.add_note(f"raised on rank {rank}:\n{payload[2]}")
        return exc
    rank = next(r for r, p in enumerate(procs) if p.exitcode)
    return RuntimeError(f"rank {rank} exited with code "
                        f"{procs[rank].exitcode} and reported no result")


def launch(fn: Callable, n: int, *args, device: str = "cuda",
           backend: Optional[str] = None, deadline: Optional[float] = None,
           num_model: int = 1):
    """Run ``fn(mesh, *args)`` on ``n`` ranks, a mesh of ``n //
    num_model`` by ``num_model``; return rank 0's result.

    ``fn`` and ``args`` are pickled (``fn`` by its import path) with the
    plain pickler: the process starter's would move the storage of every
    tensor in ``args`` to shared memory, under the caller's feet.
    ``backend`` defaults to "nccl" on CUDA and "gloo" on the CPU.
    """
    device = torch.device(device).type
    if n < 1 or num_model < 1 or n % num_model:
        raise ValueError(f"launch: {n} ranks on a model axis of "
                         f"{num_model}")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cuda":
        count = torch.cuda.device_count()
        if backend == "nccl" and n > count:
            raise ValueError(f"mesh {n // num_model}x{num_model} needs {n} "
                             f"devices, have {count} (NCCL takes one rank "
                             "a card)")
        if count == 0:
            raise RuntimeError("launch on cuda: no CUDA device is available")
    call = pickle.dumps((fn, args))
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="probav_launch_")
    procs = []
    try:
        store = os.path.join(tmp, "store")
        for rank in range(n):
            p = ctx.Process(target=_rank_main, args=(
                call, rank, n, num_model, device, backend, store, tmp),
                name=f"probav-rank{rank}")
            p.start()
            procs.append(p)
        t_end = None if deadline is None else time.monotonic() + deadline
        while any(p.is_alive() for p in procs):
            if any(p.exitcode for p in procs):
                raise _failure(tmp, procs)
            if t_end is not None and time.monotonic() > t_end:
                raise TimeoutError(f"launch: {n} ranks of {fn.__name__} "
                                   f"still running after {deadline} s")
            time.sleep(POLL_S)
        if any(p.exitcode for p in procs):
            raise _failure(tmp, procs)
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)[1]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
