"""The model axis (``--mesh-model``) on NCCL, one rank a card: the
flagship's train step on (data, model) meshes against one card, and the
train CLI on those meshes with a resume of its checkpoint in one process.

    python3 -m probav_tpu_torch.tools.time_model_axis [--cfg CFG] \\
        [--meshes 1x2,2x2,1x4] [--steps 8] [--cli 1x2,2x2] --out DIR

For float32 and bf16, the cfg's model on the "flat" tier (whose backward
runs ``wide_bwd``, on a mesh at each rank's C_mid / M channels) from a
seeded init (``torch.Generator`` seed 0) trains on one synthetic batch of
the cfg's ``batch_size`` (``profile_train.synthetic_batch``, seed 2): in
one process on ``cuda:0``, then on each mesh D x M of ``--meshes``
(``parallel.launch``, NCCL, rank r on ``cuda:r``; a mesh larger than the
card count is skipped).  Each run takes the gradients at the start, then a
warm-up step and ``--steps`` steps, each timed on the host clock to its
``torch.cuda.synchronize()``.  Against one card: the first loss's relative
gap, the worst gathered gradient leaf's ||got - ref|| / ||ref||, and the
gap of the parameters after the steps, ||p_mesh - p_one|| / ||p_one -
p_init|| over all of them; with the ``wide_bwd`` launches a step (12 or
it raises), the median step ms and rank 0's peak memory.  ``--cli``
runs the train CLI (``--mesh-data D --mesh-model M``, flat by default
there) for one epoch of 6 steps on a synthetic stage-5 tree of 768 + 160
patches, then one process (``--fused-stack flat``) for a second epoch
from its checkpoint.  JSON lines go to ``<out>/time_model_axis.jsonl``.

Needs as many CUDA cards as the largest mesh; float32 runs with TF32 off.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np

TRAIN_N, VAL_N = 768, 160


def _steps(tr, batch, steps: int) -> tuple:
    """(the loss of each step, the synced seconds of each after the
    first)."""
    import torch

    losses, secs = [], []
    for _ in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = tr.train_step(*batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return losses, secs[1:]


def run(mesh, cfg_path: str, dtype: str, steps: int, workdir: str) -> dict:
    """The flat trainer on ``mesh`` (this rank's share and channels; None:
    one process on cuda:0): the whole parameters before and after, the
    whole gradients at the start, the losses, step seconds, wide_bwd
    launches and peak memory."""
    import torch

    from probav_tpu_torch.config import Config
    from probav_tpu_torch.ops import wide_block
    from probav_tpu_torch.parallel.mesh import batch_share
    from probav_tpu_torch.tools.profile_train import (make_trainer,
                                                      synthetic_batch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.from_file(cfg_path)
    dev = torch.device("cuda", 0) if mesh is None else mesh.device
    share = slice(None) if mesh is None else batch_share(mesh,
                                                         cfg.batch_size)
    batch = tuple(torch.as_tensor(a[share], device=dev)
                  for a in synthetic_batch(cfg.batch_size, seed=2))
    torch.cuda.reset_peak_memory_stats(dev)
    tr = make_trainer(cfg, dtype, "flat", dev, workdir, mesh=mesh)
    whole = lambda d: {k: v.cpu() for k, v in tr._whole(d).items()}
    init = whole({k: p.detach().clone() for k, p in tr.params.items()})
    _, _, grads = tr.loss_and_grads(*batch)
    grads = whole(grads)
    wide_block.reset_launches()
    losses, secs = _steps(tr, batch, steps)
    out = dict(init=init, grads=grads, losses=losses, secs=secs,
               wide_bwd=wide_block.LAUNCHES["wide_bwd"] / (steps + 1),
               params=whole({k: p.detach() for k, p in tr.params.items()}),
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    tr.logger_.close()
    return out


def rel(got, ref) -> float:
    ref = ref.double()
    return float((got.double() - ref).norm() / ref.norm())


def movement_gap(got: dict, want: dict, init: dict) -> float:
    """||got - want|| / ||want - init|| over all parameters."""
    parted = sum(float((got[k].double() - w.double()).norm()) ** 2
                 for k, w in want.items())
    moved = sum(float((w.double() - init[k].double()).norm()) ** 2
                for k, w in want.items())
    return (parted / max(moved, 1e-60)) ** 0.5


def stage5_tree(cfg_path: str, root: str, epochs: int) -> str:
    """A copy of the cfg whose directories point into root, with
    ``epochs``, over a synthetic stage-5 tree (TRAIN_N training and VAL_N
    validation patches; HR as pickled masked arrays, as the pipeline
    writes them); returns its path."""
    from probav_tpu_torch.tools.profile_train import synthetic_set

    dirs = {"raw_data": "raw", "preprocessing_out": "data",
            "model_out": "model", "train_out": "trainout",
            "test_out": "testout"}
    values = {k: os.path.join(root, v) for k, v in dirs.items()}
    values["epochs"] = str(epochs)
    aug = os.path.join(root, "data", "augmentedPatchesDir")
    if not os.path.isdir(aug):
        os.makedirs(aug)
        lr, hr, mask = synthetic_set(TRAIN_N + VAL_N)
        for split, sl in (("TRAIN", slice(0, TRAIN_N)),
                          ("TRAINVAL", slice(TRAIN_N, None))):
            np.save(os.path.join(aug, f"{split}patchesLR_NIR.npy"), lr[sl])
            np.ma.masked_array(hr[sl], mask=mask[sl] == 0).dump(
                os.path.join(aug, f"{split}patchesHR_NIR.npy"))
    lines = []
    with open(cfg_path) as f:
        for line in f:
            key = line.split("=", 1)[0].strip()
            lines.append(f"{key}={values[key]}\n" if key in values else line)
    out = os.path.join(root, os.path.basename(cfg_path))
    with open(out, "w") as f:
        f.writelines(lines)
    return out


def emit(path: str, rec: dict) -> None:
    print(json.dumps(rec), flush=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def parse_meshes(text: str) -> list:
    return [tuple(int(v) for v in m.split("x")) for m in text.split(",")
            if m]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", default="cfg/p16t9c85r12.cfg")
    p.add_argument("--meshes", default="1x2,2x2,1x4",
                   help="comma list of DxM meshes")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--cli", default="1x2,2x2",
                   help="comma list of DxM meshes for the train CLI")
    p.add_argument("--out", required=True,
                   help="directory of time_model_axis.jsonl")
    opt = p.parse_args(argv)
    import torch

    from probav_tpu_torch.config import Config
    from probav_tpu_torch.parallel.launch import launch
    from probav_tpu_torch.train import cli
    from probav_tpu_torch.train.trainer import list_checkpoints

    if not torch.cuda.is_available():
        raise RuntimeError("time_model_axis needs CUDA cards")
    cards = torch.cuda.device_count()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"cards: {cards} x {card.splitlines()[0]}; torch "
          f"{torch.__version__}, NCCL {torch.cuda.nccl.version()}",
          flush=True)
    os.makedirs(opt.out, exist_ok=True)
    path = os.path.join(opt.out, "time_model_axis.jsonl")
    card = card.splitlines()[0]
    meshes = [m for m in parse_meshes(opt.meshes) if m[0] * m[1] <= cards]
    cfg = Config.from_file(opt.cfg)
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float32", "bfloat16"):
            one = run(None, opt.cfg, dtype, opt.steps,
                      os.path.join(tmp, f"one_{dtype}"))
            torch.cuda.empty_cache()
            emit(path, dict(mesh="one card", dtype=dtype,
                            losses=one["losses"],
                            step_ms=[1e3 * s for s in one["secs"]],
                            median_ms=1e3 * statistics.median(one["secs"]),
                            peak_gb=one["peak_gb"], card=card))
            for d, m in meshes:
                got = launch(run, d * m, opt.cfg, dtype, opt.steps,
                             os.path.join(tmp, f"{d}x{m}_{dtype}"),
                             device="cuda", num_model=m, deadline=1200)
                if got["wide_bwd"] != cfg.num_res_blocks:
                    raise AssertionError(f"{d}x{m} {dtype}: "
                                         f"{got['wide_bwd']} wide_bwd a step")
                if any(not torch.equal(got["init"][k], v)
                       for k, v in one["init"].items()):
                    raise AssertionError(f"{d}x{m} {dtype}: the initial "
                                         "parameters differ from one card's")
                gaps = {k: rel(got["grads"][k], v)
                        for k, v in one["grads"].items()}
                worst = max(gaps, key=gaps.get)
                emit(path, dict(
                    mesh=f"{d}x{m}", dtype=dtype, losses=got["losses"],
                    loss0_gap=abs(got["losses"][0] - one["losses"][0]) /
                    abs(one["losses"][0]),
                    worst_grad_gap=[worst, gaps[worst]],
                    param_gap=movement_gap(got["params"], one["params"],
                                           one["init"]),
                    wide_bwd_a_step=got["wide_bwd"],
                    step_ms=[1e3 * s for s in got["secs"]],
                    median_ms=1e3 * statistics.median(got["secs"]),
                    one_card_median_ms=1e3 * statistics.median(one["secs"]),
                    peak_gb_rank0=got["peak_gb"], card=card))
        for d, m in [m for m in parse_meshes(opt.cli)
                     if m[0] * m[1] <= cards]:
            root = os.path.join(tmp, f"cli_{d}x{m}")
            argv = ["--band", "NIR", "--eval-step",
                    str(TRAIN_N // cfg.batch_size)]
            tree = stage5_tree(opt.cfg, root, 1)
            t0 = time.perf_counter()
            res = cli.main(["--cfg", tree] + argv +
                           ["--mesh-data", str(d), "--mesh-model", str(m)])
            wall = time.perf_counter() - t0
            step, _ = list_checkpoints(
                Config.from_file(tree).ckpt_dir("NIR"))[-1]
            again = cli.main(["--cfg", stage5_tree(opt.cfg, root, 2)] +
                             argv + ["--fused-stack", "flat"])
            emit(path, dict(cli=f"{d}x{m}", steps=res["NIR"]["steps"],
                            wall_s=wall, checkpoint_step=step,
                            resumed_to=again["NIR"]["steps"],
                            train_loss=[res["NIR"]["train_loss"],
                                        again["NIR"]["train_loss"]],
                            val_psnr=again["NIR"]["val_psnr"], card=card))


if __name__ == "__main__":
    main()
