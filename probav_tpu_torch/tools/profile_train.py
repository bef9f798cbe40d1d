"""Warm train-step throughput of the port, and where its device time goes.

    python3 -m probav_tpu_torch.tools.profile_train [--cfg CFG] \\
        [--steps 10] [--out chiprun_out] [--losses l1,l1msssim]

For each variant of ``VARIANTS`` (bf16 and float32 each with the "t"
kernel stack, forward and ``blk_bwd``, with the plain stack and with the
"flat" stack, whose backward runs ``wide_bwd``; and bf16 "t" with the loss
and metric tables on the shift-table kernels) it builds the cfg's model
from a seeded init (``torch.Generator`` seed 0) and a ``ModelTrainer``
with the cfg's optimizer and loss, and feeds it one synthetic batch of the
cfg's ``batch_size`` patches (numpy seed 0; see ``synthetic_batch``),
already on the device.
The first step is a warm-up: it pays the kernel build, cuDNN's algorithm
choice and lazy module loading.  ``--steps`` more steps are timed one by
one on the host clock, each ending in ``torch.cuda.synchronize()``; their
median patches/s is the warm throughput.  One more step runs under
``torch.profiler``: the device time of each kernel and memcpy and their
sum (device busy); the idle share is 1 - busy / the median step time; and
in the "t" variants blk_bwd's four sub-kernels (dd conv, wgrad, seg_bwd,
reduce; see ``time_conv.BLK_BWD_PARTS``) per step, with the kernels that
ran, and the shift-table kernels' device time per step.  A
JSON summary goes to ``<out>/profile_train.json``.  ``--variants`` runs
only the named ones (a comma list of ``VARIANTS``' names, or a
semicolon list, which can name "bf16 kernels, kernel loss").  ``--losses``
runs each variant with each of the named cfg losses in turn (default: the
cfg's own), keyed "<variant>; <loss>" when there are several.  Needs a
CUDA card; float32 runs with TF32 off.
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

# (name, dtype, stack tier, loss tables on the kernels)
VARIANTS = (("bf16 kernels", "bfloat16", "t", False),
            ("bf16 plain", "bfloat16", "off", False),
            ("f32 kernels", "float32", "t", False),
            ("f32 plain", "float32", "off", False),
            ("bf16 flat", "bfloat16", "flat", False),
            ("f32 flat", "float32", "flat", False),
            ("bf16 kernels, kernel loss", "bfloat16", "t", True))


def synthetic_batch(n: int, seed: int = 0, hr_clear: float = 0.9):
    """(lr [n,22,22,9,1], hr [n,48,48,1], mask [n,48,48,1]) float32: LR
    frames are noisy copies of a smooth scene with values in 4000-12000;
    HR is the 3x nearest upscale of the scene's centre (the 16x16 patch),
    so the model has something to learn; ``hr_clear`` of the HR pixels are
    clear (mask 1)."""
    r = np.random.default_rng(seed)
    base = r.uniform(4000, 12000, (n, 22, 22))
    k = np.ones(3) / 3
    for ax in (1, 2):
        base = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax,
                                   base)
    lr = base[..., None, None] + r.normal(0, 100, (n, 22, 22, 9, 1))
    hr = np.kron(base[:, 3:19, 3:19], np.ones((3, 3)))[..., None]
    mask = (r.uniform(size=hr.shape) < hr_clear)
    return (lr.astype(np.float32), hr.astype(np.float32),
            mask.astype(np.float32))


def make_trainer(cfg, dtype: str, tier, device, workdir: str,
                 band: str = "NIR", use_kernel: bool = False,
                 fused_block: bool = False, model_type: str = "wdsr",
                 loss: str | None = None):
    """A ModelTrainer over the cfg's model (``model_type`` "wdsr" or
    "iwdsr") from torch.Generator seed 0 with stack tier ``tier``
    (``fused_block`` in the "off" tier; "wdsr" only), with the cfg's
    optimizer and loss (or ``loss``, a cfg loss key; ``use_kernel``: its
    tables on the shift-table kernels); checkpoints and logs in
    workdir."""
    import torch

    from probav_tpu_torch.models.wdsr import build_model
    from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
    from probav_tpu_torch.train.optim import build_optimizer
    from probav_tpu_torch.train.trainer import ModelTrainer

    model = build_model(cfg, band, dtype=getattr(torch, dtype),
                        fused_stack=tier, fused_block=fused_block,
                        model_type=model_type,
                        generator=torch.Generator().manual_seed(0))
    target = cfg.hr_patch_size
    loss = loss or cfg.loss
    losses = ShiftCompensatedLosses(target_shape=(target, target, 1),
                                    use_kernel=use_kernel)
    trainer = ModelTrainer(
        model, losses.by_name(loss), losses.cpsnr,
        build_optimizer(cfg.optimizer, cfg.learning_rate),
        ckpt_dir=os.path.join(workdir, "ckpt"),
        log_dir=os.path.join(workdir, "logs"),
        loss_weighted_fn=losses.weighted(loss), device=device)
    trainer.init_state()
    return trainer


def warm_step_rates(trainer, batch, steps: int) -> list:
    """patches/s of ``steps`` train steps on ``batch`` (device tensors),
    each timed alone to its synchronize, after one warm-up step."""
    import torch

    trainer.train_step(*batch)
    torch.cuda.synchronize()
    rates = []
    for _ in range(steps):
        t0 = time.perf_counter()
        trainer.train_step(*batch)
        torch.cuda.synchronize()
        rates.append(len(batch[0]) / (time.perf_counter() - t0))
    return rates


def device_breakdown(trainer, batch):
    """(wall ms, device-busy ms, [(ms, kernel name, count)] by time) of
    one train step under torch.profiler, after a profiled warm-up step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        trainer.train_step(*batch)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        trainer.train_step(*batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    rows = sorted(((dev_us(e) / 1e3, e.key, e.count)
                   for e in prof.key_averages()
                   if dev_us(e) > 0 and "CUDA" in str(e.device_type)),
                  reverse=True)
    return wall, sum(r[0] for r in rows), rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", default="cfg/p16t9c85r12.cfg")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", default="chiprun_out")
    p.add_argument("--variants", help="comma list of VARIANTS' names "
                   "(a semicolon list where a name holds a comma)")
    p.add_argument("--losses", help="comma list of cfg loss keys to run "
                   "each variant with (default: the cfg's loss)")
    opt = p.parse_args(argv)
    names = [v[0] for v in VARIANTS]
    sep = ";" if opt.variants and ";" in opt.variants else ","
    chosen = opt.variants.split(sep) if opt.variants else names
    if not set(chosen) <= set(names):
        raise SystemExit(f"--variants: a comma list of {'; '.join(names)}")
    import torch

    from probav_tpu_torch.config import Config
    from probav_tpu_torch.tools.time_conv import blk_bwd_part

    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    os.makedirs(opt.out, exist_ok=True)
    cfg = Config.from_file(opt.cfg)
    loss_keys = opt.losses.split(",") if opt.losses else [cfg.loss]
    n = cfg.batch_size
    batch = tuple(torch.as_tensor(a, device="cuda")
                  for a in synthetic_batch(n))
    summary = {}
    runs = [(v, loss) for v in VARIANTS if v[0] in chosen
            for loss in loss_keys]
    for (variant, dtype, tier, use_kernel), loss in runs:
        name = variant if len(loss_keys) == 1 else f"{variant}; {loss}"
        with tempfile.TemporaryDirectory() as tmp:
            tr = make_trainer(cfg, dtype, tier, "cuda", tmp,
                              use_kernel=use_kernel, loss=loss)
            rates = warm_step_rates(tr, batch, opt.steps)
            wall, busy, rows = device_breakdown(tr, batch)
            tr.logger_.close()
        med = statistics.median(rates)
        idle = 1 - busy / (1e3 * n / med)
        parts = {}
        for t, k, c in rows:
            part = blk_bwd_part(k) if tier == "t" else None
            if part:
                p = parts.setdefault(part, dict(ms=0.0, calls=0, kernels=[]))
                p["ms"] += t
                p["calls"] += c
                p["kernels"].append(k[:90])
        shift = [(t, c) for t, k, c in rows if "shift_table" in k]
        summary[name] = dict(rates=rates, median=med, profiled_wall_ms=wall,
                             device_busy_ms=busy, idle=idle,
                             top=[(t, k[:90], c) for t, k, c in rows[:16]],
                             blk_bwd_parts=parts,
                             shift_table_ms=sum(t for t, _ in shift),
                             shift_table_calls=sum(c for _, c in shift))
        print(f"== {name}: train step at batch {n}, patches/s "
              f"{['%.1f' % x for x in rates]} median {med:.1f}; device "
              f"busy {busy:.2f} ms, idle {100 * idle:.1f}% of the median "
              f"step (profiled wall {wall:.2f} ms) [{card}]", flush=True)
        for t, k, c in rows[:16]:
            print(f"   {t:9.3f} ms  {100 * t / busy:5.1f}%  x{c:<5d} "
                  f"{k[:100]}", flush=True)
        if shift:
            print(f"   shift tables: {sum(t for t, _ in shift):.3f} ms a "
                  f"step, {sum(c for _, c in shift)} calls", flush=True)
        for part, p in parts.items():
            print(f"   blk_bwd {part}: {p['ms']:.3f} ms a step, "
                  f"{p['calls']} calls ({'; '.join(p['kernels'])})",
                  flush=True)
        del tr
        torch.cuda.empty_cache()
    with open(os.path.join(opt.out, "profile_train.json"), "w") as f:
        json.dump(dict(card=card, batch=n, runs=summary), f,
                  indent=1)
    return summary


if __name__ == "__main__":
    main()
