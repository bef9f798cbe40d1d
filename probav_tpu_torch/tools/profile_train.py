"""Warm train-step throughput of the port, and where its device time goes;
or (``--loops``) the train loops ``fit`` and ``fit_device``, and what
``--remat`` costs.

    python3 -m probav_tpu_torch.tools.profile_train [--cfg CFG] \\
        [--steps 10] [--out chiprun_out] [--losses l1,l1msssim]
    python3 -m probav_tpu_torch.tools.profile_train --loops 40 \\
        [--steps 10] [--out chiprun_out]

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
reduce) per step, with the kernels that ran, and the shift-table kernels'
device time per step, as ``tstack_roofline.read_trace`` files them.  A
JSON summary goes to ``<out>/profile_train.json``.  ``--variants`` runs
only the named ones (a comma list of ``VARIANTS``' names, or a
semicolon list, which can name "bf16 kernels, kernel loss").  ``--losses``
runs each variant with each of the named cfg losses in turn (default: the
cfg's own), keyed "<variant>; <loss>" when there are several.  The idle
share here is that of a *synced step*: each step starts on an empty
queue, so host latency that a pipelined loop would hide counts as idle.

``--loops N`` measures the loops instead.  For bf16 and float32, the
cfg's model on the "t" kernel stack trains one epoch of N steps on a
synthetic stage-5 set (``synthetic_set``) with each loop, in the order of
``LOOP_ORDER`` after a warm-up run of each; ``eval_step`` lies beyond the
epoch, so only the final validation (one batch) falls outside the
trainers' own clocks, and each run's patches/s is the one its trainer
returns.  Then each loop runs the global steps of the trainer's
``PROFILE_WINDOW`` under ``utils.profiling.trace`` with no sync between
steps (``loop_busy``): its *window busy share* is the union of the
device's kernel, copy and memset intervals over the span of the trace
(``window_busy``).  Then one float32 step of the "off" tier with and
without ``remat`` from the same init on the same batch: its peak
``torch.cuda.max_memory_allocated`` (forward and backward), its gradients
and its median step over ``--steps`` synced steps (``remat_cost``).  A
JSON summary goes to ``<out>/profile_loops.json``.

Needs a CUDA card; float32 runs with TF32 off.
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

from probav_tpu_torch.tools.tstack_roofline import (DEVICE_CATS, load_trace,
                                                    read_trace)

# (name, dtype, stack tier, loss tables on the kernels)
VARIANTS = (("bf16 kernels", "bfloat16", "t", False),
            ("bf16 plain", "bfloat16", "off", False),
            ("f32 kernels", "float32", "t", False),
            ("f32 plain", "float32", "off", False),
            ("bf16 flat", "bfloat16", "flat", False),
            ("f32 flat", "float32", "flat", False),
            ("bf16 kernels, kernel loss", "bfloat16", "t", True))

# --loops: the loops and the order of their rated runs.
LOOPS = ("fit", "fit_device")
LOOP_ORDER = ("fit", "fit_device", "fit_device", "fit")


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
                 loss: str | None = None, remat: bool = False,
                 mesh=None):
    """A ModelTrainer over the cfg's model (``model_type`` "wdsr" or
    "iwdsr") from torch.Generator seed 0 with stack tier ``tier``
    (``fused_block`` and ``remat`` in the "off" tier; "wdsr" only), with
    the cfg's
    optimizer and loss (or ``loss``, a cfg loss key; ``use_kernel``: its
    tables on the shift-table kernels); checkpoints and logs in
    workdir; data-parallel on ``mesh`` where given."""
    import torch

    from probav_tpu_torch.models.wdsr import build_model
    from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
    from probav_tpu_torch.train.optim import build_optimizer
    from probav_tpu_torch.train.trainer import ModelTrainer

    model = build_model(cfg, band, dtype=getattr(torch, dtype),
                        fused_stack=tier, fused_block=fused_block,
                        model_type=model_type, remat=remat,
                        generator=torch.Generator().manual_seed(0))
    target = cfg.hr_patch_size
    loss = loss or cfg.loss
    losses = ShiftCompensatedLosses(target_shape=(target, target, 1),
                                    use_kernel=use_kernel, mesh=mesh)
    trainer = ModelTrainer(
        model, losses.by_name(loss), losses.cpsnr,
        build_optimizer(cfg.optimizer, cfg.learning_rate),
        ckpt_dir=os.path.join(workdir, "ckpt"),
        log_dir=os.path.join(workdir, "logs"),
        loss_weighted_fn=losses.weighted(loss), device=device, mesh=mesh)
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
    """(wall ms, ``step_breakdown``) of one train step under
    torch.profiler, after a profiled warm-up step."""
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
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return wall, step_breakdown(load_trace(path))


def step_breakdown(events: list):
    """(device-busy ms, [(ms, kernel name, count)] by time, the hand
    kernels of ``tstack_roofline.read_trace``) of the Chrome trace events
    of one step."""
    rows = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            ms, n = rows.get(e["name"], (0.0, 0))
            rows[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    trace = read_trace(events, 1)
    return (trace["busy_ms"],
            sorted(((ms, k, n) for k, (ms, n) in rows.items()),
                   reverse=True), trace["hand"])


def synthetic_set(n: int, seed: int = 1) -> tuple:
    """(x, hr, mask) of n patches: ``synthetic_batch`` of 768 patches
    tiled (the draw is slow in numpy; the rates do not depend on it)."""
    base = synthetic_batch(min(n, 768), seed=seed)
    reps = -(-n // len(base[0]))
    return tuple(np.ascontiguousarray(np.concatenate([a] * reps)[:n])
                 for a in base)


def window_busy(events: list) -> dict:
    """The device's busy ms (the union of its intervals), the trace's
    span in ms and their ratio, from Chrome trace events."""
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("ph") == "X"]
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, float("-inf")
    for s, t in dev:
        if t > end:
            busy += t - max(s, end)
            end = t
    window = max(t for _, t in spans) - min(s for s, _ in spans)
    return {"busy_ms": busy / 1e3, "window_ms": window / 1e3,
            "busy_share": busy / window, "device_events": len(dev)}


def kernel_names(events: list) -> set:
    return {e["name"] for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"}


def loop_trainer(cfg, dtype, dev, workdir):
    """The cfg's "t" model with eval_step beyond any run here."""
    tr = make_trainer(cfg, dtype, "t", dev, workdir)
    tr.eval_every = 10 ** 9
    return tr


def loop_rate(cfg, dtype, dev, loop, data, val, workdir) -> float:
    """patches/s of one epoch of ``loop`` on ``data``, as it returns it."""
    tr = loop_trainer(cfg, dtype, dev, workdir)
    x, hr, mask = data
    res = getattr(tr, loop)(x, [hr, mask], cfg.batch_size, 1, val_data=val,
                            val_steps=1, save_best_only=False)
    tr.logger_.close()
    return res["patches_per_sec"]


def loop_busy(cfg, dtype, dev, loop, data, val, workdir) -> dict:
    """``window_busy`` of the global steps of ``PROFILE_WINDOW`` of
    ``loop``, with no sync between steps: ``fit`` traces them itself
    (``profile_dir``); ``fit_device``, which has no trace window, runs the
    steps before the window as one chunk and the window's as another under
    the same ``utils.profiling.trace``, ended by the chunk's readback."""
    import torch

    from probav_tpu_torch.train.trainer import PROFILE_WINDOW
    from probav_tpu_torch.utils.profiling import TRACE_FILE, trace

    start, stop = PROFILE_WINDOW
    b = cfg.batch_size
    tr = loop_trainer(cfg, dtype, dev, workdir)
    trace_dir = os.path.join(workdir, "trace")
    # One step past the window: fit closes it itself, with its sync.
    x, hr, mask = (a[:(stop + 1) * b] for a in data)
    if loop == "fit":
        tr.fit(x, [hr, mask], b, 1, val_data=val, val_steps=1,
               profile_dir=trace_dir)
    else:
        res = tr.resident((x, hr, mask))
        idx = torch.randperm(len(x), generator=torch.Generator()
                             .manual_seed(0))[:(stop - 1) * b]
        idx = idx.reshape(stop - 1, b).to(tr.device)
        tr._run_chunk(res, idx[:start - 1])
        with trace(trace_dir, tr.device):
            float(tr._run_chunk(res, idx[start - 1:])[0])
    tr.logger_.close()
    events = load_trace(os.path.join(trace_dir, TRACE_FILE))
    return dict(window_busy(events), steps=stop - start)


def remat_cost(cfg, dev, batch, workdir, steps: int) -> dict:
    """{remat: (gradients, peak bytes, median step ms)} of the float32
    "off" tier on ``batch`` (device tensors), from the same init; the
    step's time from ``warm_step_rates``."""
    import torch

    out = {}
    for remat in (False, True):
        tr = make_trainer(cfg, "float32", "off", dev,
                          os.path.join(workdir, f"remat_{remat}"),
                          remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        grads = tr.loss_and_grads(*batch)[2]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        grads = {k: v.detach().clone() for k, v in grads.items()}
        rate = statistics.median(warm_step_rates(tr, batch, steps))
        tr.logger_.close()
        del tr
        torch.cuda.empty_cache()
        out[remat] = (grads, peak, 1e3 * len(batch[0]) / rate)
    return out


def measure_loops(cfg, dtypes, dev, steps: int, workdir: str,
                  log=print) -> dict:
    """patches/s in LOOP_ORDER and the window busy share of both loops
    per dtype, after a warm-up run of each loop at each dtype (the kernel
    build, cuDNN's first calls and lazy module loading)."""
    from probav_tpu_torch.train.trainer import PROFILE_WINDOW

    b = cfg.batch_size
    data = synthetic_set(max(steps, PROFILE_WINDOW[1] + 1) * b)
    val = tuple(a[:b] for a in synthetic_batch(b, seed=2))
    run = tuple(a[:steps * b] for a in data)
    summary = {}
    for dtype in dtypes:
        for loop in LOOPS:
            loop_rate(cfg, dtype, dev, loop, tuple(a[:2 * b] for a in data),
                      val, os.path.join(workdir, f"warm_{dtype}_{loop}"))
        rates = {loop: [] for loop in LOOPS}
        for i, loop in enumerate(LOOP_ORDER):
            rates[loop].append(loop_rate(
                cfg, dtype, dev, loop, run, val,
                os.path.join(workdir, f"{dtype}_{loop}_{i}")))
        busy = {loop: loop_busy(cfg, dtype, dev, loop, data, val,
                                os.path.join(workdir, f"busy_{dtype}_{loop}"))
                for loop in LOOPS}
        for loop in LOOPS:
            bz = busy[loop]
            log(f"{dtype} t {loop}: patches/s "
                f"{', '.join(f'{r:.1f}' for r in rates[loop])} ({steps} "
                f"steps at batch {b}, order {'/'.join(LOOP_ORDER)}); "
                f"global steps {PROFILE_WINDOW[0]}-{PROFILE_WINDOW[1] - 1} "
                f"traced with no sync: device busy {bz['busy_ms']:.2f} of "
                f"{bz['window_ms']:.2f} ms, window busy share "
                f"{100 * bz['busy_share']:.1f}%")
        summary[dtype] = {"patches_per_sec": rates, "busy": busy,
                          "steps": steps, "batch": b}
    return summary


def loops_main(opt, cfg, card: str) -> dict:
    """``--loops``: measure_loops and remat_cost into
    ``<out>/profile_loops.json``."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        summary = measure_loops(cfg, ("bfloat16", "float32"), "cuda",
                                opt.loops, tmp,
                                log=lambda m: print(f"{m} [{card}]",
                                                    flush=True))
        batch = tuple(torch.as_tensor(a, device="cuda")
                      for a in synthetic_batch(cfg.batch_size))
        cost = remat_cost(cfg, "cuda", batch, tmp, opt.steps)
    (g0, peak0, ms0), (g1, peak1, ms1) = cost[False], cost[True]
    worst = max(float((g1[k] - g0[k]).norm() / g0[k].norm().clamp_min(
        1e-30)) for k in g0)
    summary["remat"] = {"peak_gb": {"off": peak0 / 1e9, "remat": peak1 / 1e9},
                        "step_ms": {"off": ms0, "remat": ms1},
                        "worst_grad_rel_l2": worst}
    print(f"remat, f32 off, batch {cfg.batch_size}: peak "
          f"{peak0 / 1e9:.2f} -> {peak1 / 1e9:.2f} GB, median step of "
          f"{opt.steps} {ms0:.1f} -> {ms1:.1f} ms, worst gradient "
          f"||d||/||ref|| {worst:.2e} [{card}]", flush=True)
    summary["card"] = card
    with open(os.path.join(opt.out, "profile_loops.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", default="cfg/p16t9c85r12.cfg")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", default="chiprun_out")
    p.add_argument("--variants", help="comma list of VARIANTS' names "
                   "(a semicolon list where a name holds a comma)")
    p.add_argument("--losses", help="comma list of cfg loss keys to run "
                   "each variant with (default: the cfg's loss)")
    p.add_argument("--loops", type=int, default=0,
                   help="measure fit against fit_device over this many "
                        "steps a run, and --remat, instead of the variants")
    opt = p.parse_args(argv)
    names = [v[0] for v in VARIANTS]
    sep = ";" if opt.variants and ";" in opt.variants else ","
    chosen = opt.variants.split(sep) if opt.variants else names
    if not set(chosen) <= set(names):
        raise SystemExit(f"--variants: a comma list of {'; '.join(names)}")
    import torch

    from probav_tpu_torch.config import Config

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
    if opt.loops:
        return loops_main(opt, cfg, card)
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
            wall, (busy, rows, hand) = device_breakdown(tr, batch)
            tr.logger_.close()
        med = statistics.median(rates)
        idle = 1 - busy / (1e3 * n / med)
        parts = {part: dict(ms=p["ms"], calls=p["launches"],
                            kernels=sorted(k[:90] for k in p["names"]))
                 for part, p in hand.get("blk_bwd", {}).get("parts",
                                                            {}).items()}
        shift = [(h["ms"], h["launches"]) for k, h in hand.items()
                 if k.startswith("shift_table")]
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
