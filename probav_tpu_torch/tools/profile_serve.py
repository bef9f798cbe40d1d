"""Warm serving throughput of the port, and where its device time goes.

    python3 -m probav_tpu_torch.tools.profile_serve [--cfg CFG] \\
        [--scenes 16] [--repeats 5] [--out chiprun_out] [--traces]

For bf16 and float32, each with the hand-written stack kernels and with
the plain stack, it builds the model from a seeded init and resolves
``--scenes`` synthetic scenes of 64 patches (values 4000-12000, numpy seed
0), laid out as the serve CLI lays out its input.  The first resolve is a warm-up: it pays the kernel build, cuDNN's
algorithm choice and lazy module loading.  ``--repeats`` more resolves
are timed on the host clock, and their median scenes/s is the warm
throughput.  One more resolve runs under ``torch.profiler``: the device
time of each kernel and memcpy and their sum (device busy).  The idle
share is 1 - busy / the unprofiled median wall time, since the profiler
slows the host side of its own window.  A JSON summary goes to
``<out>/profile_serve.json``; ``--traces`` adds Chrome traces.  Needs a
CUDA card; float32 runs with TF32 off.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np

from probav_tpu_torch.serve import model_layout

VARIANTS = (("bf16 kernels", "bfloat16", True),
            ("bf16 plain", "bfloat16", False),
            ("f32 kernels", "float32", True),
            ("f32 plain", "float32", False))


def synthetic_patches(scenes: int, seed: int = 0) -> np.ndarray:
    """[S, 64, 9, 1, 22, 22] float32 LR patches in the resolver ``.npy``
    layout that the serve CLI reads, with values in 4000-12000, the value
    range bench.py feeds the JAX resolver."""
    rng = np.random.default_rng(seed)
    return rng.uniform(4000, 12000, (scenes, 64, 9, 1, 22, 22)) \
        .astype(np.float32)


def make_resolver(cfg: str, dtype: str, fused: bool, device, mesh=None):
    """A Resolver over the cfg's model from torch.Generator seed 0, on
    ``mesh``'s data axis where given."""
    import torch

    from probav_tpu_torch.infer.resolver import Resolver
    from probav_tpu_torch.models.wdsr import build_model

    model = build_model(cfg, "NIR", dtype=getattr(torch, dtype),
                        fused_stack=fused,
                        generator=torch.Generator().manual_seed(0))
    scene = model.patch_size_lr * model.scale * 8        # 8x8 patch grid
    return Resolver(model, None, scene_size=scene, device=device,
                    mesh=mesh)


def warm_rates(resolver, patches: np.ndarray, repeats: int) -> list:
    """scenes/s of ``repeats`` resolves of ``patches`` (laid out by
    ``serve.model_layout``, as the CLI passes them) after one warm-up
    resolve.  ``resolve_all`` returns host arrays, so each wall time
    covers the device work."""
    resolver.resolve_all(patches)
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        resolver.resolve_all(patches)
        rates.append(len(patches) / (time.perf_counter() - t0))
    return rates


def device_breakdown(resolver, patches: np.ndarray, trace: str = None):
    """(wall ms, device-busy ms, [(ms, kernel name, count)] by time) of one
    resolve under torch.profiler, after a profiled warm-up that absorbs
    the profiler's own start-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        resolver.resolve_all(patches[:2])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        resolver.resolve_all(patches)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if trace:
        prof.export_chrome_trace(trace)

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
    p.add_argument("--scenes", type=int, default=16)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--out", default="chiprun_out")
    p.add_argument("--traces", action="store_true")
    opt = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("profile_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    os.makedirs(opt.out, exist_ok=True)
    patches = model_layout(synthetic_patches(opt.scenes))
    summary = {}
    for name, dtype, fused in VARIANTS:
        r = make_resolver(opt.cfg, dtype, fused, "cuda")
        rates = warm_rates(r, patches, opt.repeats)
        trace = (os.path.join(opt.out, f"trace_{name.replace(' ', '_')}"
                              ".json") if opt.traces else None)
        wall, busy, rows = device_breakdown(r, patches, trace)
        med = statistics.median(rates)
        idle = 1 - busy / (1e3 * opt.scenes / med)
        summary[name] = dict(rates=rates, median=med, profiled_wall_ms=wall,
                             device_busy_ms=busy, idle=idle,
                             top=[(t, k[:90], c) for t, k, c in rows[:14]])
        print(f"== {name}: resolve {opt.scenes} scenes, scenes/s "
              f"{['%.3f' % x for x in rates]} median {med:.3f}; device "
              f"busy {busy:.2f} ms, idle {100 * idle:.1f}% of the median "
              f"wall (profiled wall {wall:.2f} ms) [{card}]", flush=True)
        for t, k, c in rows[:14]:
            print(f"   {t:9.3f} ms  {100 * t / busy:5.1f}%  x{c:<5d} "
                  f"{k[:100]}", flush=True)
        del r
        torch.cuda.empty_cache()
    with open(os.path.join(opt.out, "profile_serve.json"), "w") as f:
        json.dump(dict(card=card, runs=summary), f, indent=1)
    return summary


if __name__ == "__main__":
    main()
