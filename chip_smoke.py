#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each printing its result:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the CUDA kernels of probav_tpu_torch/csrc, compiled with nvcc;
3. kernels: seg_fwd and conv_fwd against their plain PyTorch versions at
   the flagship serving shapes (128 patches of 22x22x9, channels
   32/256/25) in float32 (TF32 off) and bf16, with median CUDA-event
   times of both; a 64-filter shape (64/512/51) is checked for parity;
4. model: the flagship cfg/p16t9c85r12.cfg model from a seeded init,
   535,267 parameters, forward of the kernel stack against the plain
   stack on 128 patches;
5. serve: ``probav_tpu_torch.serve.main()`` on a synthetic tree (16 scenes
   of 64 patches; 2 scenes for TTA-20) at bf16 and float32, with and
   without --tta, and --plain at both; PNG names, launch counts and the
   float32 kernel-vs-plain agreement (within one count) are checked.  Each
   CLI run is one cold run: a fresh model, first calls included;
6. warm: ``Resolver.resolve_all`` on the same 16 scenes at bf16 and
   float32, kernels and plain, after a warm-up resolve: the median and
   range of 5 timed runs (``probav_tpu_torch.tools.profile_serve`` adds
   the device-time breakdown).

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.  Any failure raises, and the script exits
non-zero without that line.  Without CUDA it exits 1 at once.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, "cfg", "p16t9c85r12.cfg")

# Parity tolerances, as fractions of max|reference|.  float32: the kernels
# sum in another order than cuDNN/cuBLAS (tests/test_tstack.py:65 holds the
# TPU kernels to the same 2e-5).  bf16: one bf16 rounding of the stored
# output (2**-8 relative) plus order effects in the relu rounding.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Whole-model tolerances: float32 through 12 blocks and the ladder; bf16
# against the plain bf16 stack, which rounds the expand output before the
# relu (measured 2e-3 on the CPU at this init, so 5x margin).
MODEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
N_PATCH, HW, T = 128, 22, 9
C, CMID, CDEC = 32, 256, 25
PARAMS = 535_267
SERVE_SCENES, TTA_SCENES = 16, 2
WARM_REPEATS = 5


def log(msg):
    print(msg, flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def timed_pair(torch, plain_fn, kern_fn, reps=20):
    """Median CUDA-event ms of plain_fn and kern_fn, run in turns."""
    for fn in (plain_fn, kern_fn):
        fn()
    torch.cuda.synchronize()
    times = {"plain": [], "kernel": []}
    for i in range(reps):
        order = [("plain", plain_fn), ("kernel", kern_fn)]
        for name, fn in (order if i % 2 == 0 else order[::-1]):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times[name].append(s.elapsed_time(e))
    return (statistics.median(times["kernel"]),
            statistics.median(times["plain"]))


def stack_inputs(torch, dev, dtype, n, c, cmid, cdec, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale)

    x = rn(n, HW, HW, T, c).to(dtype)
    w1 = rn(c, cmid, scale=c ** -0.5).to(dtype)
    b1 = rn(cmid, scale=0.1).to(dtype)
    w2 = rn(cmid, cdec, scale=cmid ** -0.5).to(dtype)
    b2 = rn(cdec, scale=0.1).to(dtype)
    wc = rn(3, 3, 3, cdec, c, scale=(27 * cdec) ** -0.5).to(dtype)
    bc = rn(c, scale=0.1).to(dtype)
    return x, (w1, b1, w2, b2, wc, bc)


def check(name, got, ref, tol):
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    if not np.isfinite(err) or err > tol * scale:
        raise AssertionError(f"{name}: max|diff| {err:.3e} > {tol:g} * "
                             f"max|ref| {scale:.3e}")
    return err, scale


def phase_kernels(torch, ts, dev, card):
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        x, (w1, b1, w2, b2, wc, bc) = stack_inputs(
            torch, dev, dtype, N_PATCH, C, CMID, CDEC, seed=1)
        x2 = x.reshape(-1, C)
        d = ts.seg_fwd(x2, w1, b1, w2, b2)
        torch.cuda.synchronize()
        err, scale = check(f"seg_fwd {dn}", d,
                           ts.seg_fwd_plain(x2, w1, b1, w2, b2), TOL[dn])
        ms, pms = timed_pair(torch,
                             lambda: ts.seg_fwd_plain(x2, w1, b1, w2, b2),
                             lambda: ts.seg_fwd(x2, w1, b1, w2, b2))
        rows[("seg_fwd", dn)] = (err, ms, pms)
        log(f"kernel seg_fwd {dn} [{N_PATCH * HW * HW * T}, {C}->{CMID}->"
            f"{CDEC}]: max|diff| {err:.3e} (max|ref| {scale:.3e}, tol "
            f"{TOL[dn]:g}); kernel {ms:.4f} ms, plain {pms:.4f} ms "
            f"[{card}]")
        d5 = d.reshape(x.shape[:-1] + (CDEC,))
        out = ts.conv_fwd(d5, x, wc, bc)
        torch.cuda.synchronize()
        err, scale = check(f"conv_fwd {dn}", out,
                           ts.conv_fwd_plain(d5, x, wc, bc), TOL[dn])
        ms, pms = timed_pair(torch,
                             lambda: ts.conv_fwd_plain(d5, x, wc, bc),
                             lambda: ts.conv_fwd(d5, x, wc, bc))
        rows[("conv_fwd", dn)] = (err, ms, pms)
        log(f"kernel conv_fwd {dn} [{N_PATCH}x{HW}x{HW}x{T}, {CDEC}->{C}]: "
            f"max|diff| {err:.3e} (max|ref| {scale:.3e}, tol {TOL[dn]:g}); "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms [{card}]")
        # The 64-filter model's widths (c_dec 51 > C_out 32 buckets).
        x, (w1, b1, w2, b2, wc, bc) = stack_inputs(
            torch, dev, dtype, 16, 64, 512, 51, seed=2)
        xw = x.reshape(-1, 64)
        dw = ts.seg_fwd(xw, w1, b1, w2, b2)
        e1, _ = check(f"seg_fwd 64/512/51 {dn}", dw,
                      ts.seg_fwd_plain(xw, w1, b1, w2, b2), TOL[dn])
        dw5 = dw.reshape(x.shape[:-1] + (51,))
        e2, _ = check(f"conv_fwd 64/512/51 {dn}", ts.conv_fwd(dw5, x, wc, bc),
                      ts.conv_fwd_plain(dw5, x, wc, bc), TOL[dn])
        log(f"kernel parity at 64/512/51 {dn}: seg_fwd {e1:.3e}, conv_fwd "
            f"{e2:.3e}")
    return rows


def phase_model(torch, dev, card):
    from probav_tpu_torch.models.wdsr import build_model

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(4000, 12000, (N_PATCH, HW, HW, T, 1))
                        .astype(np.float32), device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        outs = {}
        for fused in (True, False):
            m = build_model(CFG, "NIR", dtype=dtype, fused_stack=fused,
                            generator=torch.Generator().manual_seed(0))
            n = sum(p.numel() for p in m.parameters())
            if n != PARAMS:
                raise AssertionError(f"{n} parameters, expected {PARAMS}")
            with torch.inference_mode():
                outs[fused] = m.to(dev).eval()(x)
        torch.cuda.synchronize()
        if tuple(outs[True].shape) != (N_PATCH, 48, 48, 1):
            raise AssertionError(f"output shape {tuple(outs[True].shape)}")
        err, scale = check(f"model {dn}", outs[True], outs[False],
                           MODEL_TOL[dn])
        log(f"model {dn}: {PARAMS} params, kernel stack vs plain stack on "
            f"{N_PATCH} patches max|diff| {err:.3e} (max|ref| {scale:.3e}, "
            f"tol {MODEL_TOL[dn]:g}) [{card}]")


def write_tree(root, name, patches, params_npz):
    """A cfg copy whose directories point into root/name."""
    base = os.path.join(root, name)
    data = os.path.join(base, "data")
    os.makedirs(os.path.join(data, "resolverDir"))
    np.save(os.path.join(data, "resolverDir", "TESTpatchesLR_NIR.npy"),
            patches)
    dirs = {"raw_data": os.path.join(base, "raw"), "preprocessing_out": data,
            "model_out": os.path.join(base, "model"),
            "train_out": os.path.join(base, "trainout"),
            "test_out": os.path.join(base, "testout")}
    lines = []
    with open(CFG) as f:
        for line in f:
            key = line.split("=", 1)[0].strip()
            lines.append(f"{key}={dirs[key]}\n" if key in dirs else line)
    cfg = os.path.join(base, "p16t9c85r12.cfg")
    with open(cfg, "w") as f:
        f.writelines(lines)
    return ["--cfg", cfg, "--band", "NIR", "--totest", "TEST",
            "--params", params_npz]


def phase_serve(torch, ts, dev, card):
    from probav_tpu_torch import serve
    from probav_tpu_torch.convert import save_npz
    from probav_tpu_torch.infer.resolver import MODEL_CHUNK
    from probav_tpu_torch.models.wdsr import build_model
    from probav_tpu_torch.tools.profile_serve import synthetic_patches
    from probav_tpu_torch.utils.png import read_png

    patches = synthetic_patches(SERVE_SCENES)
    model = build_model(CFG, "NIR", generator=torch.Generator().manual_seed(0))
    blocks = len(model.block_names)
    results, launches = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "params.npz")
        save_npz(npz, model.state_dict())
        trees = {"full": (write_tree(tmp, "full", patches, npz),
                          SERVE_SCENES, 1),
                 "tta": (write_tree(tmp, "tta", patches[:TTA_SCENES], npz),
                         TTA_SCENES, 20)}
        runs = [("bf16", "full", ["--bf16"]), ("f32", "full", []),
                ("bf16 plain", "full", ["--bf16", "--plain"]),
                ("f32 plain", "full", ["--plain"]),
                ("bf16 tta", "tta", ["--bf16", "--tta"]),
                ("f32 tta", "tta", ["--tta"])]
        for name, tree, flags in runs:
            args, scenes, repeats = trees[tree]
            outdir = os.path.join(tmp, tree, "testout_p16t9c85r12")
            ts.reset_launches()
            t0 = time.perf_counter()
            res = serve.main(args + flags + ["--device", str(dev)])
            wall = time.perf_counter() - t0
            got = dict(ts.LAUNCHES)
            if name == "bf16":
                launches = got          # the production run: main path
            names = sorted(os.listdir(outdir))
            want = [f"imgset{1306 + i:04d}.png" for i in range(scenes)]
            if names != want or len(res["written"]) != scenes:
                raise AssertionError(f"{name}: wrote {names}")
            group = -(-512 // (64 * repeats))
            chunks = sum(-(-min(group, scenes - s) * 64 * repeats //
                           MODEL_CHUNK) for s in range(0, scenes, group))
            per = 0 if "plain" in name else blocks * chunks
            if got != {"seg_fwd": per, "conv_fwd": per}:
                raise AssertionError(f"{name}: launches {got}, expected "
                                     f"{per} of each")
            imgs = np.stack([read_png(os.path.join(outdir, n))
                             for n in names]).astype(np.int64)
            if imgs.shape != (scenes, 384, 384):
                raise AssertionError(f"{name}: images {imgs.shape}")
            results[name] = imgs
            os.rename(outdir, outdir + "_" + name.replace(" ", "_"))
            log(f"serve {name}: {scenes} scenes, {got['seg_fwd']} launches "
                f"of each kernel; one cold run (fresh model, first calls "
                f"included): resolve {scenes / res['resolve_s']:.3f} "
                f"scenes/s, CLI end to end {scenes / wall:.3f} scenes/s "
                f"[{card}]")
    diff = np.abs(results["f32"] - results["f32 plain"]).max()
    if diff > 1:
        raise AssertionError(f"f32 kernels vs f32 plain: {diff} counts")
    for a, b in (("bf16", "f32"), ("bf16 tta", "f32 tta"),
                 ("bf16", "bf16 plain")):
        dlt = np.abs(results[a] - results[b])
        log(f"drift {a} vs {b}: max {int(dlt.max())} counts, "
            f"{float((dlt > 0).mean()) * 100:.3f}% of pixels differ")
    log(f"serve f32 kernels vs f32 plain: max {int(diff)} counts")
    return launches


def phase_warm(torch, dev, card):
    """Warm resolve throughput on the serve phase's scenes, laid out as
    the CLI lays them out: one warm-up resolve, then WARM_REPEATS timed
    ones per variant; prints the median and the range."""
    from probav_tpu_torch.serve import model_layout
    from probav_tpu_torch.tools.profile_serve import (VARIANTS,
                                                      make_resolver,
                                                      synthetic_patches,
                                                      warm_rates)

    patches = model_layout(synthetic_patches(SERVE_SCENES))
    for name, dtype, fused in VARIANTS:
        rates = warm_rates(make_resolver(CFG, dtype, fused, dev), patches,
                           WARM_REPEATS)
        torch.cuda.empty_cache()
        log(f"warm resolve {name}: {SERVE_SCENES} scenes, median of "
            f"{WARM_REPEATS} {statistics.median(rates):.3f} scenes/s "
            f"(min {min(rates):.3f}, max {max(rates):.3f}) [{card}]")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from probav_tpu_torch.ops import _build
    from probav_tpu_torch.ops import tstack as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} | nvidia-smi: {card}")

    path, secs, report = _build.build(verbose=True)
    ptxas = [ln.strip() for ln in report.splitlines()
             if "Function properties" in ln or "registers" in ln
             or "spill" in ln]
    print("\n".join(ptxas), file=sys.stderr)
    log(f"build: {os.path.relpath(path, ROOT)} in {secs:.1f} s (nvcc "
        f"{' '.join(_build.NVCC_FLAGS)})")

    rows = phase_kernels(torch, ts, dev, card)
    phase_model(torch, dev, card)
    launches = phase_serve(torch, ts, dev, card)
    phase_warm(torch, dev, card)

    replaces = {"seg_fwd": "probav_tpu/ops/pallas_tstack.py:244",
                "conv_fwd": "probav_tpu/ops/pallas_tstack.py:290"}
    kernels = []
    for name in ("seg_fwd", "conv_fwd"):
        err, ms, pms = rows[(name, "bfloat16")]
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the serve path")
        kernels.append({"name": name, "route": "cuda",
                        "source": "probav_tpu_torch/csrc/tstack.cu",
                        "replaces": replaces[name],
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": pms})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
