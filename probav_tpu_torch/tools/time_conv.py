"""Times of the block-stack kernels at the flagship shape, in rounds, to
compare two trees of the port on one card.

    python3 probav_tpu_torch/tools/time_conv.py [--tree ROOT] \\
        [--label NAME] [--rounds 5] [--out chiprun_out] \\
        [--kernels conv_fwd,seg_fwd,blk_bwd,wide_bwd]

``--tree`` is the root of the tree whose ``probav_tpu_torch`` is timed
(default: the tree that holds this script), so a parent unpacked with
``git archive`` is timed by the same script; run it by path, not with
``-m``.  At 128 patches of 22x22x9 (N = 557,568 rows), channels
32/256/25, float32 (TF32 off) and bf16, for each of ``--kernels``
(default: conv_fwd alone): one parity check against its plain version
(blk_bwd and wide_bwd on the dyadic inputs of ``tools/dyadic.py``), then
``--rounds`` rounds of the median of 20 single CUDA-event-timed calls and
of 20 calls queued back to back (device time, without the host's launch
latency).  For seg_fwd also its route and, at float32, the error of its
d against float64 on random-normal inputs (``rel_err_f64``).  For blk_bwd
also the wgrad route, at float32 the error of its dWc against float64 on
random-normal inputs (``dwc_rel_err_f64``), and its four sub-kernels
(``BLK_BWD_PARTS``): the device time of each per call, by the kernel
names of a ``torch.profiler``
trace of 10 calls back to back, beside its bound (``blk_bwd_part_costs``),
and in each round the one PyTorch call that computes the dd conv and the
dWc of the same inputs (cuDNN's conv3d dgrad and weight gradient,
``library_calls``), 20 calls back to back.
Run parent, change, change, parent in one call and compare the rounds'
spread.  Prints one JSON line and appends it to ``<out>/time_conv.jsonl``.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPE, C_DEC, C_OUT, C_MID = (128, 22, 22, 9), 25, 32, 256
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# blk_bwd and wide_bwd on dyadic inputs: dx as chip_smoke's BWD_TOL, the
# weight gradients 1e-4 of max|ref|.
BWD_TOL = {"float32": 2e-5, "bfloat16": 8e-3}
KERNELS = ("conv_fwd", "seg_fwd", "blk_bwd", "wide_bwd")
# blk_bwd's sub-kernels: (part, ((kernel name, what its name must also
# hold), ...)).  The dd conv is conv_ring_kernel without the residual (its
# last template argument false; conv_fwd's is true); seg_bwd_kernel with
# WIDE true and wide_bwd_tf32_kernel (seg_bwd_tf32_kernel's WIDE flavour,
# a name of its own) are wide_bwd's, not blk_bwd's.
BLK_BWD_PARTS = (("dd conv", (("conv_ring_kernel", ", false>"),)),
                 ("wgrad", (("wgrad_kernel", ""), ("wgrad_ring_kernel", ""),
                            ("wgrad_tf32_kernel", ""))),
                 ("seg_bwd", (("seg_bwd_kernel", ", false>"),
                              ("seg_bwd_bf16_kernel", ""),
                              ("seg_bwd_tf32_kernel", ""))),
                 ("reduce", (("reduce_partials_kernel", ""),)))
# H100 SXM peaks (NVIDIA data sheet, dense): float32 on the CUDA cores,
# TF32 and bf16 on the tensor cores; device memory.
PEAK = {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def blk_bwd_part(kernel_name: str) -> str | None:
    """The sub-kernel of blk_bwd a profiled kernel name belongs to (the
    reduce is wide_bwd's too: read it where only blk_bwd runs)."""
    for part, kernels in BLK_BWD_PARTS:
        for name, tail in kernels:
            if (f"{name}<" in kernel_name or f"{name}(" in kernel_name) \
                    and tail in kernel_name:
                return part
    return None


def blk_bwd_part_costs(n, c, cmid, cdec, dn, groups):
    """{part: (FLOP, bytes, bound ms, bound by)} of one blk_bwd at n rows:
    each input read once, each output written once.  The bound is the
    least time on the card: bf16 at the bf16 tensor-core peak, float32 as
    3xTF32 (three TF32 products for each, at the TF32 peak; the key
    "cuda_core_ms" gives the CUDA cores' bound beside it).  The reduce
    reads the groups' float32 slots and writes one."""
    s = 4 if dn == "float32" else 2
    slot = 27 * cdec * c + c * cmid + cmid * cdec + cmid + cdec + c
    conv = 2 * n * 27 * cdec * c
    parts = {
        "dd conv": (conv, s * (n * (c + cdec) + 27 * cdec * c)),
        "wgrad": (conv, s * n * (c + cdec) + 4 * 27 * cdec * c),
        "seg_bwd": (2 * n * cmid * (3 * c + 2 * cdec),
                    s * (n * (3 * c + cdec) + c * cmid + cmid * cdec) +
                    4 * (cmid + c * cmid + cmid * cdec + cmid + cdec + c)),
        "reduce": (groups * slot, 4 * (groups + 1) * slot)}
    out = {}
    for part, (flops, nbytes) in parts.items():
        t_bytes = nbytes / PEAK_BYTES * 1e3
        if part == "reduce":
            t_ops = flops / PEAK["float32"] * 1e3
        elif dn == "float32":
            t_ops = 3 * flops / PEAK["tf32"] * 1e3
        else:
            t_ops = flops / PEAK["bfloat16"] * 1e3
        row = dict(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        if dn == "float32" and part != "reduce":
            row["cuda_core_ms"] = max(flops / PEAK["float32"] * 1e3,
                                      t_bytes)
        out[part] = row
    return out


def profile_parts(call, reps=10):
    """{part: (ms per call, [kernel names])} of blk_bwd's sub-kernels, from
    a torch.profiler trace of ``reps`` calls back to back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        part = blk_bwd_part(e.key)
        if us > 0 and part:
            ms, names = parts.get(part, (0.0, []))
            parts[part] = (ms + us / 1e3 / reps, names + [e.key[:120]])
    return parts


def library_calls(gy, x, d, w1, b1, w2, wc):
    """{part: one PyTorch call computing it} for blk_bwd's dd conv and
    wgrad on the same inputs: ``convolution_backward`` of the block's conv
    (d -> out with weights wc) for grad_input (dd) or grad_weight (dWc),
    on the [B,H,W,T,C] tensors viewed as NCDHW (channels_last_3d, no
    copy).  Timed beside the kernels only; the port never calls them."""
    import torch
    del x, w1, b1, w2
    dcl, gcl = d.permute(0, 4, 1, 2, 3), gy.permute(0, 4, 1, 2, 3)
    wcl = wc.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    back = lambda mask: torch.ops.aten.convolution_backward(
        gcl, dcl, wcl, None, [1] * 3, [1] * 3, [1] * 3, False, [0] * 3, 1,
        mask)
    return {"dd conv": lambda: back([True, False, False])[0],
            "wgrad": lambda: back([False, True, False])[1]}


def dwc_float64(d, gy):
    """dWc [3,3,3,C_dec,C] of blk_bwd in float64: per tap, d [B,H,W,T,C_dec]
    shifted by the tap (zero-padded) times gy [B,H,W,T,C], summed over every
    position."""
    import torch
    h, w, t, c_dec = d.shape[1:]
    dp = torch.nn.functional.pad(d.double(), (0, 0, 1, 1, 1, 1, 1, 1))
    g2 = gy.double().reshape(-1, gy.shape[-1])
    return torch.stack([
        dp[:, i:i + h, j:j + w, k:k + t].reshape(-1, c_dec).t() @ g2
        for i in range(3) for j in range(3) for k in range(3)]).reshape(
            3, 3, 3, c_dec, -1)


def dwc_rel_err_f64(ts, dev, seed=12):
    """max|dWc - ref| / max|ref| of float32 blk_bwd at the flagship on
    random-normal d and gy, ref ``dwc_float64``.  Reads the error of
    whichever wgrad kernel the tree routes float32 to."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s, sc=1.0: torch.randn(s, generator=g, device=dev) * sc
    gy, x, d = rn(*SHAPE, C_OUT), rn(*SHAPE, C_OUT), rn(*SHAPE, C_DEC)
    w = (rn(C_OUT, C_MID, sc=C_OUT ** -0.5), rn(C_MID, sc=0.1),
         rn(C_MID, C_DEC, sc=C_MID ** -0.5))
    wc = rn(3, 3, 3, C_DEC, C_OUT, sc=(27 * C_DEC) ** -0.5)
    ref = dwc_float64(d, gy)
    got = ts.blk_bwd(gy, x, d, *w, wc)[1].double()
    return float((got - ref).abs().max() / ref.abs().max())


def seg_fwd_f64(x, w1, b1, w2, b2):
    """seg_fwd in float64: relu(x w1 + b1) w2 + b2."""
    import torch
    return (torch.relu(x.double() @ w1.double() + b1.double()) @
            w2.double() + b2.double())


def seg_fwd_rel_err_f64(ts, dev, seed=12):
    """max|d - ref| / max|ref| of float32 seg_fwd at the flagship on
    random-normal x and weights, ref ``seg_fwd_f64``.  Reads the error of
    whichever kernel the tree routes float32 to."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s, sc=1.0: torch.randn(s, generator=g, device=dev) * sc
    n = SHAPE[0] * SHAPE[1] * SHAPE[2] * SHAPE[3]
    w = (rn(C_OUT, C_MID, sc=C_OUT ** -0.5), rn(C_MID, sc=0.1),
         rn(C_MID, C_DEC, sc=C_MID ** -0.5), rn(C_DEC, sc=0.1))
    x = rn(n, C_OUT)
    ref = seg_fwd_f64(x, *w)
    got = ts.seg_fwd(x, *w).double()
    return float((got - ref).abs().max() / ref.abs().max())


def back_to_back(call, n=20):
    """ms per call of n calls queued back to back (CUDA events)."""
    import torch
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        call()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def calls(ts, wb, name, dtype, dev, g):
    """(kernel call, its plain twin, dx tolerance, {part: library call})
    on one set of inputs."""
    import torch

    from probav_tpu_torch.tools.dyadic import blk_bwd_inputs, wide_bwd_inputs

    def rn(*s, sc=1.0):
        return (torch.randn(s, generator=g, device=dev) * sc).to(dtype)

    dn = str(dtype).split(".")[1]
    if name == "conv_fwd":
        d, x = rn(*SHAPE, C_DEC), rn(*SHAPE, C_OUT)
        wc, bc = rn(3, 3, 3, C_DEC, C_OUT, sc=(27 * C_DEC) ** -0.5), \
            rn(C_OUT, sc=0.1)
        return (lambda: ts.conv_fwd(d, x, wc, bc),
                lambda: ts.conv_fwd_plain(d, x, wc, bc), TOL[dn], {})
    if name == "seg_fwd":
        x = rn(SHAPE[0] * SHAPE[1] * SHAPE[2] * SHAPE[3], C_OUT)
        w = (rn(C_OUT, C_MID, sc=C_OUT ** -0.5), rn(C_MID, sc=0.1),
             rn(C_MID, C_DEC, sc=C_MID ** -0.5), rn(C_DEC, sc=0.1))
        return (lambda: ts.seg_fwd(x, *w), lambda: ts.seg_fwd_plain(x, *w),
                TOL[dn], {})
    if name == "blk_bwd":
        args = blk_bwd_inputs(SHAPE, C_OUT, C_MID, C_DEC, seed=3,
                              device=dev, dtype=dtype)
        return (lambda: ts.blk_bwd(*args), lambda: ts.blk_bwd_plain(*args),
                BWD_TOL[dn], library_calls(*args))
    n = SHAPE[0] * SHAPE[1] * SHAPE[2] * SHAPE[3]
    args = wide_bwd_inputs(n, C_OUT, C_MID, C_DEC, seed=5, device=dev,
                           dtype=dtype)
    return (lambda: wb.wide_bwd(*args), lambda: wb.wide_bwd_plain(*args),
            BWD_TOL[dn], {})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default="")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--kernels", default="conv_fwd")
    opt = ap.parse_args(argv)
    kernels = opt.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        raise SystemExit(f"--kernels: a comma list of {', '.join(KERNELS)}")
    sys.path.insert(0, os.path.abspath(opt.tree))
    import torch

    from probav_tpu_torch.ops import tstack as ts
    from probav_tpu_torch.ops import wide_block as wb
    if not torch.cuda.is_available():
        raise SystemExit("time_conv needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    result = dict(label=opt.label, tree=opt.tree, card=card,
                  shape=list(SHAPE), c_dec=C_DEC, c_out=C_OUT, c_mid=C_MID)
    for name in kernels:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            call, plain, tol, lib = calls(ts, wb, name, dtype, dev, g)
            got, ref = call(), plain()
            if isinstance(got, torch.Tensor):
                got, ref = (got,), (ref,)
            errs = []
            for i, (a, b) in enumerate(zip(got, ref)):
                err = float((a.float() - b.float()).abs().max())
                lim = (tol if i == 0 else 1e-4) * float(b.float().abs().max())
                if not err <= lim:
                    raise SystemExit(f"{name} {dn} output {i}: max|diff| "
                                     f"{err:.3e} > {lim:.3e}")
                errs.append(err)
            if lib:   # the library's dWc is the plain version's (the
                # weight grad in the working dtype: bf16 rounds it)
                ref_w = ref[1].permute(4, 3, 0, 1, 2)
                err = float((lib["wgrad"]().float() - ref_w).abs().max())
                if not err <= 1e-2 * float(ref_w.abs().max()):
                    raise SystemExit(f"library wgrad {dn}: max|diff| {err}")
            del got, ref
            single, b2b = [], []
            lib_b2b = {part: [] for part in lib}
            for _ in range(opt.rounds):
                times = []
                for _ in range(20):
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    call()
                    e.record()
                    e.synchronize()
                    times.append(s.elapsed_time(e))
                single.append(statistics.median(times))
                b2b.append(back_to_back(call))
                for part, fn in lib.items():
                    lib_b2b[part].append(back_to_back(fn))
            key = dn if name == "conv_fwd" else f"{name} {dn}"
            result[key] = dict(max_abs_err=max(errs), single_ms=single,
                               b2b_ms=b2b,
                               single_median=statistics.median(single),
                               b2b_median=statistics.median(b2b))
            if lib:
                result[key]["library_b2b_ms"] = lib_b2b
                result[key]["library_b2b_median"] = {
                    part: statistics.median(v) for part, v in lib_b2b.items()}
            if name == "seg_fwd":
                if hasattr(ts, "seg_fwd_route"):   # a parent may lack it
                    result[key]["route"] = ts.seg_fwd_route(
                        dtype, C_OUT, C_MID, C_DEC)
                if dn == "float32":
                    result[key]["rel_err_f64"] = seg_fwd_rel_err_f64(ts, dev)
            if name == "blk_bwd":
                result[key]["wgrad_route"] = ts.wgrad_route(
                    dtype, C_OUT, C_DEC, SHAPE[2], SHAPE[3])
                if dn == "float32":
                    result[key]["dwc_rel_err_f64"] = dwc_rel_err_f64(ts, dev)
                n = SHAPE[0] * SHAPE[1] * SHAPE[2] * SHAPE[3]
                groups = ts.partial_slots(dev, C_OUT, C_DEC)
                costs = blk_bwd_part_costs(n, C_OUT, C_MID, C_DEC, dn,
                                           groups)
                result[key]["parts"] = {
                    part: dict(ms=ms, kernels=names, **costs[part])
                    for part, (ms, names) in profile_parts(call).items()}
            del call, plain, lib
            torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line, flush=True)
    os.makedirs(opt.out, exist_ok=True)
    with open(os.path.join(opt.out, "time_conv.jsonl"), "a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
