"""Times of the block-stack kernels at the flagship shape, in rounds, to
compare two trees of the port on one card.

    python3 probav_tpu_torch/tools/time_conv.py [--tree ROOT] \\
        [--label NAME] [--rounds 5] [--out chiprun_out] \\
        [--kernels conv_fwd,seg_fwd,blk_bwd,wide_bwd] \\
        [--widths 32,256,25] [--dtypes float32,bfloat16]

``--tree`` is the root of the tree whose ``probav_tpu_torch`` is timed
(default: the tree that holds this script), so a parent unpacked with
``git archive`` is timed by the same script; run it by path, not with
``-m``.  The costs are the tree's own ``tools/tstack_roofline.py``.  At 128 patches of 22x22x9 (N = 557,568 rows), channels
32/256/25, float32 (TF32 off) and bf16, for each of ``--kernels``
(default: conv_fwd alone): one parity check against its plain version
(blk_bwd and wide_bwd on the dyadic inputs of ``tools/dyadic.py``), then
``--rounds`` rounds of the median of 20 single CUDA-event-timed calls and
of 20 calls queued back to back (device time, without the host's launch
latency).  ``--widths C,C_MID,C_DEC`` times other widths at the same
rows (the 64-filter model's 64,512,51), ``--dtypes`` one dtype alone.
For seg_fwd also its route and, at float32, the error of its
d against float64 on random-normal inputs (``rel_err_f64``).  For blk_bwd
also the wgrad route, at float32 the error of its dWc against float64 on
random-normal inputs (``dwc_rel_err_f64``), and its four sub-kernels
(``tstack_roofline.BLK_BWD_PARTS``): the device time of each per call,
and of each of its kernels, by the kernel names of a ``torch.profiler``
trace of 10 calls back to back, beside its bound (``tstack_roofline.blk_bwd_part_costs``), and in
each round the one PyTorch call that computes the dd conv and the
dWc of the same inputs (cuDNN's conv3d dgrad and weight gradient,
``library_calls``), 20 calls back to back; for conv_fwd likewise
``F.conv3d`` of the same d, weights and bias (the conv without the
residual, as chip_smoke times it).
Run parent, change, change, parent in one call and compare the rounds'
spread.  Prints one JSON line and appends it to ``<out>/time_conv.jsonl``.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

SHAPE, C_DEC, C_OUT, C_MID = (128, 22, 22, 9), 25, 32, 256
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# blk_bwd and wide_bwd on dyadic inputs: dx as chip_smoke's BWD_TOL, the
# weight gradients 1e-4 of max|ref|.
BWD_TOL = {"float32": 2e-5, "bfloat16": 8e-3}
KERNELS = ("conv_fwd", "seg_fwd", "blk_bwd", "wide_bwd")


def profile_parts(call, reps=10):
    """{part: (ms per call, {kernel name: its ms per call})} of blk_bwd's
    sub-kernels (``tstack_roofline.blk_bwd_part``), from a torch.profiler
    trace of ``reps`` calls back to back."""
    import torch

    from probav_tpu_torch.tools.tstack_roofline import blk_bwd_part, kernel_ms
    parts = {}
    for key, ms in kernel_ms(torch, call, reps,
                             need=("reduce_partials_kernel",)).items():
        part = blk_bwd_part(key)
        if part:
            t, names = parts.get(part, (0.0, {}))
            parts[part] = (t + ms, {**names, key[:120]: ms})
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
        dcl = d.permute(0, 4, 1, 2, 3)
        wcl = wc.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        conv3d = lambda: torch.nn.functional.conv3d(dcl, wcl, bc, padding=1)
        return (lambda: ts.conv_fwd(d, x, wc, bc),
                lambda: ts.conv_fwd_plain(d, x, wc, bc), TOL[dn],
                {"conv3d": conv3d})
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
    global C_OUT, C_MID, C_DEC
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default="")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--kernels", default="conv_fwd")
    ap.add_argument("--widths", default=f"{C_OUT},{C_MID},{C_DEC}",
                    help="C,C_MID,C_DEC")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    opt = ap.parse_args(argv)
    C_OUT, C_MID, C_DEC = (int(v) for v in opt.widths.split(","))
    kernels = opt.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        raise SystemExit(f"--kernels: a comma list of {', '.join(KERNELS)}")
    sys.path.insert(0, os.path.abspath(opt.tree))
    import torch

    from probav_tpu_torch.ops import tstack as ts
    from probav_tpu_torch.ops import wide_block as wb
    from probav_tpu_torch.tools.tstack_roofline import (back_to_back,
                                                        blk_bwd_part_costs,
                                                        card_line)
    if not torch.cuda.is_available():
        raise SystemExit("time_conv needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    result = dict(label=opt.label, tree=opt.tree, card=card,
                  shape=list(SHAPE), c_dec=C_DEC, c_out=C_OUT, c_mid=C_MID)
    for name in kernels:
        for dtype in (getattr(torch, k) for k in opt.dtypes.split(",")):
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
            if "wgrad" in lib:   # the library's dWc is the plain
                # version's (the weight grad in the working dtype: bf16
                # rounds it)
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
                b2b.append(back_to_back(torch, call)[0])
                for part, fn in lib.items():
                    lib_b2b[part].append(back_to_back(torch, fn)[0])
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
