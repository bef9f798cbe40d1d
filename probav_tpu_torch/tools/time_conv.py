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
latency).  Run parent, change, change, parent in one call and compare the
rounds' spread.  Prints one JSON line and appends it to
``<out>/time_conv.jsonl``.  Needs a CUDA card.
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


def calls(ts, wb, name, dtype, dev, g):
    """(kernel call, its plain twin, dx tolerance) on one set of inputs."""
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
                lambda: ts.conv_fwd_plain(d, x, wc, bc), TOL[dn])
    if name == "seg_fwd":
        x = rn(SHAPE[0] * SHAPE[1] * SHAPE[2] * SHAPE[3], C_OUT)
        w = (rn(C_OUT, C_MID, sc=C_OUT ** -0.5), rn(C_MID, sc=0.1),
             rn(C_MID, C_DEC, sc=C_MID ** -0.5), rn(C_DEC, sc=0.1))
        return (lambda: ts.seg_fwd(x, *w), lambda: ts.seg_fwd_plain(x, *w),
                TOL[dn])
    if name == "blk_bwd":
        args = blk_bwd_inputs(SHAPE, C_OUT, C_MID, C_DEC, seed=3,
                              device=dev, dtype=dtype)
        return (lambda: ts.blk_bwd(*args), lambda: ts.blk_bwd_plain(*args),
                BWD_TOL[dn])
    n = SHAPE[0] * SHAPE[1] * SHAPE[2] * SHAPE[3]
    args = wide_bwd_inputs(n, C_OUT, C_MID, C_DEC, seed=5, device=dev,
                           dtype=dtype)
    return (lambda: wb.wide_bwd(*args), lambda: wb.wide_bwd_plain(*args),
            BWD_TOL[dn])


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
            call, plain, tol = calls(ts, wb, name, dtype, dev, g)
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
            del got, ref
            single, b2b = [], []
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
                torch.cuda.synchronize()
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(20):
                    call()
                e.record()
                e.synchronize()
                b2b.append(s.elapsed_time(e) / 20)
            key = dn if name == "conv_fwd" else f"{name} {dn}"
            result[key] = dict(max_abs_err=max(errs), single_ms=single,
                               b2b_ms=b2b,
                               single_median=statistics.median(single),
                               b2b_median=statistics.median(b2b))
            del call, plain
            torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line, flush=True)
    os.makedirs(opt.out, exist_ok=True)
    with open(os.path.join(opt.out, "time_conv.jsonl"), "a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
