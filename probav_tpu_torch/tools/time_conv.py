"""Times of the ``conv_fwd`` kernel at the flagship shape, in rounds, to
compare two trees of the port on one card.

    python3 probav_tpu_torch/tools/time_conv.py [--tree ROOT] \\
        [--label NAME] [--rounds 5] [--out chiprun_out]

``--tree`` is the root of the tree whose ``probav_tpu_torch`` is timed
(default: the tree that holds this script), so a parent unpacked with
``git archive`` is timed by the same script; run it by path, not with
``-m``.  At 128 patches of 22x22x9, 25 -> 32 channels, float32 (TF32 off)
and bf16: one parity check against ``conv_fwd_plain``, then ``--rounds``
rounds of the median of 20 single CUDA-event-timed calls and of 20 calls
queued back to back (device time, without the host's launch latency).
Run parent, change, change, parent in one call and compare the rounds'
spread.  Prints one JSON line and appends it to
``<out>/time_conv.jsonl``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPE, C_DEC, C_OUT = (128, 22, 22, 9), 25, 32
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default="")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out")
    opt = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(opt.tree))
    import torch

    from probav_tpu_torch.ops import tstack as ts
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
                  shape=list(SHAPE), c_dec=C_DEC, c_out=C_OUT)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]

        def rn(*s, sc=1.0):
            return (torch.randn(s, generator=g, device=dev) * sc).to(dtype)

        d, x = rn(*SHAPE, C_DEC), rn(*SHAPE, C_OUT)
        wc, bc = rn(3, 3, 3, C_DEC, C_OUT, sc=(27 * C_DEC) ** -0.5), \
            rn(C_OUT, sc=0.1)
        ref = ts.conv_fwd_plain(d, x, wc, bc).float()
        err = float((ts.conv_fwd(d, x, wc, bc).float() - ref).abs().max())
        if not err <= TOL[dn] * float(ref.abs().max()):
            raise SystemExit(f"conv_fwd {dn}: max|diff| {err:.3e}")

        def call():
            ts.conv_fwd(d, x, wc, bc)

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
        result[dn] = dict(max_abs_err=err, single_ms=single, b2b_ms=b2b,
                          single_median=statistics.median(single),
                          b2b_median=statistics.median(b2b))
        del d, x, ref
    line = json.dumps(result)
    print(line, flush=True)
    os.makedirs(opt.out, exist_ok=True)
    with open(os.path.join(opt.out, "time_conv.jsonl"), "a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
