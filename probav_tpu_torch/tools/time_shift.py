"""Times of the shift-table kernels at the main path's shapes, in rounds, to
compare two trees of the port on one card.

    python3 probav_tpu_torch/tools/time_shift.py [--tree ROOT] \\
        [--label NAME] [--rounds 3] [--out chiprun_out]

Builds ``--tree``'s ``csrc/shift_loss.cu`` alone (nvcc with the package's
flags and ``-Xptxas -v``, seconds, not the package's minutes) into a
library under ``<out>``, and calls its C entries by ctypes on this tree's
inputs (``tools/dyadic.shift_table_inputs``: integer planes, 80% clear).
At B = 128 on 48x48 (the kernel loss's train step) and B = 16 on 384x384
(the scoring step's scenes), border 3, float32, for the forward and the
backward, L1 and L2: each result against this tree's plain twin (max
relative error; at 384x384 also the kernel's and the float32 plain
twin's distance from a float64 plain run), whether two runs agree bit for
bit, then ``--rounds`` rounds of the median of 20 single CUDA-event-timed
calls and of 20 calls queued back to back (device time, without the
host's launch latency, where the host enqueues faster than the card
runs), the host's time a call with 20 calls enqueued and no sync
(``host_ms``: ctypes, the output's allocation and the C entry's plan and
launch), and the kernels' own device time from a torch.profiler trace of
20 calls (``kernel_ms``); the bounds are ``tstack_roofline.shift_costs``'s.  A
tree whose launcher refuses a shape records ``"refused"``.  Run parent,
change, change, parent in one call.  ``--variant`` times the source with
the substitutions of ``VARIANTS`` (a phase or the staging taken out, p
not read); ``--sass`` keeps the library's SASS (cuobjdump) beside it.
Prints one JSON line and appends it to ``<out>/time_shift.jsonl``.  Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = ((128, 48), (16, 384))
BORDER = 3
REPS = 20
_P, _I = ctypes.c_void_p, ctypes.c_int


# name: ((text, replacement), ...) applied to shift_loss.cu: what a phase
# costs, by taking it out (the results are then wrong by design).
VARIANTS = {
    "kernel": (),
    "no_phase_a": (("sweep<0, BWD, SQ>(q, u, hm, pc, cst, part);", ""),),
    "no_phase_b": (("sweep<1, BWD, SQ>(q, u, hm, pc, cst, part);", ""),),
    "no_phase_c": (("sweep_dp<SQ>(q, u, hm, pc,", "if (0) sweep_dp<SQ>(q, u, "
                    "hm, pc,"),),
    "no_stage": (("    stage(q, u, hr, m, hm);\n", ""),),
    "p_const": (("__ldg(pp + r * q.W)", "1.f"), ("__ldg(pp + k)", "1.f")),
    "no_phases": (("sweep<0, BWD, SQ>(q, u, hm, pc, cst, part);", ""),
                  ("sweep<1, BWD, SQ>(q, u, hm, pc, cst, part);", ""),
                  ("sweep_dp<SQ>(q, u, hm, pc,", "if (0) sweep_dp<SQ>(q, u, "
                   "hm, pc,")),
    "qr16": (("constexpr int QR = 8;", "constexpr int QR = 16;"),),
}


def build(tree: str, out: str, label: str, variant: str = "kernel",
          sass: bool = False):
    """(library, seconds, ptxas lines) of the tree's shift_loss.cu, with
    ``variant``'s substitutions; with ``sass`` its SASS is written beside
    the library."""
    sys.path.insert(0, ROOT)
    from probav_tpu_torch.ops import _build
    csrc = os.path.join(tree, "probav_tpu_torch", "csrc")
    src = os.path.join(csrc, "shift_loss.cu")
    if variant != "kernel":
        text = open(src).read()
        for a, b in VARIANTS[variant]:
            if a not in text:
                raise ValueError(f"variant {variant}: {a!r} not in {src}")
            text = text.replace(a, b)
        src = os.path.join(out, f"shift_loss_{label}.cu")
        with open(src, "w") as f:
            f.write(text)
    lib = os.path.join(out, f"shift_loss_{label}.so")
    t0 = time.perf_counter()
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas",
                        "-v", "-I", csrc, "-shared", "-o", lib, src],
                       capture_output=True, text=True)
    if sass and r.returncode == 0:
        cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                                 "cuobjdump")
        with open(lib[:-3] + ".sass", "w") as f:
            subprocess.run([cuobjdump, "-sass", lib], stdout=f, text=True)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc {src}:\n{r.stderr}")
    so = ctypes.CDLL(lib)
    so.probav_shift_table_fwd.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    so.probav_shift_table_bwd.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    ptxas = [ln.strip() for ln in r.stderr.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    return so, secs, ptxas


def within(name, got, want):
    """chip_smoke's check on integer planes: |diff| <= rtol |ref| + atol
    max|ref| elementwise (``dyadic.SHIFT_TOL``)."""
    from probav_tpu_torch.tools.dyadic import SHIFT_TOL
    rtol, atol = SHIFT_TOL[name]
    lim = rtol * want.abs() + atol * float(want.abs().max())
    return bool(((got - want).abs() <= lim).all())


def profiled_ms(torch, call, reps=REPS):
    """Device ms per call of the kernels named shift_table* in a
    torch.profiler trace of ``reps`` calls back to back: the kernel's own
    time, where a back-to-back run of a kernel shorter than the host's
    enqueue times the host."""
    from probav_tpu_torch.tools.tstack_roofline import kernel_ms
    return sum(ms for k, ms in kernel_ms(torch, call, reps,
                                         need=("shift_table",)).items()
               if "shift_table" in k)


def host_ms(torch, call, reps=REPS):
    """Host ms per call of ``reps`` calls enqueued without a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    ap.add_argument("--variant", default="kernel", choices=VARIANTS)
    ap.add_argument("--sizes", default="48,384",
                    help="plane sizes to run, of 48 and 384")
    ap.add_argument("--sass", action="store_true",
                    help="write the library's SASS beside it")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_shift: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, ROOT)
    from probav_tpu_torch.ops import shift_table as st
    from probav_tpu_torch.tools.dyadic import shift_table_inputs
    from probav_tpu_torch.tools.tstack_roofline import (back_to_back,
                                                        card_line,
                                                        shift_costs, timed)

    so, secs, ptxas = build(os.path.abspath(args.tree), args.out, args.label,
                            args.variant, args.sass)
    sizes = {int(v) for v in args.sizes.split(",")}
    dev = torch.device("cuda", 0)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    result = {"tree": os.path.abspath(args.tree), "label": args.label,
              "variant": args.variant,
              "card": card_line(),
              "kind": torch.cuda.get_device_name(0), "build_s": secs,
              "ptxas": ptxas, "shapes": {}}
    for b, hw in SHAPES:
        if hw not in sizes:
            continue
        hr, m, p, g = shift_table_inputs(b, hw, BORDER, seed=7, device=dev)
        s = (2 * BORDER + 1) ** 2

        def fwd(sq):
            out = torch.empty((b, s), device=dev)
            err = so.probav_shift_table_fwd(
                hr.data_ptr(), m.data_ptr(), p.data_ptr(), out.data_ptr(), b,
                hw, hw, BORDER, int(sq), stream())
            return err, out

        def bwd(sq):
            dp = torch.empty_like(p)
            err = so.probav_shift_table_bwd(
                hr.data_ptr(), m.data_ptr(), p.data_ptr(), g.data_ptr(),
                dp.data_ptr(), b, hw, hw, BORDER, int(sq), stream())
            return err, dp

        f64 = [t.double() for t in (hr, m, p, g)]
        rows = {}
        if hasattr(so, "probav_shift_table_plan"):
            plan = (ctypes.c_int * 8)()
            so.probav_shift_table_plan.argtypes = [_I] * 4 + [
                ctypes.POINTER(_I)]
            if so.probav_shift_table_plan(b, hw, hw, BORDER, plan) == 0:
                rows["plan"] = dict(zip(("nb", "R", "RT", "CT", "NW", "P",
                                         "smem", "clusters"), plan))
        for name, call, plain, ins in (
                ("shift_table_fwd", fwd, st.shift_table_fwd_plain, 3),
                ("shift_table_bwd", bwd, st.shift_table_bwd_plain, 4)):
            cost = shift_costs(name, b, hw, BORDER)
            bms, by = cost["bound_ms"], cost["bound_by"]
            for sq in (False, True):
                key = f"{name} {'l2' if sq else 'l1'}"
                err, got = call(sq)
                torch.cuda.synchronize()
                if err != 0:
                    # A parent's launchers refused with cudaErrorInvalidValue.
                    rows[key] = ("refused" if err in (st._REFUSED, 1)
                                 else f"error {err}")
                    continue
                err2, again = call(sq)
                torch.cuda.synchronize()
                want = plain(*(hr, m, p, g)[:ins], BORDER, sq)
                ref = plain(*f64[:ins], BORDER, sq)
                dist = lambda a: float(((a.double() - ref).abs().max() /
                                        ref.abs().max()))
                row = {"max_rel_err": float(((got - want).abs() /
                                             want.abs().clamp_min(1e-30))
                                            .max()),
                       "kernel_f64": dist(got), "plain_f64": dist(want),
                       "within_tol": within(name, got, want),
                       "bitwise_repeat": bool(torch.equal(got, again)),
                       "bound_ms": bms, "bound_by": by, "single_ms": [],
                       "b2b_ms": [], "host_ms": []}
                for _ in range(args.rounds):
                    one, = timed(torch, lambda: call(sq), reps=REPS)
                    many, = back_to_back(torch, lambda: call(sq), n=REPS)
                    row["single_ms"].append(one)
                    row["b2b_ms"].append(many)
                    row["host_ms"].append(host_ms(torch, lambda: call(sq)))
                row["b2b_median_ms"] = statistics.median(row["b2b_ms"])
                row["kernel_ms"] = profiled_ms(torch, lambda: call(sq))
                rows[key] = row
        result["shapes"][f"B={b}, {hw}x{hw}, border {BORDER}"] = rows
        del hr, m, p, g, f64
        torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line, flush=True)
    with open(os.path.join(args.out, "time_shift.jsonl"), "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
