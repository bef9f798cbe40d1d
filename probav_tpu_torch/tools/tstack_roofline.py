"""The hand kernels' costs, and their roofline in real train steps on one
card (port of ``tools/tstack_roofline.py``, with the trace readers
``tools/trace_step.py``, ``trace_groups.py`` and ``trace_detail.py``).

    python3 -m probav_tpu_torch.tools.tstack_roofline [--cfg CFG] \\
        [--dtype float32|bf16] [--tier t|flat] [--kernel-loss] \\
        [--filters N] [--json OUT]
    python3 -m probav_tpu_torch.tools.tstack_roofline --trace PATH \\
        [--cfg CFG] [--dtype ...] [--filters N] [--json OUT]

**The costs.**  This module is the one copy of what each hand kernel must
do: ``kernel_costs`` (``seg_fwd``, ``conv_fwd``, ``blk_bwd``,
``wide_bwd``), ``blk_bwd_part_costs`` (its dd conv, wgrad, seg_bwd and
reduce), ``reduce_costs`` and ``shift_costs`` (both shift tables).  Each
is a pure function of the kernel, the dtype and the shapes: it builds
nothing and asks no route.  Bytes count each input read once and each
output written once.  ``flops`` counts each product once (what
``torch.utils.flop_counter`` counts over the plain twins); the bound
reads that work the same way whatever route runs it:

- a float32 product counts as 3xTF32, three products at the TF32 peak
  (the split that the float32 kernels use on the tensor cores, within the
  float32 tolerance that one TF32 product misses);
- a bf16 product counts once at the bf16 peak, and one with a float32
  operand (``wide_bwd``'s dz and relu(z)) three times, its operand split
  into three bf16 pieces;
- the reduce and the shift tables count float32 operations at the CUDA
  cores' peak.

``bound_ms`` is the larger of bytes over ``PEAK_BYTES`` and those
operations over their peak (``bound_by`` says which).  Beside it,
``cuda_core_ms`` is the bound were every product a float32 FMA on the
CUDA cores: the figure for a route that runs there (past 32/256/32 the
float32 ``seg_fwd``, ``seg_bwd``, ``wgrad`` and ``wide_bwd``; see the
routes in ``ops/tstack.py``).  It never replaces the bound.

**The roofline of a real step.**  ``step_roofline`` builds the cfg's
model and ``ModelTrainer`` as ``profile_train.make_trainer`` does
(synthetic batch, seed 0, the cfg's batch; float32 with TF32 off, as the
CLIs run it), takes warm-up steps, and profiles ``steps`` warm steps with
CPU and CUDA activity and the ops' input shapes (one step from the
command line); a capture in which a kernel that the caller names has
no device time is taken again (``capture_trace``, at most ``CAPTURES``
in all, as ``kernel_ms``).  ``read_trace`` files
each device event: a hand kernel by its name (``hand_kernel``), anything
else under the host op that launched it (the innermost one around its
launch, or the convolution op above that), with that op's input shapes.
``roofline`` then gives, per hand kernel and part: launches per step,
device ms per launch and per step, the bound per launch at the step's
shapes (``step_shapes``) and the share, bound / time.  A share above
``SHARE_LIMIT`` raises, naming the kernel: it means a count is wrong, and
no count is clipped to hide that.  The top ``TOP`` library groups follow,
by op and input shapes, with their kernel names, and for convolution ops
a bound from their shapes: 2 x output elements x C_in / groups x taps a
pass (forward, or each of the input and weight gradients that
``convolution_backward`` computes).  Totals: the device's busy ms a step
(the sum of its kernel, copy and memset time) and the shares of it in
hand kernels and in the library.  The trace's CPU activity slows the
host, so the idle share is not read here: ``profile_train`` reads it.

``--trace PATH`` reads a ``trace.json`` that the train CLI's
``--profile-dir`` wrote (``utils/profiling.py``: CUDA activity only, the
``TRACE_STEPS`` steps of the trainer's profile window): hand kernels by
name with their counts per step, the library's device time by kernel
name, since such a trace holds no ops or shapes.  Its bounds take the
shapes of ``--cfg`` / ``--filters`` and ``--dtype``.

Without ``--trace`` it needs a CUDA card.  Either mode prints one JSON
line (and a table on stderr); ``--json`` also writes it to a file.

Not ported: the JAX tool's small-dim-adjusted MXU bound, which charges a
dot by how much of the TPU's 128 x 128 systolic array its dimensions
fill.  That is a TPU concept; here every product counts at the peak of
its type, as above.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
from collections import defaultdict

# H100 SXM peaks (NVIDIA data sheet, dense): float32 on the CUDA cores,
# TF32 and bf16 on the tensor cores; device memory.
PEAK_FLOPS = {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# The H100's SMs: blk_bwd sums two partial slots an SM at C, C_dec <= 64
# (ops/tstack.partial_slots); wide_bwd's tensor-core kernels write one
# wave of one slot an SM.
SMS = 132
# A share above this means that a count is wrong.
SHARE_LIMIT = 1.05
# The library groups a report lists.
TOP = 10
# The steps of a --profile-dir trace (train/trainer.py's PROFILE_WINDOW).
TRACE_STEPS = 10
# The loss's shift window (ops/shift_loss.py's crop_border).
SHIFT_BORDER = 3
KERNELS = ("seg_fwd", "conv_fwd", "blk_bwd", "wide_bwd", "shift_table_fwd",
           "shift_table_bwd")
BLK_BWD_PARTS = ("dd conv", "wgrad", "seg_bwd", "reduce")


# ---------------------------------------------------------------------- #
# costs                                                                  #
# ---------------------------------------------------------------------- #

def bound(ops, nbytes, peak):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the operations at ``peak`` per second."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


_HOW = {"float32": "products as 3xTF32 (3 x FLOP at the TF32 peak)",
        "bfloat16": "products at the bf16 peak"}


def _row(flops, nbytes, dn, f32_operand=0, how=None):
    """The cost of ``flops`` FLOP of products (``f32_operand`` of them
    with a float32 operand at bf16) moving ``nbytes``, counted as the
    module docstring says."""
    if dn == "float32":
        ops, peak = 3 * flops, PEAK_FLOPS["tf32"]
    else:
        ops, peak = flops + 2 * f32_operand, PEAK_FLOPS["bfloat16"]
    how = how or _HOW[dn]
    ms, by = bound(ops, nbytes, peak)
    return dict(flops=flops, ops=ops, peak=peak, bytes=nbytes, bound_ms=ms,
                bound_by=by, how=how,
                cuda_core_ms=bound(flops, nbytes, PEAK_FLOPS["float32"])[0])


def _itemsize(dn):
    return 4 if dn == "float32" else 2


def kernel_costs(name, n, c, cmid, cdec, dn):
    """The cost of one launch of ``seg_fwd``, ``conv_fwd``, ``blk_bwd`` or
    ``wide_bwd`` at n rows of C channels, widths C_mid and C_dec, in dtype
    ``dn`` ("float32" or "bfloat16"): a dict of ``flops`` (products, once
    each), ``ops`` and ``peak`` (what the bound counts), ``bytes``,
    ``bound_ms``, ``bound_by``, ``how`` and ``cuda_core_ms``.  Biases and
    weight gradients are float32."""
    s = _itemsize(dn)
    if name == "seg_fwd":
        return _row(2 * n * (c * cmid + cmid * cdec),
                    s * (n * (c + cdec) + c * cmid + cmid * cdec) +
                    4 * (cmid + cdec), dn)
    if name == "conv_fwd":
        return _row(2 * n * 27 * cdec * c,
                    s * (n * (cdec + 2 * c) + 27 * cdec * c) + 4 * c, dn)
    if name == "blk_bwd":
        grads = 27 * cdec * c + c * cmid + cmid * cdec + cmid + cdec + c
        return _row(2 * n * (2 * 27 * cdec * c + cmid * (3 * c + 2 * cdec)),
                    s * (n * (3 * c + cdec) + c * cmid + cmid * cdec +
                         27 * cdec * c) + 4 * (cmid + grads), dn)
    if name == "wide_bwd":
        grads = c * cmid + cmid * cdec + cmid + cdec
        # z = x W1 and W2 dy multiply two working-dtype operands; dx = dz
        # W1^T, dW1 = x^T dz and dW2 = relu(z)^T dy have a float32 one.
        both, one = 2 * n * cmid * (c + cdec), 2 * n * cmid * (2 * c + cdec)
        return _row(both + one,
                    s * (n * (2 * c + cdec) + c * cmid + cmid * cdec) +
                    4 * (cmid + grads), dn, f32_operand=one,
                    how=None if dn == "float32" else
                    "products at the bf16 peak, dx, dW1 and dW2 three each "
                    "(a float32 dz or relu(z) split into three bf16 pieces)")
    raise ValueError(f"kernel_costs: no kernel {name!r}")


def reduce_costs(groups, length):
    """The cost of summing ``groups`` float32 slots of ``length`` floats
    into one (``reduce_partials_kernel``): one add a float read, on the
    CUDA cores."""
    flops, nbytes = groups * length, 4 * (groups + 1) * length
    ms, by = bound(flops, nbytes, PEAK_FLOPS["float32"])
    return dict(flops=flops, ops=flops, peak=PEAK_FLOPS["float32"],
                bytes=nbytes, bound_ms=ms, bound_by=by,
                how="float32 adds on the CUDA cores")


def blk_bwd_slot(c, cmid, cdec):
    """Floats of one of blk_bwd's partial slots: every weight gradient."""
    return 27 * cdec * c + c * cmid + cmid * cdec + cmid + cdec + c


def wide_bwd_slot(c, cmid, cdec):
    """Floats of one of wide_bwd's partial slots."""
    return c * cmid + cmid * cdec + cmid + cdec


def blk_bwd_part_costs(n, c, cmid, cdec, dn, groups=2 * SMS):
    """{part: cost} of one blk_bwd at n rows: the dd conv (the conv of
    ``conv_fwd`` without the residual), the weight gradient of the conv
    (wgrad), the expand/decay backward (seg_bwd), and the reduce of
    ``groups`` partial slots."""
    s = _itemsize(dn)
    conv = 2 * n * 27 * cdec * c
    return {
        "dd conv": _row(conv, s * (n * (c + cdec) + 27 * cdec * c), dn),
        "wgrad": _row(conv, s * n * (c + cdec) + 4 * 27 * cdec * c, dn),
        "seg_bwd": _row(2 * n * cmid * (3 * c + 2 * cdec),
                        s * (n * (3 * c + cdec) + c * cmid + cmid * cdec) +
                        4 * (cmid + c * cmid + cmid * cdec + cmid + cdec +
                             c), dn),
        "reduce": reduce_costs(groups, blk_bwd_slot(c, cmid, cdec))}


def shift_costs(name, b, hw, border):
    """The cost of one shift-table launch, float32 on the CUDA cores, at
    the least work the function needs.  Per pixel and shift the forward
    takes sum(p m) (2: a multiply-add), r = hr - (p + bias) m (3), and |r|
    or r^2 with its sum (2): 7 FLOP.  The backward takes sum(p m) (2); r,
    phi and sum(phi m) (6); then r, phi, (corr - phi) m and the shift's
    term into d/dpred (8): 16 FLOP.  The windows' sums of m and hr are box
    sums, not correlations: two summed-area tables a sample (4 FLOP per
    pixel of the plane), read at 6 FLOP a shift, with the bias (2) and the
    table's division (1) or the backward's constants (2) a shift.  Bytes:
    the three planes and the [B, S] table (forward) or the three planes,
    g and d/dpred (backward)."""
    s = (2 * border + 1) ** 2
    work = b * s * (hw - 2 * border) ** 2
    if name == "shift_table_fwd":
        flops = 7 * work + b * (4 * hw * hw + 9 * s)
        nbytes = 4 * (3 * b * hw * hw + b * s)
    elif name == "shift_table_bwd":
        flops = 16 * work + b * (4 * hw * hw + 10 * s)
        nbytes = 4 * (4 * b * hw * hw + b * s)
    else:
        raise ValueError(f"shift_costs: no kernel {name!r}")
    ms, by = bound(flops, nbytes, PEAK_FLOPS["float32"])
    return dict(flops=flops, ops=flops, peak=PEAK_FLOPS["float32"],
                bytes=nbytes, bound_ms=ms, bound_by=by,
                how="float32 on the CUDA cores")


def step_shapes(cfg, batch=None, filters=None):
    """The shapes a train step of the cfg's WDSR model gives its kernels:
    n rows (batch x LR input size^2 x T), the widths, the blocks, and the
    shift tables' (B, HR patch size, border)."""
    b = batch or cfg.batch_size
    f = filters or cfg.num_filters
    lr = cfg.lr_input_size
    return dict(n=b * lr * lr * cfg.num_low_res_imgs, c=f,
                cmid=f * cfg.exp_rate, cdec=int(f * cfg.decay_rate),
                blocks=cfg.num_res_blocks,
                shift=(b, cfg.hr_patch_size, SHIFT_BORDER))


def step_costs(shapes, dn):
    """{kernel: (cost, {part: cost})} of one launch of each hand kernel at
    a step's ``shapes`` (``step_shapes``)."""
    w = (shapes["n"], shapes["c"], shapes["cmid"], shapes["cdec"])
    wide = {"wide": kernel_costs("wide_bwd", *w, dn),
            "reduce": reduce_costs(SMS, wide_bwd_slot(*w[1:]))}
    out = {k: (kernel_costs(k, *w, dn), {})
           for k in ("seg_fwd", "conv_fwd")}
    out["blk_bwd"] = (kernel_costs("blk_bwd", *w, dn),
                      blk_bwd_part_costs(*w, dn))
    out["wide_bwd"] = (kernel_costs("wide_bwd", *w, dn), wide)
    for k in ("shift_table_fwd", "shift_table_bwd"):
        out[k] = (shift_costs(k, *shapes["shift"]), {})
    return out


# ---------------------------------------------------------------------- #
# kernel names                                                           #
# ---------------------------------------------------------------------- #

_NAME = re.compile(r"(\w+_kernel)\s*(?:<([^<>]*)>)?\s*\(")
_PARTS = {"seg_fwd_kernel": ("seg_fwd", None),
          "seg_fwd_mma_kernel": ("seg_fwd", None),
          "seg_fwd_tf32_kernel": ("seg_fwd", None),
          "seg_fwd_bf16_kernel": ("seg_fwd", None),
          "seg_fwd_tf32_wide_kernel": ("seg_fwd", None),
          "seg_fwd_bf16_wide_kernel": ("seg_fwd", None),
          "wgrad_kernel": ("blk_bwd", "wgrad"),
          "wgrad_ring_kernel": ("blk_bwd", "wgrad"),
          "wgrad_tf32_kernel": ("blk_bwd", "wgrad"),
          "wgrad_tiles_kernel": ("blk_bwd", "wgrad"),
          "wgrad_tf32_tiles_kernel": ("blk_bwd", "wgrad"),
          "seg_bwd_bf16_kernel": ("blk_bwd", "seg_bwd"),
          "seg_bwd_tf32_kernel": ("blk_bwd", "seg_bwd"),
          "seg_bwd_split_kernel": ("blk_bwd", "seg_bwd"),
          "dx_sum_kernel": ("blk_bwd", "seg_bwd"),
          "seg_bwd_tf32_split_kernel": ("blk_bwd", "seg_bwd"),
          "wide_bwd_bf16_kernel": ("wide_bwd", "wide"),
          "wide_bwd_tf32_kernel": ("wide_bwd", "wide"),
          # blk_bwd's or wide_bwd's last launch: read_trace decides.
          "reduce_partials_kernel": (None, "reduce")}


# Kernels that finish a part another kernel of it launched (dx_sum_kernel
# sums seg_bwd_split_kernel's or seg_bwd_tf32_split_kernel's parts of dx):
# their time counts to the part, their launches do not, so that a part
# has one launch a blk_bwd.
_TAILS = ("dx_sum_kernel",)


def is_tail(name: str) -> bool:
    """Whether a profiled kernel name is a part's tail (``_TAILS``)."""
    return any(m.group(1) in _TAILS for m in _NAME.finditer(name))


def hand_kernel(name: str):
    """(kernel, part) of a profiled kernel name of ``csrc/``, or None: the
    template argument tells ``conv_ring_kernel``'s two uses (the residual
    ``true`` is ``conv_fwd``, ``false`` blk_bwd's dd conv), the WIDE flag
    of ``seg_bwd_kernel`` (``true``: wide_bwd's) and the BWD flag of
    ``shift_table_kernel`` apart.  The reduce's kernel is None."""
    for m in _NAME.finditer(name):
        fn = m.group(1)
        args = [a.strip() for a in (m.group(2) or "").split(",")]
        if fn in _PARTS:
            return _PARTS[fn]
        if fn == "conv_ring_kernel":
            return ("conv_fwd", None) if args[-1] == "true" else \
                ("blk_bwd", "dd conv")
        if fn == "seg_bwd_kernel":
            return ("wide_bwd", "wide") if args[-1] == "true" else \
                ("blk_bwd", "seg_bwd")
        if fn == "shift_table_kernel":
            return ("shift_table_bwd", None) if args[0] == "true" else \
                ("shift_table_fwd", None)
    return None


def blk_bwd_part(name: str):
    """The part of blk_bwd a profiled kernel name belongs to, or None (the
    reduce is wide_bwd's too: read it where only blk_bwd runs)."""
    k = hand_kernel(name)
    return k[1] if k and k[0] in ("blk_bwd", None) else None


def t_kernel_of(name: str):
    """The "t" stack kernel a profiled kernel name belongs to, or None."""
    k = hand_kernel(name)
    if k is None:
        return None
    if k[0] in ("seg_fwd", "conv_fwd", "blk_bwd"):
        return k[0]
    return "blk_bwd" if k[1] == "reduce" else None


# ---------------------------------------------------------------------- #
# traces                                                                 #
# ---------------------------------------------------------------------- #

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
CONV_OPS = ("aten::convolution", "aten::convolution_backward")


def _launching_ops(events):
    """({correlation id: the innermost host op around the launch},
    {id(op): its parent op}), by nesting the host ops and runtime calls of
    each thread in time."""
    threads = defaultdict(list)
    for i, e in enumerate(events):
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in HOST_CATS:
            threads[(e.get("pid"), e.get("tid"))].append(
                (e["ts"], 0, -e.get("dur", 0), i, e))
        elif cat in RUNTIME_CATS and "correlation" in args:
            threads[(e.get("pid"), e.get("tid"))].append(
                (e["ts"], 1, 0, i, e))
    launched, parent = {}, {}
    for items in threads.values():
        items.sort(key=lambda t: t[:4])
        stack = []
        for ts, kind, _, _, e in items:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= ts:
                stack.pop()
            top = stack[-1] if stack else None
            if kind == 0:
                parent[id(e)] = top
                stack.append(e)
            else:
                launched[e["args"]["correlation"]] = top
    return launched, parent


def _group_op(op, parent):
    """The convolution op above ``op`` (or ``op`` itself), else ``op``."""
    o = op
    while o is not None:
        if o.get("name") in CONV_OPS:
            return o
        o = parent.get(id(o))
    return op


def _ints(text):
    return [int(v) for v in re.findall(r"-?\d+", text or "")]


def conv_cost(op):
    """The cost of a convolution op's passes from its recorded input
    shapes and values, counted as ``_row`` counts products, or None where
    the trace lacks them: ``aten::convolution`` (input, weight, bias,
    stride, padding, dilation, transposed, output_padding, groups),
    transposed or not, or
    ``aten::convolution_backward`` (grad_output, input, weight, ...,
    output_mask), a pass each of the input and weight gradients the mask
    asks for.  A pass is 2 x output elements x C_in / groups x taps;
    bytes: each pass's operands read once, its result written once."""
    args = op.get("args") or {}
    dims, vals = args.get("Input Dims"), args.get("Concrete Inputs")
    types = args.get("Input type") or []
    if not dims or not vals:
        return None
    dn = "bfloat16" if types and "BFloat16" in str(types[0]) else "float32"
    s = _itemsize(dn)
    numel = math.prod
    if op["name"] == "aten::convolution":
        inp, w = dims[0], dims[1]
        stride, pad, dil, _, opad = (_ints(v) for v in vals[3:8])
        if len(inp) != len(w):
            return None
        if vals[6] in ("False", "0"):
            out = [inp[0], w[0]] + [
                (i + 2 * p - d * (k - 1) - 1) // st + 1
                for i, k, st, p, d in zip(inp[2:], w[2:], stride, pad, dil)]
            flops, how = 2 * numel(out) * numel(w[1:]), "forward"
        else:
            # Transposed: weight [C_in, C_out / groups, taps]; each input
            # element meets C_out / groups x taps weights.
            groups = (_ints(vals[8]) or [1])[0]
            out = [inp[0], w[1] * groups] + [
                (i - 1) * st - 2 * p + d * (k - 1) + op_ + 1
                for i, k, st, p, d, op_ in zip(inp[2:], w[2:], stride, pad,
                                                dil, opad)]
            flops, how = 2 * numel(inp) * numel(w[1:]), "transposed"
        nbytes = s * (numel(inp) + numel(w) + numel(out))
        return _row(flops, nbytes, dn, how=f"{how}; {_HOW[dn]}")
    go, inp, w = dims[0], dims[1], dims[2]
    mask = [v == "True" for v in re.findall(r"True|False", vals[-1])]
    if len(mask) < 2:
        return None
    per = 2 * numel(go) * numel(w[1:])
    passes = [name for name, on in zip(("input", "weight"), mask) if on]
    nbytes = s * ((numel(go) + numel(w) + numel(inp)) * mask[0] +
                  (numel(go) + numel(inp) + numel(w)) * mask[1])
    return _row(per * len(passes), nbytes, dn,
                how=f"gradient of {' and '.join(passes) or 'nothing'}; "
                    f"{_HOW[dn]}")


def read_trace(events, steps):
    """Device time of a Chrome trace of ``steps`` steps: {"busy_ms",
    "steps", "hand": {kernel: {"launches", "ms", "names", "parts": {part:
    {"launches", "ms", "names"}}}}, "library": {key: {"op", "shapes",
    "launches", "ms", "kernels": {name: ms}, "conv": cost or None}}}, ms
    summed over the trace.  A library key is (op name, input shapes) of
    the op that launched it (``_group_op``), or ("kernel", name) where the
    trace holds no host op for it."""
    launched, parent = _launching_ops(events)
    hand = defaultdict(lambda: dict(launches=0, ms=0.0, names=set(),
                                    parts=defaultdict(lambda: dict(
                                        launches=0, ms=0.0, names=set()))))
    lib = {}
    busy = 0.0
    reduce = dict(launches=0, ms=0.0, names=set())
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        ms, name = e.get("dur", 0) / 1e3, e.get("name", "")
        busy += ms
        k = hand_kernel(name) if e.get("cat") == "kernel" else None
        if k is not None:
            kernel, part = k
            if kernel is None:
                slot = reduce
            else:
                h = hand[kernel]
                slot = h["parts"][part] if part else h
            slot["launches"] += 0 if is_tail(name) else 1
            slot["ms"] += ms
            slot["names"].add(name)
            continue
        op = launched.get((e.get("args") or {}).get("correlation"))
        op = _group_op(op, parent) if op is not None else None
        if op is None:
            key = ("kernel", name)
            g = lib.setdefault(key, dict(op=None, shapes=None, launches=0,
                                         ms=0.0, kernels={}, conv=None))
        else:
            dims = (op.get("args") or {}).get("Input Dims")
            key = (op["name"], json.dumps(dims))
            g = lib.setdefault(key, dict(
                op=op["name"], shapes=dims, launches=0, ms=0.0, kernels={},
                conv=conv_cost(op) if op["name"] in CONV_OPS else None,
                calls=set()))
            g["calls"].add(id(op))
        g["launches"] += 1
        g["ms"] += ms
        g["kernels"][name] = g["kernels"].get(name, 0.0) + ms
    if reduce["launches"]:
        owner = next((k for k in ("blk_bwd", "wide_bwd") if k in hand),
                     None)
        if owner is None:
            hand["reduce_partials"].update(reduce)
        else:
            p = hand[owner]["parts"]["reduce"]
            for key in ("launches", "ms"):
                p[key] += reduce[key]
            p["names"] |= reduce["names"]
    for h in hand.values():
        for p in h["parts"].values():
            h["ms"] += p["ms"]
            h["names"] |= p["names"]
        main = [p["launches"] for part, p in h["parts"].items()
                if part != "reduce"]
        if main:
            h["launches"] = min(main)
    for g in lib.values():
        g["calls"] = len(g.pop("calls", ())) or g["launches"]
    return dict(busy_ms=busy, steps=steps, hand=dict(hand), library=lib)


def _share(cost, ms_per_launch, what):
    share = cost["bound_ms"] / ms_per_launch if ms_per_launch > 0 else \
        float("inf")
    if share > SHARE_LIMIT:
        raise AssertionError(
            f"{what}: bound {cost['bound_ms']:.4f} ms over {ms_per_launch:.4f}"
            f" ms a launch is a share of {share:.3f} > {SHARE_LIMIT}: a count"
            " is wrong")
    return share


def roofline(trace, costs, top=TOP):
    """The report of a ``read_trace`` result against ``step_costs``:
    per hand kernel (and part) launches per step, device ms per launch and
    per step, the bound per launch and the share, bound / time (above
    ``SHARE_LIMIT`` raises, naming the kernel); the top ``top`` library
    groups by device time, with their kernel names and, for convolution
    ops, the bound of a call; the step's busy ms and its shares."""
    steps = trace["steps"]
    busy = trace["busy_ms"] / steps

    def line(what, h, cost):
        n = h["launches"]
        per = h["ms"] / n if n else 0.0
        out = dict(launches_per_step=n / steps, ms_per_step=h["ms"] / steps,
                   ms_per_launch=per, names=sorted(h["names"]))
        if cost is not None:
            out.update(bound_ms=cost["bound_ms"], bound_by=cost["bound_by"],
                       cuda_core_ms=cost.get("cuda_core_ms"),
                       share=_share(cost, per, what))
        return out

    hand, hand_ms = {}, 0.0
    for kernel, h in sorted(trace["hand"].items()):
        cost, parts = costs.get(kernel, (None, {}))
        row = line(kernel, h, cost)
        row["parts"] = {part: line(f"{kernel} {part}", p, parts.get(part))
                        for part, p in sorted(h["parts"].items())}
        hand[kernel] = row
        hand_ms += h["ms"] / steps
    groups = sorted(trace["library"].values(), key=lambda g: -g["ms"])
    library = []
    for g in groups[:top]:
        row = dict(op=g["op"], shapes=g["shapes"], ms_per_step=g["ms"] / steps,
                   launches_per_step=g["launches"] / steps,
                   calls_per_step=g["calls"] / steps,
                   kernels=sorted(((ms / steps, k) for k, ms
                                   in g["kernels"].items()), reverse=True))
        if g["conv"] is not None:
            per_call = g["ms"] / g["calls"]
            row.update(conv_flops=g["conv"]["flops"],
                       conv_how=g["conv"]["how"],
                       bound_ms=g["conv"]["bound_ms"],
                       bound_by=g["conv"]["bound_by"],
                       share=g["conv"]["bound_ms"] / per_call)
        library.append(row)
    return dict(steps=steps, device_busy_ms=busy, hand_ms=hand_ms,
                hand_share=hand_ms / busy if busy else 0.0,
                library_share=1 - hand_ms / busy if busy else 0.0,
                kernels=hand, library=library)


def load_trace(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


# ---------------------------------------------------------------------- #
# timing on the card                                                     #
# ---------------------------------------------------------------------- #

def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def timed(torch, *fns, reps=20):
    """Median CUDA-event ms of each of fns, after one warm-up call each;
    the functions run in turns, in reversed order every other round."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for i in range(reps):
        order = list(enumerate(fns))
        for j, fn in (order if i % 2 == 0 else order[::-1]):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times[j].append(s.elapsed_time(e))
    return [statistics.median(t) for t in times]


def back_to_back(torch, *fns, n=20):
    """CUDA-event ms per call of each of fns over n calls queued back to
    back, after one warm-up call: the device time, without the host's
    launch latency that a single timed call includes."""
    out = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / n)
    return out


CAPTURES = 3


def kernel_ms(torch, call, reps=10, need=(), profile=None, log=print):
    """{kernel name: device ms per round} of ``reps`` rounds of ``call``
    under the profiler (CUDA activity), after one round outside it.  Each
    string of ``need`` must be part of a name with device time ("" asks
    for any): a capture that lacks one is taken again, up to ``CAPTURES``
    in all, each extra one logged; if one never shows, RuntimeError.
    ``profile`` stands in for ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity
    if profile is None:
        from torch.profiler import profile
    call()
    torch.cuda.synchronize()
    for capture in range(1, CAPTURES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            if us > 0:
                out[e.key] = out.get(e.key, 0.0) + us / 1e3 / reps
        missing = [k for k in need if not any(k in name for name in out)]
        if not missing:
            return out
        if capture < CAPTURES:
            log(f"kernel_ms: capture {capture} of {CAPTURES} holds no device "
                f"time for {missing}; capturing again")
    raise RuntimeError(f"kernel_ms: {CAPTURES} captures held no device time "
                       f"for {missing} (found {sorted(out)})")


# ---------------------------------------------------------------------- #
# a real step                                                            #
# ---------------------------------------------------------------------- #

def capture_trace(run, cuda, need=(), profile=None, log=print):
    """Chrome trace events of ``run()`` under the profiler with CPU and
    (``cuda``) CUDA activity and the ops' input shapes.  Each kernel of
    ``need`` (as ``KERNELS`` names them) must have a launch with device
    time: a capture that lacks one is taken again, up to ``CAPTURES`` in
    all, each extra one logged; if one never shows, RuntimeError.
    ``profile`` stands in for ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity
    if profile is None:
        from torch.profiler import profile
    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    for capture in range(1, CAPTURES + 1):
        with profile(activities=acts, record_shapes=True) as prof:
            run()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            events = load_trace(path)
        have = {(hand_kernel(e.get("name", "")) or (None,))[0]
                for e in events if e.get("ph") == "X" and
                e.get("cat") == "kernel" and e.get("dur", 0) > 0}
        missing = [k for k in need if k not in have]
        if not missing:
            return events
        if capture < CAPTURES:
            log(f"capture_trace: capture {capture} of {CAPTURES} holds no "
                f"device time for {missing}; capturing again")
    raise RuntimeError(f"capture_trace: {CAPTURES} captures held no device "
                       f"time for {missing} (found {sorted(have - {None})})")


def trace_step(cfg, dtype, tier, device, use_kernel=False, loss=None,
               steps=1, warm=2, need=(), log=print):
    """Chrome trace events of ``steps`` warm train steps of the cfg's model
    (``profile_train.make_trainer``; its synthetic batch of the cfg's
    batch size, seed 0, on ``device``) after ``warm`` steps, captured by
    ``capture_trace`` (retried where a kernel of ``need`` has no device
    time)."""
    import torch

    from probav_tpu_torch.tools.profile_train import (make_trainer,
                                                      synthetic_batch)

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def run():
        for _ in range(steps):
            tr.train_step(*batch)
        sync()

    with tempfile.TemporaryDirectory() as tmp:
        tr = make_trainer(cfg, dtype, tier, device, tmp,
                          use_kernel=use_kernel, loss=loss)
        batch = tuple(torch.as_tensor(a, device=device)
                      for a in synthetic_batch(cfg.batch_size))
        for _ in range(warm):
            tr.train_step(*batch)
        sync()
        events = capture_trace(run, cuda, need=need, log=log)
        tr.logger_.close()
        return events


def step_roofline(cfg, dtype, tier, device="cuda", use_kernel=False,
                  loss=None, steps=1, warm=2, top=TOP, need=(), log=print):
    """``roofline`` of ``steps`` warm train steps (``trace_step``, which
    retries a capture without device time for a kernel of ``need``) at
    the cfg's shapes."""
    events = trace_step(cfg, dtype, tier, device, use_kernel=use_kernel,
                        loss=loss, steps=steps, warm=warm, need=need,
                        log=log)
    shapes = step_shapes(cfg)
    out = roofline(read_trace(events, steps), step_costs(shapes, dtype),
                   top=top)
    out.update(dtype=dtype, tier=tier, kernel_loss=use_kernel,
               loss=loss or cfg.loss, shapes=shapes)
    return out


def report_lines(rep):
    """Human-readable lines of a ``roofline`` report."""
    lines = [f"device busy {rep['device_busy_ms']:.3f} ms a step, hand "
             f"kernels {rep['hand_ms']:.3f} ms ({100 * rep['hand_share']:.1f}"
             f"%), library {100 * rep['library_share']:.1f}%"]
    for k, r in rep["kernels"].items():
        rows = [(k, r)] + [(f"  {k} {p}", q) for p, q in r["parts"].items()]
        for label, q in rows:
            b = (f", bound {q['bound_ms']:.4f} ms by {q['bound_by']}, share "
                 f"{q['share']:.3f}" if "share" in q else "")
            lines.append(f"{label}: x{q['launches_per_step']:g} a step, "
                         f"{q['ms_per_launch']:.4f} ms a launch, "
                         f"{q['ms_per_step']:.3f} ms a step{b}")
    for g in rep["library"]:
        b = (f"; conv {g['conv_flops'] / 1e9:.3f} GFLOP a call "
             f"({g['conv_how']}), bound {g['bound_ms']:.4f} ms, share "
             f"{g['share']:.4f}" if "share" in g else "")
        lines.append(f"library {g['ms_per_step']:.3f} ms a step, "
                     f"{g['op'] or 'kernel'} {g['shapes'] or ''} "
                     f"x{g['calls_per_step']:g}{b}: " + "; ".join(
                         f"{ms:.3f} {name[:90]}" for ms, name in
                         g["kernels"][:3]))
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", default="cfg/p16t9c85r12.cfg")
    p.add_argument("--dtype", default="bf16",
                   choices=("float32", "f32", "bf16", "bfloat16"))
    p.add_argument("--tier", default="t", choices=("t", "flat"))
    p.add_argument("--kernel-loss", action="store_true",
                   help="the loss and metric tables on the shift-table "
                        "kernels")
    p.add_argument("--filters", type=int,
                   help="num_filters (C_mid and C_dec follow the cfg's "
                        "rates)")
    p.add_argument("--trace", help="a trace.json of --profile-dir")
    p.add_argument("--json", help="also write the JSON line here")
    opt = p.parse_args(argv)
    from probav_tpu_torch.config import Config

    dn = "float32" if opt.dtype in ("float32", "f32") else "bfloat16"
    cfg = Config.from_file(opt.cfg)
    if opt.filters:
        cfg.flat["num_filters"] = opt.filters
    if opt.trace:
        rep = roofline(read_trace(load_trace(opt.trace), TRACE_STEPS),
                       step_costs(step_shapes(cfg), dn))
        rep.update(trace=opt.trace, dtype=dn, shapes=step_shapes(cfg))
    else:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("tstack_roofline needs a CUDA card (or --trace)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rep = step_roofline(cfg, dn, opt.tier, use_kernel=opt.kernel_loss)
        rep.update(card=card_line(), kind=torch.cuda.get_device_name(0))
    for ln in report_lines(rep):
        print(ln, file=sys.stderr, flush=True)
    line = json.dumps(rep)
    print(line, flush=True)
    if opt.json:
        with open(opt.json, "w") as f:
            f.write(line + "\n")
    return rep


if __name__ == "__main__":
    main()
