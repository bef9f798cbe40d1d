#!/usr/bin/env python3
"""Drive the PyTorch port's preprocessing, serving, scoring and training
paths on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its result:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the CUDA kernels of probav_tpu_torch/csrc, compiled with nvcc;
3. kernels: seg_fwd, conv_fwd, blk_bwd and wide_bwd against their plain
   PyTorch versions at the flagship shapes (128 patches of 22x22x9,
   channels 32/256/25: N = 557,568 rows) in float32 (TF32 off) and bf16,
   and the shift-table kernels (float32 only) at the train step's 128
   patches of 48x48 and the scoring step's 16 scenes of 384x384 (taken in
   clusters of row bands, whose plan is logged; single-call and
   back-to-back times at both), with median CUDA-event times of kernel, plain version
   and, where one PyTorch call computes the same function, that call
   (conv_fwd: F.conv3d, both also timed over 20 calls queued back to
   back, which leaves out the host's launch latency); the 64-filter widths
   (64/512/51) are checked for parity, and conv_fwd also at the shapes
   that its column runs opened: rows of 48 columns at the flagship widths
   and the 64-filter widths at T = 19; seg_fwd's log names the kernel its
   C entry routes each width to (at float32 the 3xTF32 tensor-core
   seg_fwd_tf32_kernel, which the flagship must take, the 3xTF32
   seg_fwd_tf32_wide_kernel (C_mid in chunks), which 64/512/51 and the
   width phase's 48/384/38 must take, and the CUDA-core seg_fwd_kernel,
   which its 72/576/57 and 128/1024/102 must take; at bf16
   seg_fwd_bf16_kernel, which the flagship must take,
   seg_fwd_bf16_wide_kernel (the weights staged once a block), which
   64/512/51 and the width phase's 48/384/38 must take, and
   seg_fwd_mma_kernel, which its 72/576/57 and 128/1024/102 must take;
   the bound is the same whatever the route, the CUDA cores'
   figure logged beside it); blk_bwd and wide_bwd are fed dyadic inputs (blk_bwd's log names the seg_bwd and the wgrad
   kernel its C entry routes each width to: the tensor-core seg_bwd at the
   flagship, seg_bwd_bf16_kernel at bf16 and the 3xTF32
   seg_bwd_tf32_kernel at float32; at 64/512/51 (and the width phase's
   48/384/38) seg_bwd_split_kernel with dx_sum_kernel at bf16 and the
   3xTF32 seg_bwd_tf32_split_kernel with dx_sum_kernel at float32;
   the tensor-core wgrad from 1 to 32 channels where its rows fit, up to
   64 in 32 x 32 channel tiles (wgrad_tiles_kernel at bf16, the 3xTF32
   wgrad_tf32_tiles_kernel at float32); the flagship must take both on
   the tensor cores at both dtypes, 64/512/51 and 48/384/38 the tiled and
   split ones at both dtypes, and every dtype at 72 and 128 filters the
   CUDA cores; at 64/512/51 on the train step's 128 patches, bf16 and
   float32 (TF32 off), also blk_bwd's outputs against plain, each part's
   device ms back to back beside its bound, and cuDNN's weight gradient
   of the same d and gy back to back beside the wgrad part; wide_bwd's
   log names its route: wide_bwd_bf16_kernel and the 3xTF32
   wide_bwd_tf32_kernel, which the bf16 and the float32 flagship must
   take, and seg_bwd_kernel on the CUDA cores, which both dtypes at
   64/512/51 and the width phase's widths must take; its bf16 bound counts
   the three bf16 products of each product with a float32 operand) and the
   shift tables integer planes (probav_tpu_torch/tools/dyadic.py), on
   which both versions take the same relu, sign and rounding decisions;
   the last launch of blk_bwd and wide_bwd, reduce_partials_kernel, is
   held to ``torch.sum(part[:G, :len], 0)`` over the same partial slots at
   both dtypes (its own C entry also at 7 slots of 31 floats, and on the
   entries' slots equal to their reduce bit for bit), and both are timed
   as device time in profiler traces: warm, the entry then torch.sum on
   the partials it just wrote and reduced; cold, an L2 scrub then the
   kernel's own entry, and the scrub then torch.sum (reduce_vs_sum; a
   trace that holds no device time for the kernels it names is taken
   again, up to 3 times: tstack_roofline.kernel_ms);
4. widths: the four block-stack kernels beyond the flagship's channels,
   at the widths of the 48-, 72- and 128-filter models (48/384/38,
   72/576/57, 128/1024/102) on 16 patches of 22x22x9, float32 (TF32 off)
   and bf16, against their plain versions with the kernel phase's
   tolerances (conv_fwd at 128/1024/102 also at T = 19; seg_fwd's route
   and blk_bwd's seg_bwd and wgrad routes named and checked: seg_fwd at
   48/384/38 on the wide tensor-core kernels of both dtypes, at 72 and
   128 filters on seg_fwd_mma_kernel and seg_fwd_kernel), with
   single-call times of kernel, plain version and F.conv3d; one float32
   train step of a 12-block 128-filter "t" model against its "off" twin
   at batch 32
   (loss, cPSNR, every gradient leaf), a bf16 forward of that model against
   "off", and the train CLI at 48 filters in bf16 with the "t" stack
   (blk_bwd launches per step, a falling loss);
5. model: the flagship cfg/p16t9c85r12.cfg model from a seeded init,
   535,267 parameters, forward of the kernel stack against the plain
   stack on 128 patches;
6. stack gradient: autograd through the 12-block kernel stack (forward
   kernels, blk_bwd backward) against autograd through the plain twins,
   float32 and bf16, every block parameter's gradient compared; at bf16
   also against blk_bwd_plain on the same forward, and, as a witness that
   the gap is rounding, against that chain in float32;
7. serve: ``probav_tpu_torch.serve.main()`` on a synthetic tree at bf16 and
   float32, with and without --tta, and --plain at both; PNG names, launch
   counts and the float32 kernel-vs-plain agreement (within one count) are
   checked.  Each CLI run is one cold run.  Then the scoring step:
   ``probav_tpu_torch.evaluate.main()`` on the card scores the float32
   output (benchmark) and the bf16 output (candidate) against a synthetic
   stage-2 NIR truth (the float32 output plus noise, 10% masked with its
   data kept): each scene's score against the same scorer on CPU tensors,
   the report's means, the pairing path (by position: the TEST ids lie
   outside the TRAIN ranges) and the scoring rates (the device scorer
   alone, with its transfers, evaluate.main end to end on the port's own
   unfiltered PNGs); and the kernel loss's cPSNR of the 16 served 384^2
   scenes: one shift_table_fwd launch, within 1e-5 of the unfold path;
8. warm resolve: ``Resolver.resolve_all`` at bf16 and float32, kernels and
   plain: the median and range of timed runs after a warm-up; and with
   the kernels at both dtypes ``Resolver.resolve_scene_tta`` of one scene
   of 8x8 patches, R = 20: equal to the bit to ``resolve_all([scene],
   tta=True)[0]``, 12 x 10 launches each of seg_fwd and conv_fwd (1280
   rows in chunks of 128), its warm ms a scene;
9. train: ``probav_tpu_torch.train`` (through ``main(argv)``) on a
   synthetic stage-5 tree at batch 128, bf16 and float32, with the "t"
   kernel stack, with ``--fused-stack flat`` and with --plain: launch
   counts (12 of each stack kernel per step with "t", 12 of wide_bwd with
   "flat", none with --plain), a falling loss, checkpoints, and a restart
   that resumes at the right step; then one float32 train step from the
   same init on the same batch for each of: the "t" stack, the "flat"
   stack, build_model(fused_block=True) and the "t" stack with the loss
   and metric on the shift-table kernels, each against its plain
   counterpart (loss, metric, gradients; for "t" also the parameters
   after the update); then the warm train throughput of the variants of
   probav_tpu_torch.tools.profile_train (which adds the device-time
   breakdown);
9a. train_device: the train CLI with --device-data (ModelTrainer.fit_device,
   the dataset on the card) at batch 128, bf16 and float32 "t" and float32
   "flat": launch counts, a falling loss, checkpoints, and a restart that
   resumes at the right step; fit and fit_device from the same init, seed
   and data (float32 "t", two chunks): their logged chunk losses agree;
   one chunk of fit_device (``_run_chunk``) under
   ``torch.cuda.set_sync_debug_mode("error")``: no host sync inside it;
   --remat's gradients on the float32 "off" tier against the stored ones,
   with both peak memories and step times, and with fused_block (12
   wide_bwd launches a step, gradients against fused_block alone);
   --profile-dir's trace of steps 10-19 names the three "t" kernels; and
   the window busy share of both loops at bf16 "t" (steps 10-19 traced
   with no sync between steps, tools/profile_train.loop_busy; its
   ``--loops`` mode also times the loops);
9b. mesh (--mesh-data, probav_tpu_torch.parallel): the train CLI's rank
   (``cli.rank_main``, which ``cli.main`` launches) with --mesh-data 1 on
   one NCCL rank, float32 "t" at batch 128 on the train phase's tree,
   against the same CLI in this process from the same init, both with
   cuDNN's deterministic algorithms: every logged value equal to the bit,
   the same checkpoints, 12 launches of each stack kernel a step; one
   fit_device chunk on that rank under
   ``torch.cuda.set_sync_debug_mode("error")``; the serve CLI with
   --mesh-data 1, its PNGs equal byte for byte to one process; then two
   gloo ranks on the one card (``parallel.launch(..., backend="gloo")``;
   NCCL takes one rank a card): one float32 "t" step of the flagship, 64
   of the 128 patches a rank, against the same step in this process (loss
   and cPSNR to 1e-5 relative, every gradient leaf within
   STACK_TOL["float32"], both ranks' parameters equal to the bit after the
   update), a fit_device chunk, ``Resolver.resolve_all`` with kernels on
   the 16 served scenes and with TTA on 2 against one process (equal or
   within one count, the differing pixels counted), each rank's launch
   counts, and the synced step time of two ranks beside one process's;
9c. mesh_model (--mesh-model, tensor parallelism of each block's expand /
   decay pair): wide_bwd at the widths a rank of a model group of 2 and
   4 runs it (32/128/25 and 32/64/25 over the flagship's 557,568 rows)
   against its plain version at both dtypes, with its tensor-core route,
   back-to-back times and bound; two gloo ranks of a (data 1, model 2)
   mesh sharing the card, the flagship at full width and batch 128, each
   rank holding 128 of C_mid 256: 3 float32 "flat" steps and one bf16
   "flat" step against one process's (losses, gradients at the start,
   the parameters' movement, within MODEL_MOVE_TOL and the tolerances
   beside it), 12 wide_bwd launches a step a rank, each rank's
   parameters its part of the gathered ones (the replicated ones equal
   to the bit), the synced step times and the all-reduce bytes a step
   by group; then the train CLI's ranks (``cli.rank_main`` with
   --mesh-data 1 --mesh-model 2, one epoch) and a resume of their last
   checkpoint in one process, each rank's parameters its part of that
   checkpoint to the bit;
9d. roofline (after the warm train throughput): one warm train step each
   of float32 "t" (l1), bf16 "t" with the kernel loss and bf16 "flat",
   traced with CPU and CUDA activity and input shapes
   (probav_tpu_torch.tools.tstack_roofline.step_roofline): every hand
   kernel found by name with its launches a step (12 of seg_fwd, conv_fwd
   and blk_bwd and of each of blk_bwd's four parts; 2 and 1 of the shift
   tables; 12 of wide_bwd and its reduce in the flat step), each one's
   in-step ms a launch beside its bound and the share (above 1.05 fails:
   a wrong count), the top library groups by op and input shapes and the
   largest with a dgrad kernel; then the 12-block kernel stack at the
   0.9411 model's 64/512/51 (tools/geom_sweep.run_width) at float32 and
   bf16 on 128 patches, its gradients held to the plain chain as in the
   stack gradient phase (6), its time, bound and routes logged; then warm
   bf16 and float32 train steps of that model at batch 128, "t" (12
   launches of each stack kernel a step) and "off" (none), median of 3
   each;
10. train, the other losses and models: the train CLI on the flagship cfg
   (float32, "t" stack, batch 128) with loss=sobel_l1_mix and with
   loss=l1msssim (12 launches of each stack kernel per step, a falling
   loss, a checkpoint), each loss and its gradient with respect to pred
   on 128 patches on the card against the CPU, and their warm steps and
   loss times beside the l1 step's; --modelType iwdsr at float32 and bf16
   (no kernel launched, a falling loss, a checkpoint, warm patches/s and
   peak memory, the float32 forward against the CPU); --modelType
   fusionNet on 2 x 12 served 384^2 TRAIN scenes (RED first) at batch 8,
   one warm FuseNet v3 step at 128 scenes of 384^2 with its time and peak
   memory, and the v1 and v2 forwards against the CPU;
10a. convergence: the bf16 convergence gate
   (probav_tpu_torch.tools.bf16_convergence) in this process, the
   flagship at 32 filters for 400 steps (402, whole epochs of 3) from one
   seeded init, three arms: float32 "off", bf16 "t" and bf16 "off" (the
   two "off" arms, which launch no hand kernel, train during the build,
   phase 2, as ``convergence_plain``); the
   bf16 arm within 0.1 dB of the float32 one in validation cPSNR
   (``delta_db``) and of the bf16 "off" one (``kernel_delta_db``), and on
   the "t" arm 12 launches of blk_bwd a step and of seg_fwd and conv_fwd
   a step and a validation batch (none on the "off" arms);
11. preprocess: a raw NIR tree written with the port's PNG writer (24
   train and 8 test scenes of 9-19 frames of 128^2, 384^2 HR, planted
   integer shifts within +-3 px); ``probav_tpu_torch.preprocess.main``
   with registration on the card, all five stages ('freq'): stage rates,
   one registration call per frame count and split, all on the card; the
   chain on its output: the train CLI (float32, "t" stack, one epoch at
   batch 128), the serve CLI --totest TRAIN without --params (the
   trainer's newest checkpoint) and ``evaluate.main`` against its stage-2
   TRAINimgHR (finite cPSNR of every scene), with the chain's wall time;
   stages 1-2 with the host backend (trimmed arrays equal to the card's);
   registration of the stage-1 scenes on the card (cold and warm) against
   the host, 'freq' and 'time': every shift equal and the planted one,
   'freq''s registered arrays equal; stages 1-2 with 'time' on the card;
12. rehearsal: ``python3 -m probav_tpu_torch.tools.full_rehearsal`` at
   1% of the ESA scene counts (RED 6 train and 2 test scenes, NIR 7 and
   2, of 9-19 frames of 128^2), the flagship net, one epoch: the port's
   four CLIs as subprocesses (preprocess NIR and RED with registration on
   the card; train --band BOTH at bf16 with --device-data and the "t"
   kernels; serve TEST and TRAIN for each band at bf16 with the kernels;
   evaluate on the TRAIN outputs): every stage's exit 0 and a peak RSS, a
   device-memory peak above 0 in the train and serve stages, a finite
   score; the report
   and the phase's seconds are logged.

Before each path runs, every kernel's launch count is set to 0; the counts
read after it are checked, and those of the path that runs a kernel are
its ``launches`` in the kernels' JSON summary, the line before the last.
Each phase's seconds are logged, and their sum.  Bounds
are tstack_roofline's costs (route-free; the CUDA cores' figure beside).
The last line is {"ok": true, "device": {...}}.  Any failure raises, and
the script exits non-zero without that line.  Without CUDA it exits 1 at
once.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from probav_tpu_torch.tools.dyadic import SHIFT_TOL
from probav_tpu_torch.tools.geom_sweep import rel_l2, stack_inputs
from probav_tpu_torch.tools.tstack_roofline import (back_to_back,
                                                    blk_bwd_part_costs,
                                                    card_line, kernel_costs,
                                                    kernel_ms, load_trace,
                                                    reduce_costs,
                                                    shift_costs,
                                                    t_kernel_of, timed,
                                                    wide_bwd_slot)

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
SCENE_TTA_REPEATS = 20
WARM_REPEATS = 3
# The scoring step: a synthetic stage-2 truth, the f32 serve output plus
# Gaussian noise of SCORE_NOISE counts, SCORE_HIDDEN of its pixels masked
# with their data kept; the card's scores against the same scorer on CPU
# tensors within the JAX scorer's bound (tests/test_eval_scorer.py).
SCORE_NOISE, SCORE_HIDDEN = 300.0, 0.1
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-4
# blk_bwd on dyadic inputs (same relu and rounding decisions in both
# versions, so only summation order differs): dx 2e-5 of max|ref| at
# float32 (as the forward kernels), one bf16 step (2**-8) plus margin at
# bf16, where dx is stored in bf16; the seven outputs' weight grads are
# float32 sums of identical operands over 557,568 rows in another order:
# 1e-4 relative at both dtypes.
BWD_TOL = {"float32": 2e-5, "bfloat16": 8e-3}
BWD_GRAD_TOL = 1e-4
BWD_NAMES = ("dx", "dwc", "dw1", "db1", "dw2", "db2", "dbc")
WIDE_NAMES = ("dx", "dw1", "db1", "dw2", "db2")
# Stack gradients through 12 blocks with random weights, as a norm-wise
# relative error ||got - ref|| / ||ref|| per leaf.
# - float32, against autograd through the plain twins (their own forward).
#   The two forwards differ by summation order (~1e-6 relative, growing
#   over the blocks), so a z within that of zero takes the other relu-
#   derivative branch in the backward: ~1e-6 of a block's 143 million z
#   values, each moving one dz element by a whole (W2 dd).  The sums over
#   557,568 rows then move by about sqrt(flips / (N / 2)) of their norm,
#   ~1.5e-3 for db1 (the per-kernel checks, on dyadic inputs, take no such
#   branch): 5e-3.
# - bf16, against blk_bwd_plain chained over the same forward activations
#   (x_i, d_i of the kernel forward).  An independent bf16 forward differs
#   by bf16 roundings, ~1e-2 relative, which flips ~1% of the relu
#   derivatives and moves db1 by ~10% (measured 0.106, printed below as
#   the independent comparison, held only to 0.25 against wiring faults);
#   on the same forward only summation order differs, but each block's
#   dx is rounded to bf16 (2**-8) in both after sums in another order, so
#   the cotangent reaching the first blocks differs by an ulp on many
#   elements; the bias gradients (db2 = sum of dd over 557,568 rows) sum
#   such elements with cancellation, so their norm-wise error is about
#   one ulp of an element, not of the sum (measured 1.08e-2 for block 0's
#   db2): 3e-2.  The witness that this gap is rounding: blk_bwd_plain
#   chained in float32 over the same forward (no bf16 rounding point) is
#   a reference from which the kernel and the bf16 plain chain must stand
#   equally far, leaf by leaf; a kernel fault of the gap's size would put
#   the kernel further off: at most 1.5x the plain chain's distance, plus
#   1e-4 for leaves that neither rounds.
# The same bound holds the flat and fused_block stacks against the plain
# one and, at float32 on one train step, the kernel loss against the
# unfold loss: there a residual within a rounding of 0 may take the other
# L1 sign, moving one pixel's d/dpred by 2 / (B * N_clear).
STACK_TOL = {"float32": 5e-3, "bfloat16": 3e-2}
STACK_BF16_INDEPENDENT_TOL = 0.25
STACK_BF16_WITNESS = (1.5, 1e-4)
# The shift tables on integer planes, held to dyadic.SHIFT_TOL; B = 128
# patches of 48x48, border 3.
SHIFT_B, SHIFT_HW, SHIFT_BORDER = 128, 48, 3
# ... and the scoring step's 16 scenes of 384x384, checked and timed beside
# them (the JSON row is the train step's shape).
SHIFT_SHAPES = ((SHIFT_B, SHIFT_HW), (16, 384))
# The train phase: 768 training patches (6 steps of 128 per epoch), 160
# validation patches (a full batch and a ragged one of 32).
TRAIN_N, VAL_N, TRAIN_EPOCHS = 768, 160, 4
WARM_TRAIN_STEPS = 3
# conv_fwd parity beyond the flagship volume: (label, [B, H, W, T], c_dec,
# C), the shapes the column runs of its ring opened.
CONV_ENVELOPE = (("W=48", (16, 22, 48, 9), CDEC, C),
                 ("64/512/51 T=19", (16, 22, 22, 19), 51, 64))
# The width phase: (C, C_mid, C_dec) of the 48-, 72- and 128-filter models
# (exp_rate 8, decay_rate 0.8) on WIDTH_PATCHES patches; the 12-block
# model at WIDE_FILTERS in float32 at WIDE_BATCH (its "off" twin saves 12
# blocks' wide activations, ~20 GB at batch 32); the train CLI at
# CLI_FILTERS.
WIDTHS = ((48, 384, 38), (72, 576, 57), (128, 1024, 102))
WIDTH_PATCHES, WIDE_FILTERS, WIDE_BATCH, CLI_FILTERS = 16, 128, 32, 48
# Single-call timings of the width phase's backward kernels: 3 a kernel,
# cut from 10 to pay for the 64-filter parts and steps at both dtypes.
WIDTH_REPS = 3


def log(msg):
    print(msg, flush=True)


def kernel_modules():
    from probav_tpu_torch.ops import shift_table, tstack, wide_block
    return tstack, wide_block, shift_table


def reset_launches():
    for mod in kernel_modules():
        mod.reset_launches()


def launches():
    """The launch count of every kernel since the last reset."""
    return {k: v for mod in kernel_modules() for k, v in mod.LAUNCHES.items()}


def expect(**counts):
    """The launch counts of every kernel: ``counts``, and 0 for the rest."""
    return {k: counts.get(k, 0) for k in launches()}


def check(name, got, ref, tol):
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    if not np.isfinite(err) or err > tol * scale:
        raise AssertionError(f"{name}: max|diff| {err:.3e} > {tol:g} * "
                             f"max|ref| {scale:.3e}")
    return err, scale


def bound_text(cost):
    """A cost of tstack_roofline as a log: the bound, what bounds it, how
    it counts, and the CUDA cores' figure where it has one."""
    cores = (f"; on the CUDA cores {cost['cuda_core_ms']:.4f} ms"
             if "cuda_core_ms" in cost else "")
    return (f"{cost['bound_ms']:.4f} ms by {cost['bound_by']} ({cost['how']}"
            f"{cores}; {cost['flops'] / 1e9:.3f} GFLOP, "
            f"{cost['bytes'] / 1e6:.1f} MB)")


def seg_fwd_route(dn, c, cmid, cdec):
    """The kernel seg_fwd runs at these widths in dtype ``dn``, as its C
    entry chooses it (ops/tstack.seg_fwd_route)."""
    import torch

    from probav_tpu_torch.ops import tstack as ts
    return ts.seg_fwd_route(getattr(torch, dn), c, cmid, cdec)


def wide_seg_route(dn, c, cmid, cdec):
    """Beyond 32/256/32 (where seg_fwd_bf16_kernel's route ends), up to
    64/512/64 bf16 seg_fwd takes seg_fwd_bf16_wide_kernel and float32
    seg_fwd_tf32_wide_kernel; beyond, bf16 seg_fwd_mma_kernel and float32
    seg_fwd_kernel; raises otherwise."""
    from probav_tpu_torch.ops import tstack as ts
    wide = c <= 64 and cmid <= 512 and cdec <= 64
    if dn == "bfloat16":
        want = ts.SEG_FWD_ROUTES[5 if wide else 1]
    else:
        want = ts.SEG_FWD_ROUTES[4 if wide else 0]
    route = seg_fwd_route(dn, c, cmid, cdec)
    if route != want:
        raise AssertionError(f"seg_fwd {dn} {c}/{cmid}/{cdec} route "
                             f"{route}, expected {want}")


def wide_cuda_core_route(dtype, c, cmid, cdec):
    """Beyond 32/256/32 wide_bwd keeps seg_bwd_kernel on the CUDA cores at
    both dtypes (the routes of wide_bwd_bf16_kernel and
    wide_bwd_tf32_kernel end there); raises otherwise."""
    from probav_tpu_torch.ops import wide_block as wb
    route = wb.wide_bwd_route(dtype, c, cmid, cdec)
    if route != wb.WIDE_BWD_ROUTES[0]:
        raise AssertionError(f"wide_bwd {dtype} {c}/{cmid}/{cdec} route "
                             f"{route}, expected {wb.WIDE_BWD_ROUTES[0]}")


def wide_blk_bwd_routes(dtype, c, cmid, cdec):
    """Beyond 32/256/32 blk_bwd's seg_bwd and wgrad take the tensor cores
    up to C, C_dec <= 64 and C_mid <= 512 at both dtypes (bf16:
    seg_bwd_split_kernel with dx_sum_kernel, wgrad_tiles_kernel; float32:
    seg_bwd_tf32_split_kernel with dx_sum_kernel,
    wgrad_tf32_tiles_kernel; the wgrads in 32 x 32 channel tiles), and the
    CUDA cores beyond; raises otherwise."""
    import torch

    from probav_tpu_torch.ops import tstack as ts
    code = 3 if dtype == torch.bfloat16 else 4
    mma = max(c, cdec) <= 64 and cmid <= 512
    want = (ts.SEG_BWD_ROUTES[code if mma else 0],
            ts.WGRAD_ROUTES[code if mma else 0])
    got = (ts.seg_bwd_route(dtype, c, cmid, cdec),
           ts.wgrad_route(dtype, c, cdec, HW, T))
    if got != want:
        raise AssertionError(f"blk_bwd {dtype} {c}/{cmid}/{cdec} seg_bwd and "
                             f"wgrad routes {got}, expected {want}")


# blk_bwd's parts at the 64-filter model's widths on the train step's
# rows, by dtype: (part, the kernel its trace must name, the kernel it
# replaced).
WIDE_PARTS = {
    "bfloat16": (("seg_bwd", "seg_bwd_split_kernel", "seg_bwd_kernel"),
                 ("wgrad", "wgrad_tiles_kernel", "wgrad_kernel")),
    "float32": (("seg_bwd", "seg_bwd_tf32_split_kernel", "seg_bwd_kernel"),
                ("wgrad", "wgrad_tf32_tiles_kernel", "wgrad_kernel"))}


def wide_blk_bwd_parts(torch, ts, dev, card, dn):
    """blk_bwd in dtype ``dn`` at 64/512/51 on N_PATCH patches (the
    64-filter train step's rows): its seven outputs on dyadic inputs
    against plain, then the device ms of each part from a profiler trace
    of 10 calls back to back beside its bound, the whole call back to
    back, and cuDNN's weight gradient of the same d and gy back to back
    (the library call that computes the wgrad part; TF32 off at
    float32)."""
    from probav_tpu_torch.tools.dyadic import blk_bwd_inputs
    from probav_tpu_torch.tools.time_conv import library_calls, profile_parts

    c, cmid, cdec = 64, 512, 51
    n = N_PATCH * HW * HW * T
    shape = f"N={n}, {c}/{cmid}/{cdec}"
    args = blk_bwd_inputs((N_PATCH, HW, HW, T), c, cmid, cdec, seed=12,
                          device=dev, dtype=getattr(torch, dn))
    tol_of = lambda k: BWD_TOL[dn] if k == "dx" else BWD_GRAD_TOL
    errs = check_outputs(f"blk_bwd {dn} [{shape}]", BWD_NAMES,
                         ts.blk_bwd(*args), ts.blk_bwd_plain(*args), tol_of)
    parts = profile_parts(lambda: ts.blk_bwd(*args))
    costs = blk_bwd_part_costs(n, c, cmid, cdec, dn,
                               ts.partial_slots(dev, c, cdec))
    kb, lib = back_to_back(torch, lambda: ts.blk_bwd(*args),
                           library_calls(*args)["wgrad"])
    msg = []
    for part, kernel, before in WIDE_PARTS[dn]:
        ms, names = parts[part]
        if not any(kernel in k for k in names):
            raise AssertionError(f"blk_bwd {shape} {dn} {part}: kernels "
                                 f"{names}, expected {kernel}")
        cost = costs[part]
        msg.append(f"{part} ({kernel}, was {before}) {ms:.4f} ms, bound "
                   f"{cost['bound_ms']:.4f} ms by {cost['bound_by']}, share "
                   f"{cost['bound_ms'] / ms:.3f}")
    log(f"kernel blk_bwd {dn} [{shape}]: max|diff| " + ", ".join(
        f"{k} {e:.3e}" for k, e in zip(BWD_NAMES, errs)) + "; parts back to "
        "back, device time a call: " + "; ".join(msg) + "; " + "; ".join(
            f"{p} {ms:.4f} ms" for p, (ms, _) in parts.items()
            if p not in ("seg_bwd", "wgrad")) + f"; whole call {kb:.4f} ms "
        f"back to back; cuDNN weight gradient of the same d, gy {lib:.4f} ms "
        f"back to back [{card}]")
    del args
    torch.cuda.empty_cache()


def check_outputs(label, names, got, want, tol_of):
    """check() each named output pair, with its shape and dtype; returns
    the max|diff| of each."""
    errs = []
    for name, a, b in zip(names, got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{label} {name}: {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        errs.append(check(f"{label} {name}", a, b, tol_of(name))[0])
    return errs


def check_rel(name, got, ref, rtol, atol_frac):
    """Elementwise |got - ref| <= rtol |ref| + atol_frac max|ref|; returns
    max|diff|."""
    diff = (got - ref).abs()
    lim = rtol * ref.abs() + atol_frac * float(ref.abs().max())
    if not bool(diff.isfinite().all()) or bool((diff > lim).any()):
        k = int((diff - lim).nan_to_num(float("inf")).argmax())
        raise AssertionError(f"{name}: |diff| {float(diff.flatten()[k]):.3e}"
                             f" at ref {float(ref.flatten()[k]):.6e} beyond "
                             f"rtol {rtol:g}, atol {atol_frac:g} max|ref|")
    return float(diff.max())


# reduce_partials_kernel (blk_bwd's last launch) against torch.sum over the
# same partials: float32 sums of 2 x SMs slots in another order.
REDUCE_TOL = 1e-5


L2_SCRUB_BYTES = 256 << 20   # > the H100's 50 MB L2


def reduce_vs_sum(torch, ts, bwd_args, wide_args, dn, card):
    """reduce_partials_kernel, the last launch of blk_bwd's and wide_bwd's
    C entries, against ``torch.sum(part[:G, :len], 0)``, the one PyTorch
    call computing its function.  First the kernel's own C entry
    (``tstack.reduce_partials``) on random normal partials at an odd shape
    (7 slots of 31 floats).  Then each C entry is called with partial
    slots of our own (``tstack.slot_stride`` apart, NaN before the first
    call, so a slot the reduce must not read would show): torch.sum over
    the slots it wrote (all G for blk_bwd; wide_bwd's tensor-core kernels
    write one wave, one block an SM) held to the entry's output, and the
    kernel's own entry on the same slots equal to it bit for bit.  Device
    times from profiler traces: warm, 10 rounds of the entry then torch.sum
    (the kernel reads the partials that the entry's earlier launches just
    wrote, as on the main path, and torch.sum reads them right after it);
    cold, 10 rounds of an L2 scrub (a 256 MiB read and write) then the
    kernel's own entry, and of the scrub then torch.sum (partials in DRAM
    only).  Each time is logged beside the reduce's DRAM bound, 4 (G + 1)
    len bytes at 3.35 TB/s; a time slower than torch.sum's in the same
    regime is logged as missed, not failed."""
    from probav_tpu_torch.ops import _build

    dev = bwd_args[1].device
    r = np.random.default_rng(23)
    odd = torch.full((7, ts.slot_stride(31)), float("nan"), device=dev)
    odd[:, :31] = torch.from_numpy(r.normal(size=(7, 31)).astype(
        np.float32)).to(dev)
    before = ts.LAUNCHES["reduce_partials"]
    got = ts.reduce_partials(odd, 31)
    torch.cuda.synchronize()
    if ts.LAUNCHES["reduce_partials"] != before + 1:
        raise AssertionError("reduce_partials: no launch counted")
    err, scale = check(f"reduce_partials [G=7 x 31] {dn}", got,
                       torch.sum(odd[:, :31], 0), REDUCE_TOL)
    log(f"kernel reduce_partials [G=7 x 31, stride {odd.shape[1]}]: its C "
        f"entry against torch.sum max|diff| {err:.3e} (max|ref| "
        f"{scale:.3e}, tol {REDUCE_TOL:g}); plan (tiles, ranks, warps, "
        f"clusters held) {ts.reduce_plan(7, 31)}")

    lib = _build.library()
    code = ts._DTYPE_CODE[bwd_args[1].dtype]
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gy, x, d, w1, b1, w2, wc = bwd_args
    b, h, w, t, c = x.shape
    c_mid, c_dec = w2.shape
    w1c, w2c = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
    b1c = b1.float().contiguous()
    wflip = wc.to(x.dtype).flip(0, 1, 2).transpose(3, 4).contiguous()
    dd, dx = torch.empty(d.shape, dtype=x.dtype, device=dev), \
        torch.empty_like(x)
    groups = ts.partial_slots(dev, c, c_dec)
    slot = 27 * c_dec * c + c * c_mid + c_mid * c_dec + c_mid + c_dec + c
    part = torch.full((groups, ts.slot_stride(slot)), float("nan"),
                      device=dev)
    out = torch.empty(slot, dtype=torch.float32, device=dev)

    def blk_entry():
        _build.check(lib.probav_blk_bwd(
            code, gy.data_ptr(), x.data_ptr(), d.data_ptr(),
            wflip.data_ptr(), w1c.data_ptr(), b1c.data_ptr(),
            w2c.data_ptr(), dd.data_ptr(), dx.data_ptr(), part.data_ptr(),
            out.data_ptr(), None, groups, part.shape[1], b, h, w, t, c,
            c_mid, c_dec, stream), "blk_bwd")

    xw, w1w, b1w, w2w, dyw = wide_args
    n, cw = xw.shape
    wmid, wdec = w2w.shape
    w1wc, w2wc = w1w.to(xw.dtype).contiguous(), w2w.to(xw.dtype).contiguous()
    b1wc = b1w.float().contiguous()
    dxw = torch.empty_like(xw)
    wgroups = ts.partial_slots(dev, cw, wdec)
    wslot = cw * wmid + wmid * wdec + wmid + wdec
    wpart = torch.full((wgroups, ts.slot_stride(wslot)), float("nan"),
                       device=dev)
    wout = torch.empty(wslot, dtype=torch.float32, device=dev)

    def wide_entry():
        _build.check(lib.probav_wide_bwd(
            code, xw.data_ptr(), w1wc.data_ptr(), b1wc.data_ptr(),
            w2wc.data_ptr(), dyw.data_ptr(), dxw.data_ptr(),
            wpart.data_ptr(), wout.data_ptr(), wgroups, wpart.shape[1], n,
            cw, wmid, wdec, stream), "wide_bwd")

    scrub = torch.zeros(L2_SCRUB_BYTES // 4, dtype=torch.float32,
                        device=dev)
    scrub_l2 = lambda: scrub.add_(1.0)
    bcost = blk_bwd_part_costs(b * h * w * t, c, c_mid, c_dec, dn,
                               groups)["reduce"]
    # wide_bwd's tensor-core kernels hold one block an SM: one wave of
    # min(G, SMs) blocks writes that many slots.
    used = min(wgroups, sms)
    cases = (("blk_bwd", blk_entry, part, out, groups, slot,
              bcost["bound_ms"]),
             ("wide_bwd", wide_entry, wpart, wout, used, wslot,
              reduce_costs(used, wide_bwd_slot(cw, wmid, wdec))["bound_ms"]))
    for label, entry, buf, res, g, length, bound_ms in cases:
        entry()
        torch.cuda.synchronize()
        plain = lambda: torch.sum(buf[:g, :length], 0)
        own = lambda: ts.reduce_partials(buf[:g], length)
        err, scale = check(f"torch.sum of {label}'s partials {dn}", res,
                           plain(), REDUCE_TOL)
        if not torch.equal(own(), res):
            raise AssertionError(f"reduce_partials of {label}'s partials "
                                 f"{dn}: its C entry differs from the "
                                 "entry's own reduce")
        # torch.sum's kernels by name; a name that the entry or the scrub
        # also launches (a memset) cannot be told apart in a trace and is
        # left out.  Each capture names the kernels it must hold (kernel_ms
        # captures again where one has no device time).
        red = "reduce_partials_kernel"
        sum_all = set(kernel_ms(torch, plain, need=("",)))
        shared = sum_all & (set(kernel_ms(torch, entry, need=(red,))) |
                            set(kernel_ms(torch, scrub_l2, need=("",))))
        sum_names = tuple(sorted(sum_all - shared))
        if not sum_names:
            raise AssertionError(f"reduce_partials {label} {dn}: torch.sum "
                                 f"launched no kernel of its own ({sum_all})")
        warm = kernel_ms(torch, lambda: (entry(), plain()),
                         need=(red,) + sum_names)
        cold_k = kernel_ms(torch, lambda: (scrub_l2(), own()), need=(red,))
        cold_s = kernel_ms(torch, lambda: (scrub_l2(), plain()),
                           need=sum_names)
        ours = lambda tr: sum(ms for k, ms in tr.items() if red in k)
        kw, kc = ours(warm), ours(cold_k)
        sw = sum(warm.get(k, 0.0) for k in sum_names)
        sc = sum(cold_s.get(k, 0.0) for k in sum_names)
        if not (kw and kc and sw and sc):
            raise AssertionError(f"reduce_partials {label} {dn}: no device "
                                 f"time in the trace (kernel {kw}, {kc}, "
                                 f"torch.sum {sw}, {sc})")
        verdict = lambda k, s_: "held" if k <= s_ else "missed"
        log(f"kernel reduce_partials {dn} [{label}: G={g} x {length}, "
            f"stride {buf.shape[1]}; plan (tiles, ranks, warps, clusters "
            f"held) {ts.reduce_plan(g, length)}]: torch.sum against the "
            f"kernel's output max|diff| {err:.3e} (max|ref| {scale:.3e}, "
            f"tol {REDUCE_TOL:g}); its own C entry equal to the bit; device "
            f"time (profiler, 10 rounds): warm, the kernel in the entry "
            f"{kw:.4f} ms, torch.sum right after it {sw:.4f} ms (no slower: "
            f"{verdict(kw, sw)}); after an L2 scrub, the kernel {kc:.4f} ms "
            f"({kc / bound_ms:.2f}x bound), torch.sum {sc:.4f} ms (no "
            f"slower: {verdict(kc, sc)}); bound {bound_ms:.4f} ms by bytes "
            f"(left out, shared: {sorted(shared)}) [{card}]")
    del scrub


def phase_kernels(torch, ts, dev, card):
    """Parity and times of the six kernels; returns {(name, dtype): row}
    with the numbers of the JSON summary."""
    import torch.nn.functional as F

    from probav_tpu_torch.ops import shift_table as st
    from probav_tpu_torch.ops import wide_block as wb
    from probav_tpu_torch.tools.dyadic import (blk_bwd_inputs,
                                               shift_table_inputs,
                                               wide_bwd_inputs)

    n = N_PATCH * HW * HW * T
    rows = {}

    def row(name, dn, err, ms, pms, lms, cost=None, shape=None):
        cost = cost or kernel_costs(name, n, C, CMID, CDEC, dn)
        rows[(name, dn)] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                library_ms=lms, bound_ms=cost["bound_ms"],
                                bound_by=cost["bound_by"])
        lib = "none" if lms is None else f"{lms:.4f} ms"
        log(f"kernel {name} {dn} [{shape or f'N={n}, {C}/{CMID}/{CDEC}'}]: "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms, library call {lib}, "
            f"bound {bound_text(cost)} [{card}]")

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        x, (w1, b1, w2, b2, wc, bc) = stack_inputs(
            torch, dev, dtype, N_PATCH, C, CMID, CDEC, seed=1)
        x2 = x.reshape(-1, C)
        d = ts.seg_fwd(x2, w1, b1, w2, b2)
        torch.cuda.synchronize()
        err, scale = check(f"seg_fwd {dn}", d,
                           ts.seg_fwd_plain(x2, w1, b1, w2, b2), TOL[dn])
        route = seg_fwd_route(dn, C, CMID, CDEC)
        log(f"kernel seg_fwd {dn}: max|diff| {err:.3e} (max|ref| "
            f"{scale:.3e}, tol {TOL[dn]:g}); route {route}")
        want_route = ts.SEG_FWD_ROUTES[3 if dn == "bfloat16" else 2]
        if route != want_route:
            raise AssertionError(f"seg_fwd {dn} route {route}, expected "
                                 f"{want_route}")
        pms, ms = timed(torch, lambda: ts.seg_fwd_plain(x2, w1, b1, w2, b2),
                        lambda: ts.seg_fwd(x2, w1, b1, w2, b2))
        row("seg_fwd", dn, err, ms, pms, None)

        d5 = d.reshape(x.shape[:-1] + (CDEC,))
        out = ts.conv_fwd(d5, x, wc, bc)
        torch.cuda.synchronize()
        err, scale = check(f"conv_fwd {dn}", out,
                           ts.conv_fwd_plain(d5, x, wc, bc), TOL[dn])
        log(f"kernel conv_fwd {dn}: max|diff| {err:.3e} (max|ref| "
            f"{scale:.3e}, tol {TOL[dn]:g})")
        pms, ms = timed(torch, lambda: ts.conv_fwd_plain(d5, x, wc, bc),
                        lambda: ts.conv_fwd(d5, x, wc, bc))
        # The library call: one cuDNN conv in the working dtype with bias,
        # on channels-last input (no residual add).
        dcl = d5.permute(0, 4, 1, 2, 3)                    # NDHWC storage
        wcl = wc.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        lms, = timed(torch, lambda: F.conv3d(dcl, wcl, bc, padding=1))
        row("conv_fwd", dn, err, ms, pms, lms)
        kb, lb = back_to_back(torch, lambda: ts.conv_fwd(d5, x, wc, bc),
                              lambda: F.conv3d(dcl, wcl, bc, padding=1))
        log(f"kernel conv_fwd {dn}: back to back, per call: kernel "
            f"{kb:.4f} ms, library call {lb:.4f} ms [{card}]")

        # blk_bwd: the seven outputs on dyadic inputs (see BWD_TOL).
        args = blk_bwd_inputs((N_PATCH, HW, HW, T), C, CMID, CDEC, seed=3,
                              device=dev, dtype=dtype)
        tol_of = lambda k: BWD_TOL[dn] if k == "dx" else BWD_GRAD_TOL
        got = ts.blk_bwd(*args)
        torch.cuda.synchronize()
        errs = check_outputs(f"blk_bwd {dn}", BWD_NAMES, got,
                             ts.blk_bwd_plain(*args), tol_of)
        wroute = ts.wgrad_route(dtype, C, CDEC, HW, T)
        sroute = ts.seg_bwd_route(dtype, C, CMID, CDEC)
        log(f"kernel blk_bwd {dn}: max|diff| " + ", ".join(
            f"{k} {e:.3e}" for k, e in zip(BWD_NAMES, errs)) +
            f" (tol dx {BWD_TOL[dn]:g}, grads {BWD_GRAD_TOL:g} of max|ref|);"
            f" seg_bwd route {sroute}, wgrad route {wroute}")
        # The flagship takes the tensor cores in both: seg_bwd_bf16_kernel
        # / wgrad_ring_kernel at bf16, seg_bwd_tf32_kernel /
        # wgrad_tf32_kernel at float32.
        for part, got_route, routes in (("seg_bwd", sroute,
                                         ts.SEG_BWD_ROUTES),
                                        ("wgrad", wroute, ts.WGRAD_ROUTES)):
            want_route = routes[1 if dn == "bfloat16" else 2]
            if got_route != want_route:
                raise AssertionError(f"blk_bwd {dn} {part} route "
                                     f"{got_route}, expected {want_route}")
        pms, ms = timed(torch, lambda: ts.blk_bwd_plain(*args),
                        lambda: ts.blk_bwd(*args), reps=10)
        row("blk_bwd", dn, errs[0], ms, pms, None)
        del got
        bwd_args = args

        # wide_bwd: its five outputs on dyadic inputs, the tolerances of
        # blk_bwd (see BWD_TOL).
        args = wide_bwd_inputs(n, C, CMID, CDEC, seed=5, device=dev,
                               dtype=dtype)
        got = wb.wide_bwd(*args)
        torch.cuda.synchronize()
        errs = check_outputs(f"wide_bwd {dn}", WIDE_NAMES, got,
                             wb.wide_bwd_plain(*args), tol_of)
        wroute = wb.wide_bwd_route(dtype, C, CMID, CDEC)
        log(f"kernel wide_bwd {dn}: max|diff| " + ", ".join(
            f"{k} {e:.3e}" for k, e in zip(WIDE_NAMES, errs)) +
            f" (tol dx {BWD_TOL[dn]:g}, grads {BWD_GRAD_TOL:g} of max|ref|);"
            f" route {wroute}")
        # The flagship takes the tensor cores: wide_bwd_bf16_kernel at
        # bf16, wide_bwd_tf32_kernel at float32.
        want_route = wb.WIDE_BWD_ROUTES[1 if dn == "bfloat16" else 2]
        if wroute != want_route:
            raise AssertionError(f"wide_bwd {dn} route {wroute}, expected "
                                 f"{want_route}")
        pms, ms = timed(torch, lambda: wb.wide_bwd_plain(*args),
                        lambda: wb.wide_bwd(*args), reps=10)
        row("wide_bwd", dn, errs[0], ms, pms, None)
        reduce_vs_sum(torch, ts, bwd_args, args, dn, card)
        del got, args, bwd_args

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
        args = blk_bwd_inputs((16, HW, HW, T), 64, 512, 51, seed=4,
                              device=dev, dtype=dtype)
        e3 = check_outputs(f"blk_bwd 64/512/51 {dn}", BWD_NAMES,
                           ts.blk_bwd(*args), ts.blk_bwd_plain(*args),
                           tol_of)
        args = wide_bwd_inputs(16 * HW * HW * T, 64, 512, 51, seed=6,
                               device=dev, dtype=dtype)
        e4 = check_outputs(f"wide_bwd 64/512/51 {dn}", WIDE_NAMES,
                           wb.wide_bwd(*args), wb.wide_bwd_plain(*args),
                           tol_of)
        log(f"kernel parity at 64/512/51 {dn}: seg_fwd {e1:.3e}, conv_fwd "
            f"{e2:.3e}, blk_bwd " + ", ".join(
                f"{k} {e:.3e}" for k, e in zip(BWD_NAMES, e3)) +
            ", wide_bwd " + ", ".join(
                f"{k} {e:.3e}" for k, e in zip(WIDE_NAMES, e4)) +
            f"; seg_fwd route {seg_fwd_route(dn, 64, 512, 51)}"
            f"; blk_bwd seg_bwd route {ts.seg_bwd_route(dtype, 64, 512, 51)}"
            f", wgrad route {ts.wgrad_route(dtype, 64, 51, HW, T)}"
            f"; wide_bwd route {wb.wide_bwd_route(dtype, 64, 512, 51)}")
        del args
        wide_seg_route(dn, 64, 512, 51)
        wide_cuda_core_route(dtype, 64, 512, 51)
        wide_blk_bwd_routes(dtype, 64, 512, 51)
        wide_blk_bwd_parts(torch, ts, dev, card, dn)
        for label, shape, cd, co in CONV_ENVELOPE:
            g = torch.Generator(device=dev).manual_seed(11)
            rn = lambda *s, sc=1.0: (torch.randn(s, generator=g, device=dev)
                                     * sc).to(dtype)
            d5, x = rn(*shape, cd), rn(*shape, co)
            wc, bc = rn(3, 3, 3, cd, co, sc=(27 * cd) ** -0.5), rn(co, sc=0.1)
            err, scale = check(f"conv_fwd {label} {dn}",
                               ts.conv_fwd(d5, x, wc, bc),
                               ts.conv_fwd_plain(d5, x, wc, bc), TOL[dn])
            log(f"kernel conv_fwd {dn} [{label}: {list(shape)}, {cd} -> "
                f"{co}]: max|diff| {err:.3e} (max|ref| {scale:.3e}, tol "
                f"{TOL[dn]:g})")
        del d5, x
        torch.cuda.empty_cache()

    # The shift tables, float32 only: both kinds checked on integer planes
    # (see SHIFT_TOL) at both shapes; the L1 kind, the train step's loss,
    # timed, one call at a time and back to back.
    for b, hw in SHIFT_SHAPES:
        hr, m, p, g = shift_table_inputs(b, hw, SHIFT_BORDER, seed=7,
                                         device=dev)
        shape = f"B={b}, {hw}x{hw}, border {SHIFT_BORDER}"
        log(f"kernel shift tables [{shape}]: plan "
            f"{st.card_plan(b, hw, hw, SHIFT_BORDER)}")
        calls = {"shift_table_fwd": (st.shift_table_fwd,
                                     st.shift_table_fwd_plain, (hr, m, p)),
                 "shift_table_bwd": (st.shift_table_bwd,
                                     st.shift_table_bwd_plain,
                                     (hr, m, p, g))}
        for name, (kern, plain, ins) in calls.items():
            rtol, atol = SHIFT_TOL[name]
            errs = {}
            for sq in (False, True):
                got = kern(*ins, SHIFT_BORDER, sq)
                torch.cuda.synchronize()
                errs[sq] = check_rel(f"{name} {'l2' if sq else 'l1'} "
                                     f"[{shape}]", got,
                                     plain(*ins, SHIFT_BORDER, sq), rtol,
                                     atol)
            log(f"kernel {name} [{shape}]: max|diff| l1 {errs[False]:.3e}, "
                f"l2 {errs[True]:.3e} (rtol {rtol:g}, atol {atol:g} "
                f"max|ref|)")
            call = lambda: kern(*ins, SHIFT_BORDER, False)
            pms, ms = timed(torch, lambda: plain(*ins, SHIFT_BORDER, False),
                            call)
            cost = shift_costs(name, b, hw, SHIFT_BORDER)
            row(name, "float32" if hw == SHIFT_HW else f"float32 {hw}^2",
                max(errs.values()), ms, pms, None, cost=cost, shape=shape)
            kb, = back_to_back(torch, call)
            log(f"kernel {name} [{shape}]: back to back, per call: kernel "
                f"{kb:.4f} ms, single call {ms:.4f} ms, bound "
                f"{cost['bound_ms']:.4f} ms [{card}]")
        del hr, m, p, g
        torch.cuda.empty_cache()
    return rows


def phase_widths(torch, ts, dev, card):
    """The width phase (module docstring, 4)."""
    import torch.nn.functional as F

    from probav_tpu_torch.config import Config
    from probav_tpu_torch.models.wdsr import build_model
    from probav_tpu_torch.ops import wide_block as wb
    from probav_tpu_torch.tools.dyadic import blk_bwd_inputs, wide_bwd_inputs
    from probav_tpu_torch.tools.profile_train import (make_trainer,
                                                      synthetic_batch)
    from probav_tpu_torch.train import cli

    n = WIDTH_PATCHES * HW * HW * T
    vol = (WIDTH_PATCHES, HW, HW, T)

    def report(name, dn, widths, err, ms, pms, lms=None):
        lib = "none" if lms is None else f"{lms:.4f} ms"
        log(f"width {name} {dn} [N={n}, {'/'.join(map(str, widths))}]: "
            f"max|diff| {err:.3e}; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
            f"library call {lib}, bound "
            f"{bound_text(kernel_costs(name, n, *widths, dn))} [{card}]")

    for widths in WIDTHS:
        c, cmid, cdec = widths
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            tol_of = lambda k: BWD_TOL[dn] if k == "dx" else BWD_GRAD_TOL
            x, (w1, b1, w2, b2, wc, bc) = stack_inputs(
                torch, dev, dtype, WIDTH_PATCHES, c, cmid, cdec, seed=20)
            x2 = x.reshape(-1, c)
            reset_launches()
            d = ts.seg_fwd(x2, w1, b1, w2, b2)
            torch.cuda.synchronize()
            err, _ = check(f"width seg_fwd {widths} {dn}", d,
                           ts.seg_fwd_plain(x2, w1, b1, w2, b2), TOL[dn])
            pms, ms = timed(torch,
                            lambda: ts.seg_fwd_plain(x2, w1, b1, w2, b2),
                            lambda: ts.seg_fwd(x2, w1, b1, w2, b2))
            report("seg_fwd", dn, widths, err, ms, pms)
            log(f"width seg_fwd {dn} [{'/'.join(map(str, widths))}]: route "
                f"{seg_fwd_route(dn, *widths)}")
            wide_seg_route(dn, *widths)

            d5 = d.reshape(x.shape[:-1] + (cdec,))
            err, _ = check(f"width conv_fwd {widths} {dn}",
                           ts.conv_fwd(d5, x, wc, bc),
                           ts.conv_fwd_plain(d5, x, wc, bc), TOL[dn])
            dcl = d5.permute(0, 4, 1, 2, 3)
            wcl = wc.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            pms, ms, lms = timed(
                torch, lambda: ts.conv_fwd_plain(d5, x, wc, bc),
                lambda: ts.conv_fwd(d5, x, wc, bc),
                lambda: F.conv3d(dcl, wcl, bc, padding=1))
            report("conv_fwd", dn, widths, err, ms, pms, lms)
            del d, d5, dcl, x, x2
            if c == WIDE_FILTERS:   # T = 19 at the widest bucket
                g = torch.Generator(device=dev).manual_seed(21)
                rn = lambda *s_, sc=1.0: (torch.randn(
                    s_, generator=g, device=dev) * sc).to(dtype)
                shape = (WIDTH_PATCHES, HW, HW, 19)
                d19, x19 = rn(*shape, cdec), rn(*shape, c)
                err, _ = check(f"width conv_fwd T=19 {widths} {dn}",
                               ts.conv_fwd(d19, x19, wc, bc),
                               ts.conv_fwd_plain(d19, x19, wc, bc), TOL[dn])
                log(f"width conv_fwd {dn} [{list(shape)}, {cdec} -> {c}]: "
                    f"max|diff| {err:.3e} (tol {TOL[dn]:g} of max|ref|)")
                del d19, x19

            args = blk_bwd_inputs(vol, c, cmid, cdec, seed=22, device=dev,
                                  dtype=dtype)
            errs = check_outputs(f"width blk_bwd {widths} {dn}", BWD_NAMES,
                                 ts.blk_bwd(*args), ts.blk_bwd_plain(*args),
                                 tol_of)
            pms, ms = timed(torch, lambda: ts.blk_bwd_plain(*args),
                            lambda: ts.blk_bwd(*args), reps=WIDTH_REPS)
            report("blk_bwd", dn, widths, max(errs), ms, pms)
            log(f"width blk_bwd {dn} [{'/'.join(map(str, widths))}]: "
                f"seg_bwd route {ts.seg_bwd_route(dtype, *widths)}, wgrad "
                f"route {ts.wgrad_route(dtype, widths[0], widths[2], HW, T)}")
            wide_blk_bwd_routes(dtype, *widths)
            args = wide_bwd_inputs(n, c, cmid, cdec, seed=23, device=dev,
                                   dtype=dtype)
            errs = check_outputs(f"width wide_bwd {widths} {dn}", WIDE_NAMES,
                                 wb.wide_bwd(*args), wb.wide_bwd_plain(*args),
                                 tol_of)
            pms, ms = timed(torch, lambda: wb.wide_bwd_plain(*args),
                            lambda: wb.wide_bwd(*args), reps=WIDTH_REPS)
            report("wide_bwd", dn, widths, max(errs), ms, pms)
            log(f"width wide_bwd {dn} [{'/'.join(map(str, widths))}]: route "
                f"{wb.wide_bwd_route(dtype, *widths)}")
            wide_cuda_core_route(dtype, *widths)
            del args
            counts = launches()
            if any(counts[k] <= 0 for k in ("seg_fwd", "conv_fwd", "blk_bwd",
                                            "wide_bwd")):
                raise AssertionError(f"width {widths} {dn}: launches {counts}")
            torch.cuda.empty_cache()

    # The 12-block WIDE_FILTERS model: one float32 train step of "t"
    # against "off" (held as phase_train_step holds them), then a bf16
    # forward of each.
    cfg = Config.from_file(CFG)
    cfg.flat["num_filters"] = WIDE_FILTERS
    batch = tuple(torch.as_tensor(a, device=dev)
                  for a in synthetic_batch(WIDE_BATCH, seed=2))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tier in ("off", "t"):
            tr = make_trainer(cfg, "float32", tier, dev,
                              os.path.join(tmp, tier))
            grads = tr.loss_and_grads(*batch)[2]
            reset_launches()
            loss, metric = tr.train_step(*batch)
            torch.cuda.synchronize()
            out[tier] = dict(loss=float(loss), metric=float(metric),
                             grads=grads, counts=launches())
            tr.logger_.close()
            del tr, grads
            torch.cuda.empty_cache()
    a, b = out["t"], out["off"]
    if a["counts"] != expect(**STEP_KERNELS) or b["counts"] != expect():
        raise AssertionError(f"width model step: launches {a['counts']}, "
                             f"off {b['counts']}")
    gerr = {k: rel_l2(a["grads"][k], b["grads"][k]) for k in a["grads"]}
    gk = max(gerr, key=lambda k: gerr[k] if np.isfinite(gerr[k]) else np.inf)
    msg = (f"width model: 12 blocks, {WIDE_FILTERS} filters, one f32 train "
           f"step at batch {WIDE_BATCH}, t vs off: loss {a['loss']:.6f} vs "
           f"{b['loss']:.6f}; cPSNR {a['metric']:.4f} vs {b['metric']:.4f}; "
           f"gradients of {len(gerr)} leaves, worst ||got-ref||/||ref|| {gk} "
           f"{gerr[gk]:.3e} (tol {STACK_TOL['float32']:g})")
    if not abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]) or \
            not abs(a["metric"] - b["metric"]) <= 1e-4 or \
            not gerr[gk] <= STACK_TOL["float32"]:
        raise AssertionError(msg)
    log(f"{msg} [{card}]")
    del out, a, b
    outs = {}
    for tier in ("t", "off"):
        m = build_model(cfg, "NIR", dtype=torch.bfloat16, fused_stack=tier,
                        generator=torch.Generator().manual_seed(0)).to(dev)
        with torch.inference_mode():
            outs[tier] = m.eval()(batch[0]).float()
        del m
    err, scale = check("width model bf16", outs["t"], outs["off"],
                       MODEL_TOL["bfloat16"])
    log(f"width model bf16: {WIDE_FILTERS} filters, kernel stack vs plain "
        f"stack on {WIDE_BATCH} patches max|diff| {err:.3e} (max|ref| "
        f"{scale:.3e}, tol {MODEL_TOL['bfloat16']:g}) [{card}]")
    del outs, batch
    torch.cuda.empty_cache()

    # The train CLI at CLI_FILTERS filters, bf16, "t" stack.
    steps_per_epoch, val_batches = TRAIN_N // 128, -(-VAL_N // 128)
    epochs = TRAIN_EPOCHS // 2
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path, _, log_dir = write_train_tree(tmp, "w48", epochs,
                                                num_filters=CLI_FILTERS)
        reset_launches()
        t0 = time.perf_counter()
        res = cli.main(["--cfg", cfg_path, "--band", "NIR", "--eval-step",
                        str(steps_per_epoch), "--device", str(dev), "--bf16",
                        "--fused-stack", "t"])["NIR"]
        wall = time.perf_counter() - t0
        got = launches()
        steps = epochs * steps_per_epoch
        evals = (epochs + 1) * val_batches
        want = expect(seg_fwd=12 * (steps + evals),
                      conv_fwd=12 * (steps + evals), blk_bwd=12 * steps)
        losses = train_losses(log_dir)
        if res["steps"] != steps or got != want or \
                not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"train CLI at {CLI_FILTERS} filters: "
                                 f"{res['steps']} steps, launches {got} "
                                 f"(expected {want}), losses {losses}")
    log(f"train CLI bf16 t at {CLI_FILTERS} filters: {steps} steps at batch "
        f"128, launches {got} ({got['blk_bwd'] // steps} blk_bwd per step); "
        f"train loss {losses[0]:.3f} -> {losses[-1]:.3f}; {wall:.1f} s cold "
        f"[{card}]")


def chain_blk_bwd_plain(ts, gy, xs, ds, blocks, dtype):
    """[dx, then per block dw1, db1, dw2, db2, dwc, dbc]: blk_bwd_plain
    chained from the last block to the first over the saved forward
    activations xs, ds, every operand cast to dtype (float32 leaves no
    bf16 rounding point), each gradient returned in its leaf's dtype."""
    g, out = gy.to(dtype), [None] * (6 * len(blocks))
    for i in reversed(range(len(blocks))):
        w1, b1, w2, b2, wc, bc = (t.to(dtype) for t in blocks[i])
        g, dwc, dw1, db1, dw2, db2, dbc = ts.blk_bwd_plain(
            g, xs[i].to(dtype), ds[i].to(dtype), w1, b1, w2, wc)
        out[6 * i:6 * i + 6] = [t.to(gy.dtype) if dtype == gy.dtype else t
                                for t in (dw1, db1, dw2, db2, dwc, dbc)]
    return [g] + out


def hold_stack_grad(torch, ts, label, got, plain, case, card):
    """Hold the kernel stack's gradients ``got`` of the stack ``case`` (x,
    blocks, gy) to autograd through the plain stack (``plain``) and, at
    bf16, to blk_bwd_plain chained over the kernel forward with the
    float32 chain as the witness (see STACK_TOL); logs the result."""
    x, blocks, gy = case
    dn = str(x.dtype).split(".")[1]
    names = ["x"] + [f"{i}.{k}" for i in range(len(blocks))
                     for k in ("w1", "b1", "w2", "b2", "wc", "bc")]

    def worst(got, want):
        errs = {k: rel_l2(a, b) for k, a, b in zip(names, got, want)}
        k = max(errs, key=lambda n: errs[n] if np.isfinite(errs[n])
                else np.inf)
        return k, errs[k]

    indep = worst(got, plain)
    msg = (f"{label} {dn}: {len(blocks)} blocks, {x.shape[0]} patches, "
           f"{len(names)} leaves; worst ||got-ref||/||ref|| against "
           f"autograd through the plain stack {indep[0]} {indep[1]:.3e}")
    if x.dtype == torch.float32:
        key, err, tol = *indep, STACK_TOL[dn]
    else:
        if not indep[1] <= STACK_BF16_INDEPENDENT_TOL:
            raise AssertionError(msg)
        # blk_bwd_plain over the kernel forward's x_i and d_i, in the
        # working dtype and, as the witness, in float32.
        with torch.no_grad():
            bl = [[t.detach() for t in blk] for blk in blocks]
            _, xs, ds = ts.stack_forward(x.detach(), bl, keep=True)
            want = chain_blk_bwd_plain(ts, gy, xs, ds, bl, x.dtype)
            exact = chain_blk_bwd_plain(ts, gy, xs, ds, bl, torch.float32)
            del xs, ds
        key, err = worst(got, want)
        ratio, floor = STACK_BF16_WITNESS
        e_k = {k: rel_l2(a, b) for k, a, b in zip(names, got, exact)}
        e_p = {k: rel_l2(a, b) for k, a, b in zip(names, want, exact)}
        off = [k for k in names if not e_k[k] <= ratio * e_p[k] + floor]
        wk = max(e_k, key=e_k.get)
        msg += (f" (tol {STACK_BF16_INDEPENDENT_TOL:g}); against "
                f"blk_bwd_plain on the same forward {key} {err:.3e}; "
                f"witness, against the float32 chain: kernel worst {wk} "
                f"{e_k[wk]:.3e} (plain bf16 there {e_p[wk]:.3e}), "
                f"largest ratio kernel/plain "
                f"{max(e_k[k] / max(e_p[k], 1e-30) for k in names):.3f}")
        if off:
            raise AssertionError(
                f"{msg}: kernel beyond {ratio:g} x plain + {floor:g} "
                "at " + ", ".join(f"{k} {e_k[k]:.3e} vs {e_p[k]:.3e}"
                                  for k in off[:6]))
        tol = STACK_TOL[dn]
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"{msg}: {key} {err:.3e} > {tol:g}")
    log(f"{msg} (tol {tol:g}) [{card}]")


def hold_stack_kernels(torch, ts, dev, card, label, dtype, c, cmid, cdec):
    """Autograd through the 12-block kernel stack at c/cmid/cdec on
    N_PATCH patches: 12 launches of each stack kernel, and the gradients
    held to the plain stack by hold_stack_grad."""
    from probav_tpu_torch.tools import geom_sweep as gs

    dn = str(dtype).split(".")[1]
    case = gs.stack_case(torch, dev, dtype, c, cmid, cdec, N_PATCH)
    reset_launches()
    got = gs.kernel_grads(torch, *case)
    torch.cuda.synchronize()
    counts = launches()
    if counts != expect(seg_fwd=12, conv_fwd=12, blk_bwd=12):
        raise AssertionError(f"{label} {dn}: launches {counts}")
    hold_stack_grad(torch, ts, label, got, gs.plain_grads(torch, *case),
                    case, card)
    del got, case
    torch.cuda.empty_cache()


def phase_stack_grad(torch, ts, dev, card):
    """Autograd through the 12-block kernel stack against the plain stack,
    at the flagship width on 128 patches (see STACK_TOL)."""
    for dtype in (torch.float32, torch.bfloat16):
        hold_stack_kernels(torch, ts, dev, card, "stack gradient", dtype, C,
                           CMID, CDEC)


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


def write_cfg(base, **overrides):
    """base/p16t9c85r12.cfg: a copy of CFG whose directories point into
    base (preprocessing_out is base/data), with the given keys replaced."""
    keys = {"raw_data": "raw", "preprocessing_out": "data",
            "model_out": "model", "train_out": "trainout",
            "test_out": "testout"}
    values = {k: os.path.join(base, v) for k, v in keys.items()}
    values.update(overrides)
    lines = []
    with open(CFG) as f:
        for line in f:
            key = line.split("=", 1)[0].strip()
            lines.append(f"{key}={values[key]}\n" if key in values else line)
    cfg = os.path.join(base, "p16t9c85r12.cfg")
    with open(cfg, "w") as f:
        f.writelines(lines)
    return cfg


def write_tree(root, name, patches, params_npz):
    """The serve CLI's arguments over a cfg copy in root/name whose
    resolverDir holds patches."""
    base = os.path.join(root, name)
    os.makedirs(os.path.join(base, "data", "resolverDir"))
    np.save(os.path.join(base, "data", "resolverDir",
                         "TESTpatchesLR_NIR.npy"), patches)
    return ["--cfg", write_cfg(base), "--band", "NIR", "--totest", "TEST",
            "--params", params_npz]


def phase_serve(torch, dev, card):
    from probav_tpu_torch import serve
    from probav_tpu_torch.convert import save_npz
    from probav_tpu_torch.infer.resolver import MODEL_CHUNK
    from probav_tpu_torch.models.wdsr import build_model
    from probav_tpu_torch.tools.profile_serve import synthetic_patches
    from probav_tpu_torch.utils.png import read_png

    patches = synthetic_patches(SERVE_SCENES)
    model = build_model(CFG, "NIR", generator=torch.Generator().manual_seed(0))
    blocks = len(model.block_names)
    results, main_counts = {}, None
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
            reset_launches()
            t0 = time.perf_counter()
            res = serve.main(args + flags + ["--device", str(dev)])
            wall = time.perf_counter() - t0
            got = launches()
            if name == "bf16":
                main_counts = got       # the production run: main path
            names = sorted(os.listdir(outdir))
            want = [f"imgset{1306 + i:04d}.png" for i in range(scenes)]
            if names != want or len(res["written"]) != scenes:
                raise AssertionError(f"{name}: wrote {names}")
            group = -(-512 // (64 * repeats))
            chunks = sum(-(-min(group, scenes - s) * 64 * repeats //
                           MODEL_CHUNK) for s in range(0, scenes, group))
            per = 0 if "plain" in name else blocks * chunks
            if got != expect(seg_fwd=per, conv_fwd=per):
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
        served = os.path.join(tmp, "full", "testout_p16t9c85r12_")
        phase_score(torch, dev, card, tmp, served + "f32", served + "bf16",
                    results["f32"])
    diff = np.abs(results["f32"] - results["f32 plain"]).max()
    if diff > 1:
        raise AssertionError(f"f32 kernels vs f32 plain: {diff} counts")
    for a, b in (("bf16", "f32"), ("bf16 tta", "f32 tta"),
                 ("bf16", "bf16 plain")):
        dlt = np.abs(results[a] - results[b])
        log(f"drift {a} vs {b}: max {int(dlt.max())} counts, "
            f"{float((dlt > 0).mean()) * 100:.3f}% of pixels differ")
    log(f"serve f32 kernels vs f32 plain: max {int(diff)} counts")
    return main_counts


def phase_score(torch, dev, card, tmp, f32_dir, bf16_dir, f32_imgs):
    """The scoring step, on the serve phase's outputs: ``evaluate.main``
    on the card scores the float32 run (benchmark) and the bf16 run
    (candidate) against a synthetic stage-2 NIR truth made from the
    float32 output; each scene's card score is held to the same scorer on
    CPU tensors, the report's means to the per-scene scores.  Then the
    rates (the device scorer alone, with transfers, evaluate.main end to
    end over the port's unfiltered PNGs; other writers' filtered rows
    decode slower, see tools/time_png.py).  The scorer runs no hand
    kernel: every count stays 0.  Then the kernel loss's cPSNR of the 16
    scenes, one shift_table_fwd launch."""
    import logging

    from probav_tpu_torch import evaluate
    from probav_tpu_torch.evaluation import compare
    from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses

    r = np.random.default_rng(5)
    n, size = f32_imgs.shape[:2]
    hr = np.clip(f32_imgs + r.normal(0, SCORE_NOISE, f32_imgs.shape), 0,
                 65535).astype(np.float32)
    hidden = r.uniform(size=hr.shape) < SCORE_HIDDEN
    if not hr[hidden].any():
        raise AssertionError("score: no masked truth pixel holds data")
    base = os.path.join(tmp, "score")
    resolver = os.path.join(base, "data", "resolverDir")
    os.makedirs(resolver)
    np.ma.masked_array(hr[:, None, None], mask=hidden[:, None, None]).dump(
        os.path.join(resolver, "TRAINimgHR_NIR.npy"), protocol=4)
    pre = os.path.join(base, "data")
    argv = ["--cfg", write_cfg(base), "--benchmark", f32_dir, "--toCompare",
            bf16_dir, "--bands", "NIR", "--red-count", "0", "--device",
            "cuda", "--score-json", os.path.join(base, "score.json"),
            "--out", os.path.join(base, "comparison.png")]

    reset_launches()
    t0 = time.perf_counter()
    report = evaluate.main(argv)
    first = time.perf_counter() - t0
    if launches() != expect():
        raise AssertionError(f"score: launches {launches()}")
    walls = []
    for _ in range(WARM_REPEATS):
        t0 = time.perf_counter()
        evaluate.main(argv)
        walls.append(time.perf_counter() - t0)

    pairing = []
    handler = logging.Handler()
    handler.emit = lambda rec: pairing.append(rec.getMessage())
    clog = logging.getLogger(compare.__name__)
    clog.addHandler(handler)
    clog.setLevel(logging.INFO)
    try:
        got = compare.compare_runs(pre, f32_dir, bf16_dir, red_count=0,
                                   bands=("NIR",), device=dev)["NIR"]
    finally:
        clog.removeHandler(handler)
    # The serve outputs are imgset1306.., TEST ids outside NIR's TRAIN
    # range (594..), so the scenes pair by position.
    if pairing != [f"pairing {n} scenes by position"]:
        raise AssertionError(f"score: pairing {pairing}")
    want = compare.compare_runs(pre, f32_dir, bf16_dir, red_count=0,
                                bands=("NIR",), device="cpu")["NIR"]
    worst = 0.0
    for k in ("benchmark", "candidate"):
        if got[k].shape != (n,) or not np.isfinite(got[k]).all():
            raise AssertionError(f"score: {k} scores {got[k]}")
        np.testing.assert_allclose(got[k], want[k], rtol=SCORE_RTOL,
                                   atol=SCORE_ATOL, err_msg=f"score: {k}")
        worst = max(worst, float(np.abs(got[k] - want[k]).max()))
        mean = report["bands"]["NIR"][f"{k}_mean_cpsnr"]
        if not abs(mean - float(np.mean(got[k]))) <= 1e-6 * abs(mean):
            raise AssertionError(f"score: report {k} mean {mean} vs "
                                 f"{np.mean(got[k])}")
    if report["bands"]["NIR"]["scenes"] != n:
        raise AssertionError(f"score: report {report}")
    log(f"score: evaluate.main --device cuda, the f32 serve output "
        f"(benchmark) and bf16 (candidate) against a synthetic NIR truth "
        f"(f32 output + N(0, {SCORE_NOISE:g}^2), {hidden.mean() * 100:.1f}% "
        f"masked with data kept): {n} scenes, {pairing[0]}; mean cPSNR "
        f"benchmark {report['bands']['NIR']['benchmark_mean_cpsnr']:.4f} "
        f"dB, candidate {report['bands']['NIR']['candidate_mean_cpsnr']:.4f}"
        f" dB; card vs CPU scorer max |diff| {worst:.3e} dB (rtol "
        f"{SCORE_RTOL:g}, atol {SCORE_ATOL:g}); no kernel launched")

    truth = compare.load_hr_scenes(pre, bands=("NIR",))
    data, mask = np.asarray(truth, np.float32), ~np.ma.getmaskarray(truth)
    preds = [compare.load_scene_dir(d) for d in (f32_dir, bf16_dir)]
    on_card = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    hd, md = on_card(data), on_card(mask)
    pds = [on_card(p) for p in preds]
    score_all = lambda: [compare.cpsnr_batch(hd, md, p) for p in pds]
    single, = timed(torch, score_all)
    b2b, = back_to_back(torch, score_all)
    batch = timed(torch, lambda: compare._score_batches(
        data, mask, preds, device=dev), reps=WARM_REPEATS)[0]

    log(f"score rate, {n} scenes (each scored for both stacks): device "
        f"scorer (cpsnr_batch x 2 on the card) {n / single * 1e3:.1f} "
        f"scenes/s single call ({single:.3f} ms), {n / b2b * 1e3:.1f} back "
        f"to back ({b2b:.3f} ms); with H2D and D2H (_score_batches) "
        f"{n / batch * 1e3:.1f} ({batch:.3f} ms); evaluate.main end to "
        f"end {n / first:.2f} first run, median of {WARM_REPEATS} "
        f"{n / statistics.median(walls):.2f} (min {n / max(walls):.2f}, "
        f"max {n / min(walls):.2f}), port-written (unfiltered) PNGs [{card}]")

    # The kernel loss's cPSNR of the served scenes: the table kernel takes
    # 384^2 planes in clusters of row bands, one launch for all 16.
    reset_launches()
    got = ShiftCompensatedLosses((size, size, 1), use_kernel=True).cpsnr(
        hd, md.float(), pds[1])
    torch.cuda.synchronize()
    if launches() != expect(shift_table_fwd=1):
        raise AssertionError(f"kernel-loss cPSNR at {size}^2: launches "
                             f"{launches()}")
    want = ShiftCompensatedLosses((size, size, 1)).cpsnr(hd, md.float(),
                                                         pds[1])
    if got.shape != (n,) or not bool(got.isfinite().all()):
        raise AssertionError(f"kernel-loss cPSNR at {size}^2: {got}")
    torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=0)
    log(f"kernel-loss cPSNR at {size}^2, {n} scenes: one shift_table_fwd "
        f"launch, max |diff| {float((got - want).abs().max()):.3e} dB "
        f"against the unfold path (rtol {SCORE_RTOL:g})")


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
        resolver = make_resolver(CFG, dtype, fused, dev)
        rates = warm_rates(resolver, patches, WARM_REPEATS)
        log(f"warm resolve {name}: {SERVE_SCENES} scenes, median of "
            f"{WARM_REPEATS} {statistics.median(rates):.3f} scenes/s "
            f"(min {min(rates):.3f}, max {max(rates):.3f}) [{card}]")
        if fused:
            check_scene_tta(resolver, patches[0], name, card)
        del resolver
        torch.cuda.empty_cache()


def check_scene_tta(resolver, scene, name, card):
    """resolve_scene_tta of one scene ([64, h, w, T, C]) at R =
    SCENE_TTA_REPEATS against resolve_all of that scene with TTA (the
    same chunks through the same kernels: equal to the bit), its launches
    (12 of seg_fwd and conv_fwd a chunk of MODEL_CHUNK rows) and its warm
    time, the median of WARM_REPEATS after the reference call."""
    from probav_tpu_torch.infer.resolver import MODEL_CHUNK

    r = SCENE_TTA_REPEATS
    want = resolver.resolve_all(scene[None], tta=True, tta_repeats=r)[0]
    reset_launches()
    got = resolver.resolve_scene_tta(scene, repeats=r)
    counts = launches()
    per = len(resolver.model.block_names) * \
        -(-len(scene) * r // MODEL_CHUNK)
    if counts != expect(seg_fwd=per, conv_fwd=per):
        raise AssertionError(f"resolve_scene_tta {name}: launches "
                             f"{counts}, expected {per} of seg_fwd and "
                             f"conv_fwd")
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(
            f"resolve_scene_tta {name}: not equal to resolve_all TTA "
            f"({got.shape} vs {want.shape}, max |diff| "
            f"{float(np.abs(got - want).max())})")
    ms = []
    for _ in range(WARM_REPEATS):
        t0 = time.perf_counter()
        resolver.resolve_scene_tta(scene, repeats=r)
        ms.append((time.perf_counter() - t0) * 1e3)
    log(f"resolve_scene_tta {name}: one scene of {len(scene)} patches, R = "
        f"{r}, equal to resolve_all TTA to the bit, {per} launches of "
        f"seg_fwd and conv_fwd; warm {statistics.median(ms):.3f} ms a "
        f"scene (median of {WARM_REPEATS}, min {min(ms):.3f}, max "
        f"{max(ms):.3f}) [{card}]")


def write_train_tree(root, name, epochs, **overrides):
    """A cfg copy whose directories point into root/name, with ``epochs``
    (and the other keys of ``overrides``), over a synthetic stage-5 tree
    (TRAIN_N training and VAL_N validation patches, HR as pickled masked
    arrays as the pipeline writes them)."""
    from probav_tpu_torch.tools.profile_train import synthetic_batch

    base = os.path.join(root, name)
    aug = os.path.join(base, "data", "augmentedPatchesDir")
    if not os.path.isdir(aug):
        os.makedirs(aug)
        lr, hr, mask = synthetic_batch(TRAIN_N + VAL_N, seed=1)
        for split, sl in (("TRAIN", slice(0, TRAIN_N)),
                          ("TRAINVAL", slice(TRAIN_N, None))):
            np.save(os.path.join(aug, f"{split}patchesLR_NIR.npy"), lr[sl])
            np.ma.masked_array(hr[sl], mask=mask[sl] == 0).dump(
                os.path.join(aug, f"{split}patchesHR_NIR.npy"))
    model = os.path.join(base, "model")
    return (write_cfg(base, epochs=epochs, **overrides),
            os.path.join(model, "ckpt_p16t9c85r12", "NIR"),
            os.path.join(model, "logs_p16t9c85r12", "NIR"))


def train_losses(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["value"] for r in recs if r["tag"] == "Train loss"]


def check_train_cli(name, args, legs, steps_per_epoch, tmp, tree,
                    extra=()):
    """The train CLI for each of ``legs`` (total epochs) on one tree:
    steps, checkpoints, a falling loss; returns (launches, losses, the
    last result, wall s)."""
    from probav_tpu_torch.train import cli

    reset_launches()
    t0 = time.perf_counter()
    for epochs in legs:
        cfg, ckpt_dir, log_dir = write_train_tree(tmp, tree, epochs)
        res = cli.main(["--cfg", cfg, "--band", "NIR", "--eval-step",
                        str(steps_per_epoch)] + args + list(extra))["NIR"]
        if res["steps"] != epochs * steps_per_epoch:
            raise AssertionError(f"{name}: {res['steps']} steps after "
                                 f"{epochs} epochs")
        ckpts = sorted(os.listdir(ckpt_dir))
        if ckpts[-1] != f"step_{res['steps']:08d}.pt" or len(ckpts) > 5:
            raise AssertionError(f"{name}: checkpoints {ckpts}")
    wall = time.perf_counter() - t0
    got = launches()
    losses = train_losses(log_dir)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: losses {losses}")
    return got, losses, res, wall


def cli_launches(name, legs, steps_per_epoch, val_batches, blocks=12):
    """The launch counts of a train CLI run of ``legs``: 12 of each stack
    kernel a step with "t" and a forward per validation batch (one pass an
    epoch and a final one each leg; the flat tier's forward is plain
    PyTorch), 12 of wide_bwd a step with "flat", none when plain."""
    steps = legs[-1] * steps_per_epoch
    evals = sum(e - s + 1 for s, e in zip([0] + legs[:-1], legs)) * \
        val_batches
    if "plain" in name:
        return expect()
    if "flat" in name:
        return expect(wide_bwd=blocks * steps)
    return expect(seg_fwd=blocks * (steps + evals),
                  conv_fwd=blocks * (steps + evals), blk_bwd=blocks * steps)


def phase_train(torch, dev, card):
    """The train CLI at batch 128; returns the launch counts of the bf16
    runs of the "t" tier (the production configuration: the main path)
    and of the "flat" tier (the path that runs wide_bwd), by run name."""
    steps_per_epoch = TRAIN_N // 128
    val_batches = -(-VAL_N // 128)
    main_paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        flat = ["--fused-stack", "flat"]
        runs = [("bf16", ["--bf16"]), ("f32", []),
                ("bf16 flat", ["--bf16"] + flat), ("f32 flat", flat),
                ("bf16 plain", ["--bf16", "--plain"]),
                ("f32 plain", ["--plain"])]
        for name, flags in runs:
            # The bf16 kernel runs train half their epochs, then a restart
            # with the full count resumes from the checkpoint.
            legs = ([TRAIN_EPOCHS // 2, TRAIN_EPOCHS]
                    if name in ("bf16", "bf16 flat")
                    else [TRAIN_EPOCHS // 2])
            got, losses, res, wall = check_train_cli(
                f"train {name}", ["--device", str(dev)] + flags, legs,
                steps_per_epoch, tmp, name.replace(" ", "_"))
            steps = legs[-1] * steps_per_epoch
            want = cli_launches(name, legs, steps_per_epoch, val_batches)
            if got != want:
                raise AssertionError(f"train {name}: launches {got}, "
                                     f"expected {want}")
            if len(legs) > 1:
                main_paths[name] = got
            log(f"train {name}: {steps} steps at batch 128 in {len(legs)} "
                f"run(s) (resumed at step "
                f"{legs[0] * steps_per_epoch if len(legs) > 1 else 0}), "
                f"launches {got}; train loss {losses[0]:.3f} -> "
                f"{losses[-1]:.3f}; val cPSNR {res['val_psnr']:.3f}; "
                f"{wall:.1f} s cold, first calls included [{card}]")
    return main_paths


# The train_device phase: the first chunk's logged loss of fit and
# fit_device agrees to FIT_TOL[0] relative, every later chunk's to
# FIT_TOL[1] (cuDNN's weight gradients may sum in another order, and nadam
# turns a sign flip of a near-zero gradient into a step of +-lr); the
# --remat gradients to REMAT_TOL norm-wise.
FIT_TOL, REMAT_TOL = (1e-5, 1e-4), 1e-6


def phase_train_device(torch, dev, card):
    """The train CLI's --device-data, --remat and --profile-dir, and
    fit_device against fit (module docstring, 9a)."""
    from probav_tpu_torch.config import Config
    from probav_tpu_torch.tools import profile_train
    from probav_tpu_torch.tools.profile_train import (make_trainer,
                                                      synthetic_batch)
    from probav_tpu_torch.train.trainer import PROFILE_WINDOW
    from probav_tpu_torch.utils.profiling import TRACE_FILE

    steps_per_epoch = TRAIN_N // 128
    val_batches = -(-VAL_N // 128)
    blocks = 12
    cfg = Config.from_file(CFG)
    marks = [("start", time.perf_counter())]
    with tempfile.TemporaryDirectory() as tmp:
        # 1. --device-data through the CLI: launches, loss, resume.
        flat = ["--fused-stack", "flat"]
        for name, flags, legs in (
                ("bf16", ["--bf16"], [TRAIN_EPOCHS // 2, TRAIN_EPOCHS]),
                ("f32", [], [TRAIN_EPOCHS // 2]),
                ("f32 flat", flat, [TRAIN_EPOCHS // 2])):
            got, losses, res, wall = check_train_cli(
                f"train --device-data {name}",
                ["--device", str(dev), "--device-data"] + flags, legs,
                steps_per_epoch, tmp, "dd_" + name.replace(" ", "_"))
            steps = legs[-1] * steps_per_epoch
            want = cli_launches(name, legs, steps_per_epoch, val_batches)
            if got != want:
                raise AssertionError(f"train --device-data {name}: launches "
                                     f"{got}, expected {want}")
            log(f"train --device-data {name}: {steps} steps at batch 128 in "
                f"{len(legs)} run(s) (resumed at step "
                f"{legs[0] * steps_per_epoch if len(legs) > 1 else 0}), "
                f"launches {got}; train loss {losses[0]:.3f} -> "
                f"{losses[-1]:.3f}; val cPSNR {res['val_psnr']:.3f}; "
                f"{wall:.1f} s [{card}]")

        marks.append(("--device-data", time.perf_counter()))
        # 2. fit against fit_device, f32 "t", same init, seed and data.
        lr, hr, mask = synthetic_batch(TRAIN_N + VAL_N, seed=1)
        x, y = lr[:TRAIN_N], [hr[:TRAIN_N], mask[:TRAIN_N]]
        val = [lr[TRAIN_N:], hr[TRAIN_N:], mask[TRAIN_N:]]
        logged = {}
        for loop in ("fit", "fit_device"):
            tr = make_trainer(cfg, "float32", "t", dev,
                              os.path.join(tmp, "loop_" + loop))
            tr.eval_every = steps_per_epoch
            getattr(tr, loop)(x, y, 128, 2, val_data=val,
                              save_best_only=False)
            tr.logger_.close()
            logged[loop] = train_losses(os.path.join(tmp, "loop_" + loop,
                                                     "logs"))
        a, b = logged["fit"], logged["fit_device"]
        if len(a) != 2 or len(b) != 2:
            raise AssertionError(f"fit vs fit_device: chunks {a} {b}")
        errs = [abs(p - q) / abs(p) for p, q in zip(a, b)]
        if errs[0] > FIT_TOL[0] or max(errs[1:]) > FIT_TOL[1]:
            raise AssertionError(f"fit vs fit_device: losses {a} vs {b}")
        log(f"train f32 t, fit vs fit_device (2 epochs of "
            f"{steps_per_epoch} steps, same init, seed, data): chunk losses "
            f"{a} vs {b}, relative "
            f"differences {', '.join(f'{e:.2e}' for e in errs)} (tol "
            f"{FIT_TOL[0]:g} first, {FIT_TOL[1]:g} later) [{card}]")

        marks.append(("fit vs fit_device", time.perf_counter()))
        # 3. one chunk of fit_device with no host sync inside.
        tr = make_trainer(cfg, "float32", "t", dev,
                          os.path.join(tmp, "no_sync"))
        data = tr.resident((x, y[0], y[1]))
        idx = torch.randperm(TRAIN_N, generator=torch.Generator()
                             .manual_seed(3)).reshape(-1, 128).to(dev)
        float(tr._run_chunk(data, idx[:1])[0])        # warm
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            mean_loss, mean_psnr = tr._run_chunk(data, idx)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = launches()
        k = len(idx)
        want = expect(seg_fwd=blocks * k, conv_fwd=blocks * k,
                      blk_bwd=blocks * k)
        if got != want or not np.isfinite(float(mean_loss)):
            raise AssertionError(f"_run_chunk: launches {got}, expected "
                                 f"{want}; loss {float(mean_loss)}")
        tr.logger_.close()
        del tr, data
        log(f"fit_device chunk of {k} f32 t steps under "
            f"set_sync_debug_mode('error'): no host sync, launches {got}, "
            f"mean loss {float(mean_loss):.3f}, cPSNR "
            f"{float(mean_psnr):.3f} [{card}]")

        marks.append(("chunk", time.perf_counter()))
        # 4. --remat on the f32 "off" tier: gradients and peak memory.
        batch = tuple(torch.as_tensor(v, device=dev)
                      for v in synthetic_batch(cfg.batch_size, seed=2))
        reset_launches()
        cost = profile_train.remat_cost(cfg, dev, batch, tmp, steps=1)
        if launches() != expect():
            raise AssertionError(f"remat: launches {launches()}")
        (g0, peak0, ms0), (g1, peak1, ms1) = cost[False], cost[True]
        gerr = {k: rel_l2(g1[k], g0[k]) for k in g0}
        worst = max(gerr, key=lambda k: gerr[k])
        if not gerr[worst] <= REMAT_TOL:
            raise AssertionError(f"remat: gradient {worst} "
                                 f"||d||/||ref|| {gerr[worst]:.3e}")
        log(f"remat f32 off, batch {cfg.batch_size}: gradients of "
            f"{len(gerr)} leaves, worst ||remat - stored||/||stored|| "
            f"{worst} {gerr[worst]:.3e} (tol {REMAT_TOL:g}); peak memory "
            f"{peak0 / 1e9:.2f} GB stored -> {peak1 / 1e9:.2f} GB remat; "
            f"step {ms0:.1f} -> {ms1:.1f} ms [{card}]")
        # With fused_block, remat recomputes fused_expand_decay's forward
        # and its backward still runs wide_bwd once a block.
        grads, got = {}, {}
        for remat in (False, True):
            tr = make_trainer(cfg, "float32", "off", dev,
                              os.path.join(tmp, f"remat_fb_{remat}"),
                              fused_block=True, remat=remat)
            reset_launches()
            grads[remat] = tr.loss_and_grads(*batch)[2]
            got[remat] = launches()
            tr.logger_.close()
            del tr
        gerr = {k: rel_l2(grads[True][k], grads[False][k])
                for k in grads[False]}
        worst = max(gerr, key=lambda k: gerr[k])
        want = expect(wide_bwd=blocks)
        if got[True] != want or got[False] != want or \
                not gerr[worst] <= REMAT_TOL:
            raise AssertionError(f"remat with fused_block: launches "
                                 f"{got}, expected {want} each; gradient "
                                 f"{worst} {gerr[worst]:.3e}")
        del grads
        torch.cuda.empty_cache()
        log(f"remat f32 off with fused_block, batch {cfg.batch_size}: "
            f"launches {got[True]} (as without remat), worst gradient "
            f"||remat - stored||/||stored|| {worst} {gerr[worst]:.3e} (tol "
            f"{REMAT_TOL:g}) [{card}]")

        marks.append(("--remat", time.perf_counter()))
        # 5. --profile-dir: the trace of steps 10-19 names the t kernels.
        trace_dir = os.path.join(tmp, "trace")
        got, losses, res, wall = check_train_cli(
            "train --profile-dir", ["--device", str(dev), "--bf16"],
            [TRAIN_EPOCHS], steps_per_epoch, tmp, "profiled",
            extra=["--profile-dir", trace_dir])
        names = profile_train.kernel_names(load_trace(
            os.path.join(trace_dir, TRACE_FILE)))
        seen = {t_kernel_of(n) for n in names} - {None}
        if os.listdir(trace_dir) != [TRACE_FILE] or \
                seen != {"seg_fwd", "conv_fwd", "blk_bwd"}:
            raise AssertionError(f"--profile-dir: {os.listdir(trace_dir)}, "
                                 f"t kernels {seen} of {sorted(names)}")
        log(f"train --profile-dir (bf16 t, {res['steps']} steps): "
            f"{TRACE_FILE} of steps 10-19 names "
            f"{sorted(n for n in names if t_kernel_of(n))} "
            f"[{card}]")

        marks.append(("--profile-dir", time.perf_counter()))
        # 6. the window busy share of both loops, bf16 "t" (both ran above:
        # they are warm).
        data = profile_train.synthetic_set((PROFILE_WINDOW[1] + 1) * 128)
        for loop in ("fit", "fit_device"):
            bz = profile_train.loop_busy(cfg, "bfloat16", dev, loop, data,
                                         val, os.path.join(tmp, "busy_" +
                                                           loop))
            if not bz["device_events"] or not 0 < bz["busy_share"] <= 1:
                raise AssertionError(f"{loop} window busy: {bz}")
            log(f"bf16 t {loop}: global steps {PROFILE_WINDOW[0]}-"
                f"{PROFILE_WINDOW[1] - 1} traced with no sync: device busy "
                f"{bz['busy_ms']:.2f} of {bz['window_ms']:.2f} ms, window "
                f"busy share {100 * bz['busy_share']:.1f}% [{card}]")
        marks.append(("window busy", time.perf_counter()))
    parts = ", ".join(f"{name} {t - marks[i][1]:.1f}"
                      for i, (name, t) in enumerate(marks[1:]))
    log(f"train_device phase: {marks[-1][1] - marks[0][1]:.1f} s ({parts})")


# The mesh phase: the two-rank fit_device chunk's steps, the timed steps
# of the two-rank and the one-process step, and the resolver's inputs
# (the serve phase's scenes; TTA on TTA_SCENES of them).
MESH_CHUNK, MESH_TIMED = 2, 3


def mesh_nccl_rank(mesh, argv, tmp):
    """The one NCCL rank of the mesh phase: the train CLI's rank
    (``cli.rank_main``, which ``cli.main`` launches for --mesh-data) with
    ``argv``, then one fit_device chunk under
    ``torch.cuda.set_sync_debug_mode("error")``.  Returns the CLI's result,
    the launch counts of both and the chunk's loss."""
    import logging

    import torch

    from probav_tpu_torch.config import Config
    from probav_tpu_torch.tools.profile_train import (make_trainer,
                                                      synthetic_batch)
    from probav_tpu_torch.train import cli

    torch.backends.cudnn.deterministic = True   # as the reference run
    reset_launches()
    res = cli.rank_main(mesh, cli.parse_args(argv), ["NIR"], logging.WARNING)
    cli_counts = launches()
    tr = make_trainer(Config.from_file(CFG), "float32", "t", mesh.device,
                      os.path.join(tmp, "nccl_chunk"), mesh=mesh)
    data = tr.resident(synthetic_batch(TRAIN_N, seed=1))
    idx = torch.randperm(TRAIN_N, generator=torch.Generator()
                         .manual_seed(3)).reshape(-1, 128).to(mesh.device)
    float(tr._run_chunk(data, idx[:1])[0])   # warm: the communicator, cuDNN
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, _ = tr._run_chunk(data, idx)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    chunk_counts = launches()
    tr.logger_.close()
    return dict(res=res, cli=cli_counts, chunk=chunk_counts, steps=len(idx),
                loss=float(loss))


def step_ms(tr, batch, n):
    """Median ms of n train steps on ``batch``, each synchronized, after
    one warm-up (profile_train.warm_step_rates)."""
    from probav_tpu_torch.tools.profile_train import warm_step_rates

    return 1e3 * len(batch[0]) / statistics.median(
        warm_step_rates(tr, batch, n))


def mesh_gloo_rank(mesh, tmp):
    """One of the two gloo ranks on the card: one f32 "t" train step of
    the flagship on this rank's 64 of the 128 patches (the gradients of
    the global loss, then the update), MESH_TIMED timed steps, one
    fit_device chunk of MESH_CHUNK steps and Resolver.resolve_all on the
    serve phase's scenes, each with its launch counts.  The parameters
    after the first update go to tmp/mesh_rank<r>.pt."""
    import torch

    from probav_tpu_torch.config import Config
    from probav_tpu_torch.parallel.mesh import batch_share
    from probav_tpu_torch.serve import model_layout
    from probav_tpu_torch.tools.profile_serve import (make_resolver,
                                                      synthetic_patches)
    from probav_tpu_torch.tools.profile_train import (make_trainer,
                                                      synthetic_batch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, out = mesh.device, {}
    cfg = Config.from_file(CFG)
    share = batch_share(mesh, cfg.batch_size)
    tr = make_trainer(cfg, "float32", "t", dev,
                      os.path.join(tmp, f"gloo{mesh.rank}"), mesh=mesh)
    batch = tuple(torch.as_tensor(a[share], device=dev)
                  for a in synthetic_batch(cfg.batch_size, seed=2))
    reset_launches()
    loss, _, grads = tr.loss_and_grads(*batch)
    loss, metric = tr.train_step(*batch)
    torch.cuda.synchronize()
    out["step"] = dict(loss=float(loss), metric=float(metric),
                       counts=launches(),
                       grads={k: v.cpu() for k, v in grads.items()})
    torch.save({k: v.detach().cpu() for k, v in tr.params.items()},
               os.path.join(tmp, f"mesh_rank{mesh.rank}.pt"))
    out["step_ms"] = step_ms(tr, batch, MESH_TIMED)

    data = tr.resident(synthetic_batch(TRAIN_N, seed=1))
    idx = torch.randperm(TRAIN_N, generator=torch.Generator().manual_seed(
        3)).reshape(-1, cfg.batch_size)[:MESH_CHUNK, share].contiguous()
    reset_launches()
    loss, _ = tr._run_chunk(data, idx.to(dev))
    out["chunk"] = dict(loss=float(loss), counts=launches())
    tr.logger_.close()
    del tr, data, grads
    torch.cuda.empty_cache()

    patches = model_layout(synthetic_patches(SERVE_SCENES))
    r = make_resolver(CFG, "float32", True, dev, mesh=mesh)
    reset_launches()
    out["scenes"] = np.stack(r.resolve_all(patches))
    out["tta"] = np.stack(r.resolve_all(patches[:TTA_SCENES], tta=True))
    out["resolve_counts"] = launches()
    torch.save({k: out[k] for k in ("step", "chunk", "resolve_counts")},
               os.path.join(tmp, f"mesh_counts{mesh.rank}.pt"))
    return out


def resolver_launches(blocks, scenes, repeats, ranks):
    """seg_fwd (and conv_fwd) launches of one rank's resolve_all: each
    group's rows split over the ranks, in MODEL_CHUNK chunks."""
    from probav_tpu_torch.infer.resolver import MODEL_CHUNK

    group = -(-512 // (64 * repeats))
    return sum(blocks * -(-min(group, scenes - s) * 64 * repeats // ranks //
                          MODEL_CHUNK) for s in range(0, scenes, group))


def phase_mesh(torch, dev, card):
    """--mesh-data (probav_tpu_torch.parallel): the CLIs on one NCCL rank
    against one process, and two gloo ranks on the card against one
    process (module docstring, 9b)."""
    from probav_tpu_torch import serve
    from probav_tpu_torch.config import Config
    from probav_tpu_torch.convert import save_npz
    from probav_tpu_torch.models.wdsr import build_model
    from probav_tpu_torch.parallel.launch import launch
    from probav_tpu_torch.serve import model_layout
    from probav_tpu_torch.tools.profile_serve import (make_resolver,
                                                      synthetic_patches)
    from probav_tpu_torch.tools.profile_train import (make_trainer,
                                                      synthetic_batch)
    from probav_tpu_torch.train import cli

    steps_per_epoch = TRAIN_N // 128
    val_batches = -(-VAL_N // 128)
    legs = [TRAIN_EPOCHS // 2]
    blocks = 12
    cfg = Config.from_file(CFG)
    marks = [("start", time.perf_counter())]
    with tempfile.TemporaryDirectory() as tmp:
        # 1. One NCCL rank: the train CLI's logs equal to the bit to one
        # process from the same init, both with cuDNN's deterministic
        # algorithms (its weight gradients may otherwise sum in another
        # order in each run); its launches; a sync-free fit_device chunk.
        logs, ckpts = {}, {}
        for n in (0, 1):
            cfgp, ckpt_dir, log_dir = write_train_tree(tmp, f"mesh{n}",
                                                       legs[0])
            argv = ["--cfg", cfgp, "--band", "NIR", "--device", str(dev),
                    "--eval-step", str(steps_per_epoch)]
            if n:
                got = launch(mesh_nccl_rank, 1, argv + ["--mesh-data", "1"],
                             tmp, device="cuda", deadline=600)
                res = got["res"]["NIR"]
            else:
                torch.backends.cudnn.deterministic = True
                try:
                    res = cli.main(argv)["NIR"]
                finally:
                    torch.backends.cudnn.deterministic = False
            if res["steps"] != legs[0] * steps_per_epoch:
                raise AssertionError(f"mesh CLI {n}: {res['steps']} steps")
            with open(os.path.join(log_dir, "metrics.jsonl")) as f:
                logs[n] = [(r["tag"], r["step"], r["value"])
                           for r in map(json.loads, f)]
            ckpts[n] = sorted(os.listdir(ckpt_dir))
        want = cli_launches("f32", legs, steps_per_epoch, val_batches)
        if got["cli"] != want:
            raise AssertionError(f"--mesh-data 1: launches {got['cli']}, "
                                 f"expected {want}")
        if logs[1] != logs[0] or ckpts[1] != ckpts[0]:
            raise AssertionError(f"--mesh-data 1 vs one process: logs "
                                 f"{logs[1]} vs {logs[0]}, checkpoints "
                                 f"{ckpts[1]} vs {ckpts[0]}")
        k = got["steps"]
        if got["chunk"] != expect(seg_fwd=blocks * k, conv_fwd=blocks * k,
                                  blk_bwd=blocks * k) or \
                not np.isfinite(got["loss"]):
            raise AssertionError(f"--mesh-data 1 chunk: launches "
                                 f"{got['chunk']}, loss {got['loss']}")
        train = [v for t, _, v in logs[1] if t == "Train loss"]
        log(f"train --mesh-data 1 (NCCL, f32 t, {res['steps']} steps at "
            f"batch 128): {len(logs[1])} logged values equal to the bit to "
            f"one process (train loss {train[0]:.6f} -> {train[-1]:.6f}), "
            f"checkpoints {ckpts[1]}, launches {got['cli']}; a fit_device "
            f"chunk of {k} steps under set_sync_debug_mode('error'): no "
            f"host sync, launches {got['chunk']} [{card}]")

        marks.append(("NCCL train", time.perf_counter()))
        model = build_model(CFG, "NIR", generator=torch.Generator()
                            .manual_seed(0))
        npz = os.path.join(tmp, "params.npz")
        save_npz(npz, model.state_dict())
        pngs = {}
        for n in (0, 1):
            args = write_tree(tmp, f"serve{n}", synthetic_patches(
                SERVE_SCENES), npz) + ["--device", str(dev)]
            res = serve.main(args + ["--mesh-data", str(n)])
            pngs[n] = [open(p, "rb").read() for p in res["written"]]
        if len(pngs[1]) != SERVE_SCENES or pngs[1] != pngs[0]:
            raise AssertionError("serve --mesh-data 1: PNGs differ from one "
                                 "process")
        log(f"serve --mesh-data 1 (NCCL, f32 kernels): {SERVE_SCENES} PNGs "
            f"equal, byte for byte, to one process [{card}]")

        marks.append(("NCCL serve", time.perf_counter()))
        # 2. Two gloo ranks on the card against one process.
        two = launch(mesh_gloo_rank, 2, tmp, device="cuda", backend="gloo",
                     deadline=600)
        marks.append(("gloo ranks", time.perf_counter()))
        tr = make_trainer(cfg, "float32", "t", dev,
                          os.path.join(tmp, "one"))
        batch = tuple(torch.as_tensor(a, device=dev)
                      for a in synthetic_batch(cfg.batch_size, seed=2))
        _, _, grads = tr.loss_and_grads(*batch)
        loss, metric = tr.train_step(*batch)
        one_ms = step_ms(tr, batch, MESH_TIMED)
        tr.logger_.close()
        del tr
        step = two["step"]
        if not abs(step["loss"] - float(loss)) <= 1e-5 * abs(float(loss)) \
                or not abs(step["metric"] - float(metric)) <= \
                1e-5 * abs(float(metric)):
            raise AssertionError(f"two ranks: loss {step['loss']} vs "
                                 f"{float(loss)}, cPSNR {step['metric']} vs "
                                 f"{float(metric)}")
        gerr = {k: rel_l2(step["grads"][k].to(dev), v)
                for k, v in grads.items()}
        gk = max(gerr, key=lambda k: gerr[k] if np.isfinite(gerr[k])
                 else np.inf)
        if not gerr[gk] <= STACK_TOL["float32"]:
            raise AssertionError(f"two ranks: gradient {gk} "
                                 f"||got-ref||/||ref|| {gerr[gk]:.3e}")
        p0, p1 = (torch.load(os.path.join(tmp, f"mesh_rank{r}.pt"))
                  for r in (0, 1))
        if any(not torch.equal(p0[k], p1[k]) for k in p0):
            raise AssertionError("two ranks: parameters differ after the "
                                 "update")
        counts = [torch.load(os.path.join(tmp, f"mesh_counts{r}.pt"),
                             weights_only=False) for r in (0, 1)]
        per = 2 * blocks                 # loss_and_grads, then train_step
        want_step = expect(seg_fwd=per, conv_fwd=per, blk_bwd=per)
        per = MESH_CHUNK * blocks
        want_chunk = expect(seg_fwd=per, conv_fwd=per, blk_bwd=per)
        per = resolver_launches(blocks, SERVE_SCENES, 1, 2) + \
            resolver_launches(blocks, TTA_SCENES, 20, 2)
        want_resolve = expect(seg_fwd=per, conv_fwd=per)
        for r, c in enumerate(counts):
            if c["step"]["counts"] != want_step or \
                    c["chunk"]["counts"] != want_chunk or \
                    c["resolve_counts"] != want_resolve or \
                    not np.isfinite(c["chunk"]["loss"]):
                raise AssertionError(f"two ranks, rank {r}: launches step "
                                     f"{c['step']['counts']}, chunk "
                                     f"{c['chunk']['counts']}, resolve "
                                     f"{c['resolve_counts']}")
        log(f"two gloo ranks on the card, f32 t step of the flagship (64 of "
            f"128 patches a rank): loss {step['loss']:.6f} vs "
            f"{float(loss):.6f}, cPSNR {step['metric']:.4f} vs "
            f"{float(metric):.4f} (rel 1e-5); gradients of {len(gerr)} "
            f"leaves, worst ||got-ref||/||ref|| {gk} {gerr[gk]:.3e} (tol "
            f"{STACK_TOL['float32']:g}); parameters of both ranks equal to "
            f"the bit after the update; launches a rank: step "
            f"{counts[1]['step']['counts']}, fit_device chunk of "
            f"{MESH_CHUNK} steps {counts[1]['chunk']['counts']}, resolve "
            f"{counts[1]['resolve_counts']} [{card}]")
        log(f"two gloo ranks on one card (a record, not a claim: both share "
            f"the card, and gloo reduces through the host): median synced "
            f"step of {MESH_TIMED} {two['step_ms']:.1f} ms for 128 patches "
            f"against {one_ms:.1f} ms in one process [{card}]")

        patches = model_layout(synthetic_patches(SERVE_SCENES))
        r = make_resolver(CFG, "float32", True, dev)
        for name, got, want in (
                ("resolve_all", two["scenes"], np.stack(r.resolve_all(
                    patches))),
                ("resolve_all tta", two["tta"], np.stack(r.resolve_all(
                    patches[:TTA_SCENES], tta=True)))):
            diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
            if got.shape != want.shape or diff.max() > 1:
                raise AssertionError(f"two ranks {name}: max "
                                     f"{diff.max()} counts")
            log(f"two gloo ranks, f32 kernels, {name} of {len(got)} scenes "
                f"against one process: {int((diff > 0).sum())} of "
                f"{diff.size} pixels differ, max {int(diff.max())} count "
                f"[{card}]")
        del r
        torch.cuda.empty_cache()
    marks.append(("one process", time.perf_counter()))
    parts = ", ".join(f"{name} {t - marks[i][1]:.1f}"
                      for i, (name, t) in enumerate(marks[1:]))
    log(f"mesh phase: {marks[-1][1] - marks[0][1]:.1f} s ({parts})")


# The model-axis phase (--mesh-model, tensor parallelism of the expand /
# decay pair): wide_bwd at the widths a rank of a model group of
# 2 and 4 runs it (C_mid / M channels over the flagship's N rows), and a
# (data 1, model 2) mesh of two gloo ranks sharing the card, its f32 flat
# steps and one bf16 flat step against one process's.  Tolerances of the
# ranks against one process (float32, TF32 off): the first step's loss to
# 1e-5 relative (the same parameters; only the decay's sums split in two),
# every later loss to 1e-4, the gathered gradients at the start leaf by
# leaf norm-wise to STACK_TOL["float32"] (relu flips, as the flat stack
# against plain), and the movement of all parameters over the steps,
# ||p_two - p_one|| / ||p_one - p_init|| over their concatenation, to
# MODEL_MOVE_TOL: nadam moves an element by ~lr whatever its gradient's
# size, so an element whose gradient lies within the two runs' gap of 0
# may move the other way.  With gradients e apart norm-wise (5.2e-5 at
# most, measured on an H100), about e of the elements lie that close, so
# the movement parts by about 2 sqrt(e) ~ 1.4e-2 at most (5.9e-3
# measured); a wrong part or a sum left out parts it by about 1.
# bf16: its loss to 1e-2 relative (MODEL_TOL),
# its gradients to STACK_BF16_INDEPENDENT_TOL and its movement to
# MODEL_MOVE_BF16_TOL, bounds against wiring faults (a wrong part or a
# sum left out parts the runs by about their movement or more): the ranks
# round two partial decay products to bf16 where one process rounds one,
# which flips relu decisions and the sign of nadam's step on small
# gradient elements, as an independent bf16 forward does.
TP_MODELS = (2, 4)
MODEL_F32_STEPS = 3
MODEL_MOVE_TOL, MODEL_MOVE_BF16_TOL = 2e-2, 0.5


def count_all_reduce_bytes(mesh):
    """Wrap torch.distributed.all_reduce in this process so that it adds
    each call's bytes to the returned {"model", "data", "world"} counts,
    by the group it runs on."""
    import torch.distributed as dist

    counts = {"model": 0, "data": 0, "world": 0}
    inner = dist.all_reduce
    names = {id(mesh.model_group): "model", id(mesh.data_group): "data"}

    def counted(t, *args, group=None, **kw):
        counts[names.get(id(group), "world") if group is not None
               else "world"] += t.numel() * t.element_size()
        return inner(t, *args, group=group, **kw)

    dist.all_reduce = counted
    return counts


def mesh_model_rank(mesh, tmp):
    """One rank of the (data 1, model 2) mesh on the card: the flagship's
    f32 flat trainer (each block's expand / decay on this rank's 128 of
    C_mid 256), the gradients at the start, MODEL_F32_STEPS synced train
    steps on the 128 patches (launch counts, step times, all-reduce bytes
    of the last), then the bf16 flat trainer's gradients and one step.
    Returns the losses, the gathered gradients and parameters; this rank's own parameters go to
    tmp/tp_<dtype>_rank<r>.pt."""
    import torch

    from probav_tpu_torch.config import Config
    from probav_tpu_torch.tools.profile_train import (make_trainer,
                                                      synthetic_batch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.from_file(CFG)
    batch = tuple(torch.as_tensor(a, device=mesh.device)
                  for a in synthetic_batch(cfg.batch_size, seed=2))
    sent = count_all_reduce_bytes(mesh)
    out = {}
    for dn, steps in (("float32", MODEL_F32_STEPS), ("bfloat16", 1)):
        tr = make_trainer(cfg, dn, "flat", mesh.device,
                          os.path.join(tmp, f"tp_{dn}_{mesh.rank}"),
                          mesh=mesh)
        if not tr.sharded:
            raise AssertionError("model axis: the trainer is not sharded")
        got = dict(init=tr._whole({k: p.detach().cpu().clone()
                                   for k, p in tr.params.items()}))
        _, _, grads = tr.loss_and_grads(*batch)
        got["grads"] = {k: v.cpu() for k, v in tr._whole(grads).items()}
        del grads
        reset_launches()
        losses, secs = [], []
        for _ in range(steps):
            for k in sent:
                sent[k] = 0
            t0 = time.perf_counter()
            loss, _ = tr.train_step(*batch)
            losses.append(float(loss))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        got.update(losses=losses, secs=secs, counts=launches(),
                   sent=dict(sent),
                   params=tr._whole({k: p.detach().cpu()
                                     for k, p in tr.params.items()}))
        torch.save({k: p.detach().cpu() for k, p in tr.params.items()},
                   os.path.join(tmp, f"tp_{dn}_rank{mesh.rank}.pt"))
        out[dn] = got
        tr.logger_.close()
        del tr
        torch.cuda.empty_cache()
    return out


def mesh_model_cli_rank(mesh, argv, tmp):
    """One rank of the train CLI at --mesh-data 1 --mesh-model 2
    (``cli.rank_main``); this rank's parameters at its last checkpoint go
    to tmp/tp_cli_rank<r>.pt.  Returns the CLI's result and the launch
    counts."""
    import logging

    import torch

    from probav_tpu_torch.train import cli
    from probav_tpu_torch.train.trainer import ModelTrainer

    save, saved = ModelTrainer.save, {}

    def recorded(tr):
        saved["params"] = {k: p.detach().cpu().clone()
                           for k, p in tr.params.items()}
        return save(tr)

    ModelTrainer.save = recorded
    reset_launches()
    res = cli.rank_main(mesh, cli.parse_args(argv), ["NIR"], logging.WARNING)
    counts = launches()
    torch.save(saved["params"], os.path.join(tmp,
                                             f"tp_cli_rank{mesh.rank}.pt"))
    return dict(res=res["NIR"], counts=counts)


def movement_err(got, want, init):
    """||got - want|| / ||want - init|| over all parameters: how far the
    two runs' parameters part, against how far one run moved them."""
    parted = sum(float((got[k].double() - w.double()).norm()) ** 2
                 for k, w in want.items())
    moved = sum(float((w.double() - init[k].double()).norm()) ** 2
                for k, w in want.items())
    return (parted / max(moved, 1e-60)) ** 0.5


def phase_mesh_model(torch, dev, card):
    """--mesh-model: wide_bwd at a model rank's widths, then two gloo ranks
    of a (data 1, model 2) mesh on the card against one process, and the
    train CLI's ranks with a resume in one process (module docstring,
    9c)."""
    from probav_tpu_torch.config import Config
    from probav_tpu_torch.ops import wide_block as wb
    from probav_tpu_torch.parallel.launch import launch
    from probav_tpu_torch.parallel.mesh import Mesh, shard_state
    from probav_tpu_torch.tools.dyadic import wide_bwd_inputs
    from probav_tpu_torch.tools.profile_train import (make_trainer,
                                                      synthetic_batch)
    from probav_tpu_torch.train import cli
    from probav_tpu_torch.train.trainer import list_checkpoints

    marks = [("start", time.perf_counter())]
    n = N_PATCH * HW * HW * T
    # 1. wide_bwd on each rank's C_mid / M channels, against plain.
    for m in TP_MODELS:
        cmid = CMID // m
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            route = wb.wide_bwd_route(dtype, C, cmid, CDEC)
            if route != wb.WIDE_BWD_ROUTES[1 if dn == "bfloat16" else 2]:
                raise AssertionError(f"wide_bwd {dn} {C}/{cmid}/{CDEC} "
                                     f"route {route}: not the tensor cores")
            args = wide_bwd_inputs(n, C, cmid, CDEC, seed=7 + m, device=dev,
                                   dtype=dtype)
            tol_of = lambda k: BWD_TOL[dn] if k == "dx" else BWD_GRAD_TOL
            errs = check_outputs(f"wide_bwd tp{m} {dn}", WIDE_NAMES,
                                 wb.wide_bwd(*args), wb.wide_bwd_plain(*args),
                                 tol_of)
            ms, pms = back_to_back(torch, lambda: wb.wide_bwd(*args),
                                   lambda: wb.wide_bwd_plain(*args), n=10)
            log(f"kernel wide_bwd {dn} at a model rank's widths, M = {m} "
                f"[N={n}, {C}/{cmid}/{CDEC}]: route {route}; max|diff| " +
                ", ".join(f"{k} {e:.3e}" for k, e in zip(WIDE_NAMES, errs)) +
                f"; back to back, per call: kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms, bound "
                f"{bound_text(kernel_costs('wide_bwd', n, C, cmid, CDEC, dn))}"
                f" [{card}]")
            del args
    torch.cuda.empty_cache()
    marks.append(("wide_bwd", time.perf_counter()))

    cfg = Config.from_file(CFG)
    blocks = cfg.num_res_blocks
    with tempfile.TemporaryDirectory() as tmp:
        # 2. Two gloo ranks of (data 1, model 2) against one process.
        two = launch(mesh_model_rank, 2, tmp, device="cuda", backend="gloo",
                     num_model=2, deadline=900)
        marks.append(("gloo ranks", time.perf_counter()))
        batch = tuple(torch.as_tensor(a, device=dev)
                      for a in synthetic_batch(cfg.batch_size, seed=2))
        for dn, steps in (("float32", MODEL_F32_STEPS), ("bfloat16", 1)):
            got = two[dn]
            tr = make_trainer(cfg, dn, "flat", dev,
                              os.path.join(tmp, f"one_{dn}"))
            init = {k: p.detach().cpu().clone()
                    for k, p in tr.params.items()}
            _, _, grads = tr.loss_and_grads(*batch)
            losses, secs = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                loss, _ = tr.train_step(*batch)
                losses.append(float(loss))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            params = {k: p.detach().cpu() for k, p in tr.params.items()}
            bad = [k for k, v in init.items()
                   if not torch.equal(got["init"][k], v)]
            if bad:
                raise AssertionError(f"model axis {dn}: the ranks' gathered "
                                     f"initial {bad} differ from one "
                                     "process's (the same seed)")
            if got["counts"] != expect(wide_bwd=blocks * steps):
                raise AssertionError(f"model axis {dn}: launches a rank "
                                     f"{got['counts']}, expected "
                                     f"{blocks * steps} wide_bwd")
            # Each rank's parameters are its part of the gathered ones, so
            # the replicated ones are equal to the bit on both ranks.
            for r in (0, 1):
                part = torch.load(os.path.join(tmp, f"tp_{dn}_rank{r}.pt"))
                mine = shard_state(got["params"], Mesh(
                    world=2, rank=r, device=dev, model_size=2))
                bad = [k for k in part if not torch.equal(mine[k], part[k])]
                if bad or mine.keys() != part.keys():
                    raise AssertionError(f"model axis {dn}: rank {r}'s "
                                         f"{bad} are not its part of the "
                                         "gathered parameters")
            rtol = [1e-5] + [1e-4] * (steps - 1) if dn == "float32" else \
                [MODEL_TOL[dn]]
            for i, (a, b) in enumerate(zip(got["losses"], losses)):
                if not abs(a - b) <= rtol[i] * abs(b):
                    raise AssertionError(f"model axis {dn} step {i}: loss "
                                         f"{a} vs one process {b}")
            move = movement_err(got["params"], params, init)
            move_tol, grad_tol = (
                (MODEL_MOVE_TOL, STACK_TOL[dn]) if dn == "float32" else
                (MODEL_MOVE_BF16_TOL, STACK_BF16_INDEPENDENT_TOL))
            gerr = {k: rel_l2(got["grads"][k].to(dev), v)
                    for k, v in grads.items()}
            gk = max(gerr, key=lambda k: gerr[k] if np.isfinite(gerr[k])
                     else np.inf)
            log(f"model axis {dn}: gradients at the start against one "
                f"process, ||got-ref||/||ref|| by leaf: " + ", ".join(
                    f"{k} {e:.2e}" for k, e in gerr.items()) + f"; all "
                f"parameters part by {move:.3e} of their movement [{card}]")
            if not gerr[gk] <= grad_tol:
                raise AssertionError(f"model axis {dn}: gradient {gk} "
                                     f"||got-ref||/||ref|| {gerr[gk]:.3e}")
            if not move <= move_tol:
                raise AssertionError(f"model axis {dn}: parameters part by "
                                     f"{move:.3e} of their movement")
            gtxt = (f"; gradients of {len(gerr)} leaves, worst "
                    f"||got-ref||/||ref|| {gk} {gerr[gk]:.3e} (tol "
                    f"{grad_tol:g})")
            sent = got["sent"]
            log(f"model axis, two gloo ranks on the card (data 1, model 2), "
                f"{dn} flat, {steps} step(s) of the flagship at batch 128 "
                f"(each rank 128 of C_mid 256): losses "
                f"{', '.join(f'{v:.6f}' for v in got['losses'])} vs one "
                f"process {', '.join(f'{v:.6f}' for v in losses)}{gtxt}; "
                f"parameters part by {move:.3e} of their movement (tol "
                f"{move_tol:g}); replicated parameters equal to "
                f"the bit on both ranks; launches a rank {got['counts']} "
                f"[{card}]")
            ms = lambda t: ", ".join(f"{1e3 * v:.1f}" for v in t)
            log(f"model axis {dn} (a record, not a claim: both ranks share "
                f"the card, and gloo reduces through the host): synced step "
                f"of two ranks {ms(got['secs'])} ms against one process "
                f"{ms(secs)} ms; all-reduce "
                f"bytes a step, each rank's buffers: model group "
                f"{sent['model']} ({sent['model'] / 1e9:.3f} GB), data "
                f"group {sent['data']}, whole mesh {sent['world']} [{card}]")
            tr.logger_.close()
            del tr, grads
            torch.cuda.empty_cache()
        marks.append(("one process", time.perf_counter()))

        # 3. The train CLI's ranks, then a resume of their last checkpoint
        # in one process.
        steps_per_epoch = TRAIN_N // cfg.batch_size
        cfgp, ckpt_dir, log_dir = write_train_tree(tmp, "tp_cli", 1)
        argv = ["--cfg", cfgp, "--band", "NIR", "--device", str(dev),
                "--eval-step", str(steps_per_epoch)]
        got = launch(mesh_model_cli_rank, 2,
                     argv + ["--mesh-data", "1", "--mesh-model", "2"], tmp,
                     device="cuda", backend="gloo", num_model=2,
                     deadline=900)
        if got["res"]["steps"] != steps_per_epoch or \
                got["counts"] != expect(wide_bwd=blocks * steps_per_epoch):
            raise AssertionError(f"train --mesh-model 2: steps "
                                 f"{got['res']['steps']}, launches a rank "
                                 f"{got['counts']}")
        step, path = list_checkpoints(ckpt_dir)[-1]
        whole = torch.load(path)["params"]
        for r in (0, 1):
            part = torch.load(os.path.join(tmp, f"tp_cli_rank{r}.pt"))
            mine = shard_state(whole, Mesh(world=2, rank=r, device=dev,
                                           model_size=2))
            if mine.keys() != part.keys() or \
                    any(not torch.equal(mine[k], part[k]) for k in part):
                raise AssertionError(f"train --mesh-model 2: rank {r}'s "
                                     "parameters are not its part of the "
                                     "checkpoint")
        first = train_losses(log_dir)
        cfgp, _, _ = write_train_tree(tmp, "tp_cli", 2)
        reset_launches()
        res = cli.main(argv[:1] + [cfgp] + argv[2:] +
                       ["--fused-stack", "flat"])["NIR"]
        if res["steps"] != 2 * steps_per_epoch or \
                launches() != expect(wide_bwd=blocks * steps_per_epoch):
            raise AssertionError(f"train --mesh-model 2, resumed in one "
                                 f"process: {res['steps']} steps, launches "
                                 f"{launches()}")
        losses = train_losses(log_dir)
        if not all(np.isfinite(losses)) or not losses[-1] < first[0]:
            raise AssertionError(f"train --mesh-model 2 then one process: "
                                 f"losses {losses}")
        log(f"train --mesh-data 1 --mesh-model 2 (two gloo ranks on the "
            f"card, f32 flat, {steps_per_epoch} steps at batch 128): "
            f"launches a rank {got['counts']}; checkpoint "
            f"{os.path.basename(path)} holds the whole state, each rank's "
            f"parameters its part to the bit; resumed in one process (flat) "
            f"at step {step} for {steps_per_epoch} more steps: train loss "
            f"{first[0]:.3f} -> {losses[-1]:.3f}, val cPSNR "
            f"{res['val_psnr']:.3f} [{card}]")
    marks.append(("CLI", time.perf_counter()))
    parts = ", ".join(f"{name} {t - marks[i][1]:.1f}"
                      for i, (name, t) in enumerate(marks[1:]))
    log(f"mesh_model phase: {marks[-1][1] - marks[0][1]:.1f} s ({parts})")


# The one-step float32 train checks: (name, stack tier, fused_block,
# use_kernel, the variant it is held to, its launches per step).
STEP_KERNELS = dict(seg_fwd=12, conv_fwd=12, blk_bwd=12)
STEP_VARIANTS = (
    ("plain", "off", False, False, None, {}),
    ("t kernels", "t", False, False, "plain", STEP_KERNELS),
    ("flat", "flat", False, False, "plain", dict(wide_bwd=12)),
    ("fused_block", "off", True, False, "plain", dict(wide_bwd=12)),
    ("t kernels, kernel loss", "t", False, True, "t kernels",
     dict(STEP_KERNELS, shift_table_fwd=2, shift_table_bwd=1)))


def phase_train_step(torch, dev, card):
    """One float32 train step of each of STEP_VARIANTS from the same init
    on the same batch, held to its reference variant; returns the launch
    counts of the kernel-loss step (the path of the shift-table kernels).

    The loss agrees to 1e-5 relative (the forward stacks differ by
    summation order, ~1e-6; with the kernel loss the model is the same
    and the tables differ by summation order), the cPSNR metric to 1e-4
    (1e-5 relative for the kernel loss).  The gradients, taken first at
    the same init and batch, agree leaf by leaf norm-wise to STACK_TOL at
    float32, for the reason given there.  For the "t" kernels the
    parameters after the update are compared with plain in units of the
    learning rate: nadam's first update is +-1.47 lr for any gradient
    element well above its eps, so the two agree to a tiny fraction of lr
    except where a gradient element's sign differs between the two
    paths, which can only happen for elements within the paths' gradient
    difference (~1e-4 relative) of zero: at most 1e-3 of the parameters
    may differ by more than 0.01 lr."""
    from probav_tpu_torch.config import Config
    from probav_tpu_torch.tools.profile_train import (make_trainer,
                                                      synthetic_batch)

    cfg = Config.from_file(CFG)
    batch = tuple(torch.as_tensor(a, device=dev)
                  for a in synthetic_batch(cfg.batch_size, seed=2))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, tier, fused_block, use_kernel, _, per in STEP_VARIANTS:
            tr = make_trainer(cfg, "float32", tier, dev,
                              os.path.join(tmp, name.replace(" ", "_")),
                              use_kernel=use_kernel, fused_block=fused_block)
            grads = tr.loss_and_grads(*batch)[2]
            reset_launches()
            loss, metric = tr.train_step(*batch)
            torch.cuda.synchronize()
            counts = launches()
            if counts != expect(**per):
                raise AssertionError(f"one train step, {name}: launches "
                                     f"{counts}, expected {expect(**per)}")
            out[name] = dict(loss=float(loss), metric=float(metric),
                             grads=grads, counts=counts,
                             params={k: v.detach().clone()
                                     for k, v in tr.params.items()})
            tr.logger_.close()
            del tr
    lr, tol = cfg.learning_rate, STACK_TOL["float32"]
    for name, _, _, use_kernel, ref, _ in STEP_VARIANTS:
        if ref is None:
            continue
        a, b = out[name], out[ref]
        mtol = 1e-5 * abs(b["metric"]) if use_kernel else 1e-4
        if not abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]) or \
                not abs(a["metric"] - b["metric"]) <= mtol:
            raise AssertionError(f"one step, {name} vs {ref}: loss "
                                 f"{a['loss']} vs {b['loss']}, cPSNR "
                                 f"{a['metric']} vs {b['metric']}")
        gerr = {k: rel_l2(a["grads"][k], b["grads"][k]) for k in a["grads"]}
        gk = max(gerr, key=lambda k: gerr[k] if np.isfinite(gerr[k])
                 else np.inf)
        if not gerr[gk] <= tol:
            raise AssertionError(f"one step, {name} vs {ref}: gradient {gk} "
                                 f"||got-ref||/||ref|| {gerr[gk]:.3e} > "
                                 f"{tol:g}")
        msg = (f"train step f32 {name} vs {ref} (one step, batch "
               f"{cfg.batch_size}, launches {a['counts']}): loss "
               f"{a['loss']:.6f} vs {b['loss']:.6f}; cPSNR "
               f"{a['metric']:.4f} vs {b['metric']:.4f}; gradients of "
               f"{len(gerr)} leaves, worst ||got-ref||/||ref|| {gk} "
               f"{gerr[gk]:.3e} (tol {tol:g})")
        if name == "t kernels":
            pk, pp = a["params"], b["params"]
            diffs = torch.cat([(pk[k] - pp[k]).abs().flatten() / lr
                               for k in pk])
            share = float((diffs > 0.01).float().mean())
            if share > 1e-3:
                raise AssertionError(f"one step: {share:.2e} of the params "
                                     "differ by more than 0.01 lr")
            msg += (f"; params max |diff| {float(diffs.max()):.3e} lr, "
                    f"{share:.2e} of {diffs.numel()} beyond 0.01 lr")
        log(f"{msg} [{card}]")
    return out["t kernels, kernel loss"]["counts"]


def phase_train_warm(torch, dev, card):
    """Warm train-step throughput, timed as profile_train times it."""
    from probav_tpu_torch.config import Config
    from probav_tpu_torch.tools.profile_train import (VARIANTS, make_trainer,
                                                      synthetic_batch,
                                                      warm_step_rates)

    cfg = Config.from_file(CFG)
    batch = tuple(torch.as_tensor(a, device=dev)
                  for a in synthetic_batch(cfg.batch_size))
    with tempfile.TemporaryDirectory() as tmp:
        for name, dtype, tier, use_kernel in VARIANTS:
            tr = make_trainer(cfg, dtype, tier, dev,
                              os.path.join(tmp, name.replace(" ", "_")),
                              use_kernel=use_kernel)
            rates = warm_step_rates(tr, batch, WARM_TRAIN_STEPS)
            tr.logger_.close()
            del tr
            torch.cuda.empty_cache()
            log(f"warm train {name}: batch {cfg.batch_size}, median of "
                f"{WARM_TRAIN_STEPS} steps {statistics.median(rates):.1f} "
                f"patches/s (min {min(rates):.1f}, max {max(rates):.1f}) "
                f"[{card}]")


# The roofline phase: one warm train step of each of ROOFLINE_STEPS traced
# (tstack_roofline.step_roofline), with the launches a step of each hand
# kernel (and of each part of blk_bwd and wide_bwd) it must show; then the
# kernel stack at the 0.9411 model's ROOFLINE_FILTERS, both dtypes, held
# as phase_stack_grad holds the flagship's.
ROOFLINE_STEPS = (
    ("f32 t", "float32", "t", False, STEP_KERNELS),
    ("bf16 t, kernel loss", "bfloat16", "t", True,
     dict(STEP_KERNELS, shift_table_fwd=2, shift_table_bwd=1)),
    ("bf16 flat", "bfloat16", "flat", False, dict(wide_bwd=12)))
ROOFLINE_PARTS = {"blk_bwd": {"dd conv": 12, "wgrad": 12, "seg_bwd": 12,
                              "reduce": 12},
                  "wide_bwd": {"wide": 12, "reduce": 12}}
ROOFLINE_TOP, ROOFLINE_FILTERS, ROOFLINE_REPS = 5, 64, 2
ROOFLINE_WIDE_STEPS = 3


def phase_roofline(torch, ts, dev, card):
    """The hand kernels in real steps against their bounds, and the stack
    at ROOFLINE_FILTERS (see ROOFLINE_STEPS)."""
    from probav_tpu_torch.config import Config
    from probav_tpu_torch.tools import geom_sweep as gs
    from probav_tpu_torch.tools.tstack_roofline import (KERNELS,
                                                        report_lines,
                                                        step_roofline)

    cfg = Config.from_file(CFG)
    seen = set()
    for label, dn, tier, use_kernel, want in ROOFLINE_STEPS:
        rep = step_roofline(cfg, dn, tier, dev, use_kernel=use_kernel,
                            top=ROOFLINE_TOP, need=tuple(want), log=log)
        got = {k: r["launches_per_step"] for k, r in rep["kernels"].items()}
        parts = {k: {p: q["launches_per_step"]
                     for p, q in rep["kernels"][k]["parts"].items()}
                 for k in ROOFLINE_PARTS if k in got}
        if got != want or any(parts[k] != ROOFLINE_PARTS[k] for k in parts):
            raise AssertionError(f"roofline {label}: launches a step {got}, "
                                 f"parts {parts}; expected {want}")
        seen |= set(got)
        for ln in report_lines(rep):
            log(f"roofline {label}: {ln}")
        dgrad = [g for g in rep["library"]
                 if any("dgrad" in k.lower() for _, k in g["kernels"])]
        log(f"roofline {label}: the largest library group with a dgrad "
            "kernel: " + (f"{dgrad[0]['op']} {dgrad[0]['shapes']}, "
                          f"{dgrad[0]['ms_per_step']:.3f} ms a step"
                          if dgrad else f"none in the top {ROOFLINE_TOP}") +
            f" [{card}]")
    if seen != set(KERNELS):
        raise AssertionError(f"roofline: kernels found {sorted(seen)}, "
                             f"expected {KERNELS}")

    c, cmid, cdec = gs.widths(ROOFLINE_FILTERS)
    for dtype in (torch.float32, torch.bfloat16):
        hold_stack_kernels(torch, ts, dev, card,
                           f"stack gradient at {c}/{cmid}/{cdec}", dtype, c,
                           cmid, cdec)
        row = gs.run_width(torch, dev, dtype, ROOFLINE_FILTERS, N_PATCH,
                           reps=ROOFLINE_REPS)
        log(f"{gs.row_line(row)}; bounds a launch "
            + ", ".join(f"{k} {v:.4f} ms"
                        for k, v in row["bounds_per_launch"].items())
            + f" [{card}]")
        del row
        torch.cuda.empty_cache()

    # Warm bf16 and float32 train steps of the ROOFLINE_FILTERS model, the
    # "t" kernels and the "off" tier's cuDNN autograd, on one batch.
    from probav_tpu_torch.tools.profile_train import (make_trainer,
                                                      synthetic_batch,
                                                      warm_step_rates)
    cfg.flat["num_filters"] = ROOFLINE_FILTERS
    batch = tuple(torch.as_tensor(a, device=dev)
                  for a in synthetic_batch(cfg.batch_size, seed=2))
    steps = ROOFLINE_WIDE_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        for dn, tier in (("bfloat16", "t"), ("bfloat16", "off"),
                         ("float32", "t"), ("float32", "off")):
            tr = make_trainer(cfg, dn, tier, dev,
                              os.path.join(tmp, dn + tier))
            reset_launches()
            ms = [1e3 * cfg.batch_size / r
                  for r in warm_step_rates(tr, batch, steps)]
            got = launches()
            want = expect(**{k: v * (steps + 1)
                             for k, v in STEP_KERNELS.items()}) \
                if tier == "t" else expect()
            tr.logger_.close()
            del tr
            torch.cuda.empty_cache()
            if got != want:
                raise AssertionError(f"{dn} {tier} step at "
                                     f"{ROOFLINE_FILTERS} filters: launches "
                                     f"{got}, expected {want}")
            log(f"warm train step {dn} {tier} at {c}/{cmid}/{cdec} "
                f"({ROOFLINE_FILTERS} filters), batch {cfg.batch_size}: "
                f"median of {steps} {statistics.median(ms):.1f} ms (min "
                f"{min(ms):.1f}, max {max(ms):.1f}); launches {got} [{card}]")


# The phase of the other cfg losses and model types: the flagship cfg with
# each loss through the train CLI (MORE_EPOCHS epochs of TRAIN_N patches);
# the loss and d loss / d pred on the card against the CPU on one batch of
# 128 (occluded truth zeroed, pred = truth + N(0, 300^2)), held as
# tests/test_torch_sobel_msssim.py holds them to JAX; IWDSR at the flagship
# width through the CLI and its forward against the CPU on IWDSR_CPU_N
# patches (float32, MODEL_TOL); FuseNet through the CLI on FUSE_SCENES
# served 384^2 TRAIN scenes of each band at batch FUSE_BATCH, and one warm
# step at the cfg's batch of 128 scenes; v1 and v2 forwards on FUSE_CPU_N
# scenes against the CPU.
MORE_LOSSES = ("sobel_l1_mix", "l1msssim")
MORE_TOL = {"sobel_l1_mix": 1e-5, "l1msssim": 1e-4}
MORE_GRAD_TOL = 1e-4
MORE_EPOCHS, MORE_STEPS, MORE_BATCH = 2, 3, 128
IWDSR_CPU_N, IWDSR_TOL = 8, 1e-4
FUSE_SCENES, FUSE_BATCH, FUSE_CPU_N, FUSE_TOL = 12, 8, 2, 1e-4
FUSE_STEP_N = 128


def loss_batch(torch, n, seed):
    """(hr, mask, pred) [n, 48, 48, 1] on the CPU: the synthetic batch's
    truth with its occluded pixels zeroed, pred = truth + N(0, 300^2)."""
    from probav_tpu_torch.tools.profile_train import synthetic_batch

    _, hr, mask = synthetic_batch(n, seed=seed)
    pred = hr + np.random.default_rng(seed).normal(0, 300, hr.shape)
    return [torch.from_numpy(np.asarray(a, np.float32))
            for a in (hr * mask, mask, pred)]


def loss_grad(torch, fn, hr, mask, pred):
    p = pred.clone().requires_grad_()
    loss = fn(hr, mask, p)
    (g,) = torch.autograd.grad(loss, p)
    return loss.detach(), g


def warm_rate(torch, tr, batch):
    """(median patches/s of MORE_STEPS warm steps, peak GB allocated from
    the first of them on)."""
    from probav_tpu_torch.tools.profile_train import warm_step_rates

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = warm_step_rates(tr, batch, MORE_STEPS)
    return statistics.median(rates), torch.cuda.max_memory_allocated() / 1e9


def check_cli_run(name, res, steps, ckpt_dir, log_dir, got, want,
                  falling=True):
    """The train CLI's result: its steps, the checkpoint of the last step,
    the launch counts and a finite train loss, falling where ``falling``."""
    if res["steps"] != steps:
        raise AssertionError(f"{name}: {res['steps']} steps, not {steps}")
    if sorted(os.listdir(ckpt_dir))[-1] != f"step_{steps:08d}.pt":
        raise AssertionError(f"{name}: checkpoints "
                             f"{sorted(os.listdir(ckpt_dir))}")
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")
    losses = train_losses(log_dir)
    if not all(np.isfinite(losses)) or \
            (falling and not losses[-1] < losses[0]):
        raise AssertionError(f"{name}: losses {losses}")
    return losses


def write_served_tree(root, name, scenes, **overrides):
    """A cfg copy in root/name whose TRAIN output dir holds ``scenes``
    served 384^2 scenes of each band, numbered as serving RED and NIR
    writes them (RED first), and whose resolverDir holds both bands'
    stage-2 truths (10% masked, data kept); the served scene is the truth
    plus N(0, 200^2)."""
    from probav_tpu_torch.config import Config
    from probav_tpu_torch.infer.resolver import write_submission
    from probav_tpu_torch.utils.io import dump_masked

    base = os.path.join(root, name)
    resolver = os.path.join(base, "data", "resolverDir")
    os.makedirs(resolver)
    cfg_path = write_cfg(base, **overrides)
    cfg = Config.from_file(cfg_path)
    r = np.random.default_rng(11)
    for band in ("RED", "NIR"):
        hr = r.uniform(4000, 12000, (scenes, 384, 384))
        served = np.clip(hr + r.normal(0, 200, hr.shape), 0, 65535)
        write_submission(served[..., None].astype(np.uint16),
                         cfg.out_dir("TRAIN"), band, "TRAIN", removed=())
        hidden = r.uniform(size=hr.shape) < 0.1
        dump_masked(np.ma.masked_array(
            hr[:, None, None], mask=hidden[:, None, None]).astype(np.float32),
            os.path.join(resolver, f"TRAINimgHR_{band}.npy"))
    return cfg_path


def phase_train_more(torch, dev, card):
    """The train CLI's other cfg losses and model types on the card: (a)
    the flagship "t" step with sobel_l1_mix and with l1msssim, (b)
    --modelType iwdsr at float32 and bf16, (c) --modelType fusionNet and
    one step at 128 scenes of 384^2."""
    from probav_tpu_torch.config import Config
    from probav_tpu_torch.data.augment import split_indices
    from probav_tpu_torch.models.wdsr import FuseNetConv2D
    from probav_tpu_torch.ops.shift_loss import ShiftCompensatedLosses
    from probav_tpu_torch.tools.profile_train import (make_trainer,
                                                      synthetic_batch)
    from probav_tpu_torch.train import cli
    from probav_tpu_torch.train.optim import build_optimizer
    from probav_tpu_torch.train.trainer import ModelTrainer

    steps_per_epoch = TRAIN_N // MORE_BATCH
    steps = MORE_EPOCHS * steps_per_epoch
    evals = (MORE_EPOCHS + 1) * -(-VAL_N // MORE_BATCH)
    blocks = 12
    lr_b, _, _ = synthetic_batch(MORE_BATCH, seed=2)
    hr, mask, pred = loss_batch(torch, MORE_BATCH, seed=2)
    batch = tuple(torch.as_tensor(a, device=dev) for a in
                  (lr_b, hr.numpy(), mask.numpy()))
    losses = ShiftCompensatedLosses(target_shape=(48, 48, 1))
    fuse_losses = ShiftCompensatedLosses(target_shape=(384, 384, 1))
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the cfg losses on the "t" stack, float32.
        rates = {}
        for loss in ("l1",) + MORE_LOSSES:
            cfg, ckpt_dir, log_dir = write_train_tree(
                tmp, f"loss_{loss}", MORE_EPOCHS, loss=loss)
            if loss != "l1":
                reset_launches()
                t0 = time.perf_counter()
                res = cli.main(["--cfg", cfg, "--band", "NIR", "--eval-step",
                                str(steps_per_epoch), "--device", str(dev)])
                wall = time.perf_counter() - t0
                got = launches()
                want = expect(seg_fwd=blocks * (steps + evals),
                              conv_fwd=blocks * (steps + evals),
                              blk_bwd=blocks * steps)
                tl = check_cli_run(f"train {loss}", res["NIR"], steps,
                                   ckpt_dir, log_dir, got, want)
                fn = losses.by_name(loss)
                ref, gref = loss_grad(torch, fn, hr, mask, pred)
                val, g = loss_grad(torch, fn, *(a.to(dev)
                                                for a in (hr, mask, pred)))
                lerr = abs(float(val) - float(ref)) / abs(float(ref))
                gerr = rel_l2(g.cpu(), gref)
                if not lerr <= MORE_TOL[loss] or not gerr <= MORE_GRAD_TOL:
                    raise AssertionError(
                        f"{loss} card vs CPU: loss rel {lerr:.3e}, d/dpred "
                        f"||got-ref||/||ref|| {gerr:.3e}")
                log(f"train {loss}: {steps} steps at batch {MORE_BATCH}, "
                    f"f32 t, launches {got}; train loss {tl[0]:.4f} -> "
                    f"{tl[-1]:.4f}; {wall:.1f} s cold; card vs CPU on "
                    f"{MORE_BATCH} patches: loss {float(val):.6f} rel "
                    f"{lerr:.3e} (tol {MORE_TOL[loss]:g}), d/dpred "
                    f"{gerr:.3e} (tol {MORE_GRAD_TOL:g}) [{card}]")
            tr = make_trainer(Config.from_file(cfg), "float32", "t", dev,
                              os.path.join(tmp, f"warm_{loss}"))
            rates[loss] = warm_rate(torch, tr, batch)
            tr.logger_.close()
            del tr
            torch.cuda.empty_cache()
        pd = tuple(a.to(dev) for a in (hr, mask, pred))
        fns = [lambda f=losses.by_name(n): loss_grad(torch, f, *pd)
               for n in ("l1",) + MORE_LOSSES]
        ms, b2b = timed(torch, *fns), back_to_back(torch, *fns)
        for (name, (rate, peak)), t, tb in zip(rates.items(), ms, b2b):
            log(f"warm train f32 t, loss {name}: batch {MORE_BATCH}, "
                f"median of {MORE_STEPS} steps {rate:.1f} patches/s, peak "
                f"{peak:.2f} GB; the loss and d/dpred {t:.4f} ms a single "
                f"call (CUDA events, median of 20), {tb:.4f} ms back to "
                f"back [{card}]")

        # (b) IWDSR at the flagship width, float32 and bf16.
        for dn, flags in (("float32", []), ("bfloat16", ["--bf16"])):
            cfg, ckpt_dir, log_dir = write_train_tree(tmp, f"iwdsr_{dn}",
                                                      MORE_EPOCHS)
            reset_launches()
            t0 = time.perf_counter()
            res = cli.main(["--cfg", cfg, "--band", "NIR", "--eval-step",
                            str(steps_per_epoch), "--device", str(dev),
                            "--modelType", "iwdsr"] + flags)
            wall = time.perf_counter() - t0
            tl = check_cli_run(f"train iwdsr {dn}", res["NIR"], steps,
                               ckpt_dir, log_dir, launches(), expect())
            tr = make_trainer(Config.from_file(cfg), dn, None, dev,
                              os.path.join(tmp, f"warm_iwdsr_{dn}"),
                              model_type="iwdsr")
            rate, peak = warm_rate(torch, tr, batch)
            msg = (f"train iwdsr {dn}: {steps} steps at batch {MORE_BATCH}, "
                   f"no kernel launched; train loss {tl[0]:.4f} -> "
                   f"{tl[-1]:.4f}; {wall:.1f} s cold; warm median of "
                   f"{MORE_STEPS} steps {rate:.1f} patches/s "
                   f"({MORE_BATCH / rate * 1e3:.1f} ms a step), peak "
                   f"{peak:.2f} GB allocated")
            if dn == "float32":
                x = batch[0][:IWDSR_CPU_N]
                with torch.no_grad():
                    got = tr.model(x, tr.norm).cpu()
                    m = tr.model.cpu()
                    ref = m(x.cpu(), tr.norm.cpu())
                err, scale = check("iwdsr f32 card vs CPU", got, ref,
                                   IWDSR_TOL)
                msg += (f"; forward on {len(x)} patches card vs CPU "
                        f"max|diff| {err:.3e} (max|ref| {scale:.3e}, tol "
                        f"{IWDSR_TOL:g})")
            tr.logger_.close()
            del tr
            torch.cuda.empty_cache()
            log(f"{msg} [{card}]")

        # (c) FuseNet: the CLI on served scenes, one step at 128 scenes.
        cfg = write_served_tree(tmp, "fusenet", FUSE_SCENES,
                                batch_size=FUSE_BATCH, epochs=MORE_EPOCHS)
        cwd = os.getcwd()
        os.chdir(os.path.join(tmp, "fusenet"))
        try:
            reset_launches()
            t0 = time.perf_counter()
            res = cli.main(["--cfg", cfg, "--device", str(dev),
                            "--modelType", "fusionNet"])["NIR"]
            wall = time.perf_counter() - t0
            split = Config.from_file(cfg).split
            n_tr = len(split_indices(2 * FUSE_SCENES, split)[0])
            fsteps = MORE_EPOCHS * (n_tr // FUSE_BATCH)
            # 2 * FUSE_SCENES / FUSE_BATCH steps of a net that starts near
            # the identity: the loss is held finite, not falling.
            tl = check_cli_run("train fusionNet", res, fsteps,
                               "fuseNetCkpt", "fuseNetLogs", launches(),
                               expect(), falling=False)
        finally:
            os.chdir(cwd)
        log(f"train fusionNet: {2 * FUSE_SCENES} served 384^2 scenes (RED "
            f"first), {fsteps} steps at batch {FUSE_BATCH}; train loss "
            f"{tl[0]:.3f} -> {tl[-1]:.3f}; val cPSNR {res['val_psnr']:.3f}; "
            f"{wall:.1f} s cold [{card}]")
        r = np.random.default_rng(5)
        truth = r.uniform(4000, 12000, (FUSE_STEP_N, 384, 384, 1))
        scenes = [truth + r.normal(0, 200, truth.shape), truth,
                  r.uniform(size=truth.shape) < 0.9]
        fbatch = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                       for a in scenes)
        del truth, scenes
        fcfg = Config.from_file(cfg)
        tr = ModelTrainer(
            FuseNetConv2D(generator=torch.Generator().manual_seed(0)),
            fuse_losses.l1, fuse_losses.cpsnr,
            build_optimizer(fcfg.optimizer, fcfg.learning_rate),
            ckpt_dir=os.path.join(tmp, "warm_fusenet", "ckpt"),
            log_dir=os.path.join(tmp, "warm_fusenet", "logs"), device=dev)
        tr.init_state()
        t0 = time.perf_counter()
        tr.train_step(*fbatch)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = tr.train_step(*fbatch)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not np.isfinite(float(loss)):
            raise AssertionError(f"fusenet step: loss {float(loss)}")
        tr.logger_.close()
        del tr, fbatch
        torch.cuda.empty_cache()
        log(f"fusenet v3 step f32: {FUSE_STEP_N} scenes of 384^2, warm "
            f"{warm:.3f} s ({FUSE_STEP_N / warm:.2f} scenes/s; first step "
            f"{cold:.3f} s), peak "
            f"{peak:.2f} GB allocated, loss {float(loss):.3f} [{card}]")
        x = torch.rand(FUSE_CPU_N, 384, 384, 1,
                       generator=torch.Generator().manual_seed(3))
        for variant in ("v1", "v2"):
            m = FuseNetConv2D(variant,
                              generator=torch.Generator().manual_seed(4))
            with torch.no_grad():
                ref = m(x) - x
                got = m.to(dev)(x.to(dev)).cpu() - x
            err, scale = check(f"fusenet {variant} card vs CPU", got, ref,
                               FUSE_TOL)
            log(f"fusenet {variant} forward on {FUSE_CPU_N} scenes card vs "
                f"CPU: max|diff| of the correction {err:.3e} (max|ref| "
                f"{scale:.3e}, tol {FUSE_TOL:g}) [{card}]")


# The preprocess phase: a raw NIR tree of PRE_TRAIN train and PRE_TEST test
# scenes at the ESA geometry (128^2 LR and QM frames, PRE_FRAMES of them a
# scene, drawn per scene; 384^2 HR and SM), each frame a window of one
# smooth field moved by an integer shift within +-PRE_SHIFT px.
PRE_TRAIN, PRE_TEST, PRE_FRAMES, PRE_SHIFT = 24, 8, (9, 19), 3
PRE_LR = 128


def write_raw_tree(raw, seed=0):
    """The raw tree, written with the port's PNG writer; returns each
    scene's planted (dy, dx) per frame, in file order, train then test.
    Frame f is field[y + dy_f, x + dx_f], so aligning it to a reference
    frame r takes (dy_f - dy_r, dx_f - dx_r).  Every third frame from the
    second has a 24^2 block occluded in its QM; SM hides a 6^2 corner."""
    from scipy import ndimage

    from probav_tpu_torch.utils.png import write_png

    r = np.random.default_rng(seed)
    size, pad = PRE_LR, PRE_SHIFT
    planted = []
    for split, n in (("train", PRE_TRAIN), ("test", PRE_TEST)):
        for s in range(n):
            d = os.path.join(raw, split, "NIR", f"imgset{s:04d}")
            os.makedirs(d)
            field = ndimage.gaussian_filter(
                r.normal(size=(size + 2 * pad,) * 2), 2.0)
            field = 8000 + 3000 * field / field.std()
            frames = int(r.integers(PRE_FRAMES[0], PRE_FRAMES[1] + 1))
            shifts = r.integers(-pad, pad + 1, size=(frames, 2))
            for f, (dy, dx) in enumerate(shifts):
                win = field[pad + dy:pad + dy + size, pad + dx:pad + dx + size]
                write_png(os.path.join(d, f"LR{f:03d}.png"),
                          win + r.normal(0, 30, win.shape))
                qm = np.full((size, size), 65535)
                if f % 3 == 1:
                    y0, x0 = r.integers(0, size - 24, size=2)
                    qm[y0:y0 + 24, x0:x0 + 24] = 0
                write_png(os.path.join(d, f"QM{f:03d}.png"), qm)
            if split == "train":
                hr = np.kron(field[pad:pad + size, pad:pad + size],
                             np.ones((3, 3)))
                write_png(os.path.join(d, "HR.png"), hr)
                sm = np.full(hr.shape, 65535)
                sm[:6, :6] = 0
                write_png(os.path.join(d, "SM.png"), sm)
            planted.append(shifts)
    return planted


def check_registration(torch, dev, card, stage1, planted, tech):
    """Registration of the stage-1 scenes with the torch backend on the
    card (a cold call, then a warm one) and the numpy backend on the host:
    the same shift for every frame, the planted ones; for 'freq' also the
    same registered arrays, exactly ('time' resamples on the host with
    scipy's cubic spline, equal to the card's gather only to rounding)."""
    from probav_tpu_torch.ops import registration as reg

    imgs, msks = stage1
    rates = []
    for _ in range(2):
        reg.reset_chunks()
        t0 = time.perf_counter()
        out, shifts = reg.register_scenes_torch(imgs, msks, dev, tech=tech,
                                                return_shifts=True)
        rates.append(len(imgs) / (time.perf_counter() - t0))
        if set(reg.CHUNKS) != {dev.type}:
            raise AssertionError(f"registration {tech}: device calls "
                                 f"{reg.CHUNKS}, none on {dev}")
    t0 = time.perf_counter()
    host = [reg.register_image_set(i, m, tech=tech, return_shifts=True)
            for i, m in zip(imgs, msks)]
    host_rate = len(imgs) / (time.perf_counter() - t0)
    frames = 0
    for s, (img, msk, got, sh, (want, wsh)) in enumerate(
            zip(imgs, msks, out, shifts, host)):
        order = np.argsort([-np.count_nonzero(m) for m in msk])
        truth = planted[s][order] - planted[s][order[0]]
        if not (np.array_equal(sh, wsh[:, 1:]) and
                np.array_equal(sh, truth)):
            raise AssertionError(f"registration {tech} scene {s}: card "
                                 f"{sh.tolist()}, host {wsh.tolist()}, "
                                 f"planted {truth.tolist()}")
        if tech == "freq" and not (
                np.array_equal(got.data, want.data) and
                np.array_equal(got.mask, want.mask)):
            raise AssertionError(f"registration freq scene {s}: card and "
                                 f"host arrays differ")
        frames += len(img)
    log(f"registration {tech}: {len(imgs)} scenes ({frames} frames of "
        f"{PRE_LR}^2), torch on {dev} {rates[0]:.2f} scenes/s cold, "
        f"{rates[1]:.2f} warm; numpy on the host {host_rate:.2f} scenes/s; "
        f"every shift equal between the two and to the planted one"
        f"{', registered arrays equal' if tech == 'freq' else ''} [{card}]")


def phase_preprocess(torch, dev, card):
    """The preprocessing stage on the card and the chain after it: a raw
    NIR tree written with the port's PNG writer; ``preprocess.main`` with
    registration on the card, all five stages with 'freq'; the train CLI
    (float32, "t" stack, one epoch at batch 128) on its stage-5 arrays,
    the serve CLI --totest TRAIN without --params (the trainer's newest
    checkpoint), ``evaluate.main`` against its stage-2 TRAINimgHR.  Then
    stages 1-2 with the host backend (trimmed arrays equal), registration
    of the stage-1 scenes on the card against the host for both
    techniques, and stages 1-2 with 'time' on the card."""
    from probav_tpu_torch import evaluate, preprocess, serve
    from probav_tpu_torch.config import Config
    from probav_tpu_torch.data import ingest
    from probav_tpu_torch.ops import registration as reg
    from probav_tpu_torch.train import cli

    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "raw")
        t0 = time.perf_counter()
        planted = write_raw_tree(raw)
        log(f"preprocess: raw tree of {PRE_TRAIN} + {PRE_TEST} scenes, "
            f"{sum(map(len, planted))} LR frames, written in "
            f"{time.perf_counter() - t0:.1f} s")

        def tree(name, **keys):
            base = os.path.join(tmp, name)
            os.makedirs(base)
            return base, write_cfg(base, raw_data=raw, epochs=1, **keys)

        base, cfg = tree("freq")
        reset_launches()
        reg.reset_chunks()
        t0 = time.perf_counter()
        st = preprocess.main(["--cfg", cfg, "--band", "NIR",
                              "--device", str(dev)])
        pre_s = time.perf_counter() - t0
        buckets = {len(p) for p in planted[:PRE_TRAIN]}, \
            {len(p) for p in planted[PRE_TRAIN:]}
        if reg.CHUNKS != {dev.type: sum(map(len, buckets))}:
            raise AssertionError(f"preprocess: registration calls "
                                 f"{reg.CHUNKS}, expected one per frame "
                                 f"count and split on {dev}")
        if launches() != expect():
            raise AssertionError(f"preprocess: launches {launches()}")
        sec = st["seconds"]
        log(f"preprocess freq, registration torch on {dev}: stage 1 "
            f"{st['scenes'][1] / sec[1]:.2f} scenes/s, stage 2 "
            f"{st['scenes'][2] / sec[2]:.2f} scenes/s (registration "
            f"{st['register_s']:.3f} s of {sec[2]:.3f}), stages 3-5 "
            f"{sec[3]:.3f} + {sec[4]:.3f} + {sec[5]:.3f} s; "
            f"{reg.CHUNKS[dev.type]} registration calls on {dev}; all five "
            f"stages {pre_s:.1f} s, first calls included [{card}]")

        c = Config.from_file(cfg)
        t1 = time.perf_counter()
        res = cli.main(["--cfg", cfg, "--band", "NIR", "--device", str(dev)])
        train_s = time.perf_counter() - t1
        got = launches()
        steps = res["NIR"]["steps"]
        if not (steps > 0 and np.isfinite(res["NIR"]["train_loss"]) and
                got["blk_bwd"] == c.num_res_blocks * steps and
                got["seg_fwd"] > 0):
            raise AssertionError(f"chain train: {res}, launches {got}")
        reset_launches()
        t1 = time.perf_counter()
        served = serve.main(["--cfg", cfg, "--band", "NIR", "--totest",
                             "TRAIN", "--device", str(dev)])
        serve_s = time.perf_counter() - t1
        n_served = len(served["written"])
        with open(os.path.join(base, "data", "removedTrainSetsNIR.txt")) as f:
            removed = len(f.read().split())
        if not (n_served == PRE_TRAIN - removed and
                launches()["conv_fwd"] > 0):
            raise AssertionError(f"chain serve: {n_served} scenes, "
                                 f"launches {launches()}")
        out = os.path.dirname(served["written"][0])
        t1 = time.perf_counter()
        report = evaluate.main(["--cfg", cfg, "--benchmark", out,
                                "--toCompare", out, "--bands", "NIR",
                                "--red-count", "0", "--device", str(dev),
                                "--out", os.path.join(base, "cmp.png")])
        eval_s = time.perf_counter() - t1
        chain_s = time.perf_counter() - t0
        nir = report["bands"]["NIR"]
        if not (nir["scenes"] == n_served and
                np.isfinite(nir["candidate_mean_cpsnr"])):
            raise AssertionError(f"chain evaluate: {report}")
        log(f"chain raw PNGs -> stages 1-5 on {dev} -> train -> serve from "
            f"the checkpoint -> score: {chain_s:.1f} s (preprocess "
            f"{pre_s:.1f}, train {steps} float32 't' steps at batch "
            f"{c.batch_size} "
            f"{train_s:.1f}, serve {n_served} TRAIN scenes {serve_s:.1f}, "
            f"evaluate {eval_s:.1f}); mean cPSNR {nir['candidate_mean_cpsnr']:.3f}"
            f" dB over {nir['scenes']} scenes, every one finite [{card}]")

        hbase, hcfg = tree("host")
        preprocess.main(["--cfg", hcfg, "--band", "NIR", "--ckpt", "1,2",
                         "--reg-backend", "numpy"])
        for name in sorted(os.listdir(os.path.join(base, "data",
                                                   "trimmedArrayDir"))):
            a, b = (np.load(os.path.join(d, "data", "trimmedArrayDir", name),
                            allow_pickle=True) for d in (base, hbase))
            if not (a.shape == b.shape and np.array_equal(a.data, b.data)
                    and np.array_equal(a.mask, b.mask)):
                raise AssertionError(f"stage 2 {name}: card and host "
                                     f"backends differ")
        (img, msk, _, _), (img_t, msk_t) = ingest.load_data(
            os.path.join(base, "data", "arrayDir"), "NIR")
        stage1 = (list(img) + list(img_t), list(msk) + list(msk_t))
        for tech in ("freq", "time"):
            check_registration(torch, dev, card, stage1, planted, tech)

        tbase, tcfg = tree("time")
        reg.reset_chunks()
        st = preprocess.main(["--cfg", tcfg, "--band", "NIR", "--ckpt",
                              "1,2", "--tech", "time", "--device", str(dev)])
        if set(reg.CHUNKS) != {dev.type}:
            raise AssertionError(f"preprocess time: calls {reg.CHUNKS}")
        sec = st["seconds"]
        log(f"preprocess time, registration torch on {dev}: stage 1 "
            f"{st['scenes'][1] / sec[1]:.2f} scenes/s, stage 2 "
            f"{st['scenes'][2] / sec[2]:.2f} scenes/s (registration "
            f"{st['register_s']:.3f} s of {sec[2]:.3f}) [{card}]")


# The rehearsal phase: 1% of the ESA scene counts, one epoch.
REHEARSAL_SCALE, REHEARSAL_EPOCHS = 0.01, 1
REHEARSAL_COUNTS = {"RED_train": 6, "NIR_train": 7, "RED_test": 2,
                    "NIR_test": 2}


# The convergence gate: (arm key, dtype, tier), the JAX tool's steps and
# its threshold (bf16_convergence.GATE_DB).  The "off" arms launch no hand
# kernel, so they train while nvcc builds the kernels (main).
CONV_ARMS = (("f32", "f32", "off"), ("bf16", "bf16", "t"),
             ("bf16_plain", "bf16", "off"))
CONV_STEPS = 400


def convergence_arms(torch, dev, tiers):
    """The arms of CONV_ARMS on ``tiers`` (module docstring, 10a), each
    from the one seeded init, with its step count and launches checked:
    {key: (run_one's result, launches)}."""
    from probav_tpu_torch.tools import bf16_convergence as bc

    data = bc.make_dataset(np.random.default_rng(123))
    init = bc.seeded_init()
    n_val = len(data[0]) // 5
    train_steps = (len(data[0]) - n_val) // 128
    steps = -(-CONV_STEPS // train_steps) * train_steps
    val_batches = -(-n_val // 128)
    out = {}
    for key, dtype_name, tier in CONV_ARMS:
        if tier not in tiers:
            continue
        reset_launches()
        res = bc.run_one(dtype_name, data, CONV_STEPS, fused_stack=tier,
                         device=str(dev), init=init)
        counts = launches()
        torch.cuda.empty_cache()
        if res["steps"] != steps:
            raise AssertionError(f"convergence {key}: {res['steps']} "
                                 f"steps, expected {steps}")
        # fit_device's final validation and the tool's own.
        fwd = 12 * (steps + 2 * val_batches)
        want = expect(seg_fwd=fwd, conv_fwd=fwd, blk_bwd=12 * steps) \
            if tier == "t" else expect()
        if counts != want:
            raise AssertionError(f"convergence {key}: launches {counts}, "
                                 f"expected {want}")
        out[key] = (res, counts)
    return out


def phase_convergence_plain(torch, dev, card):
    """The gate's "off" arms (float32 and bf16), run during the build."""
    return convergence_arms(torch, dev, ("off",))


def phase_convergence(torch, dev, card, plain):
    """The gate's bf16 "t" arm, then the gate over it and ``plain``
    (phase_convergence_plain's arms)."""
    from probav_tpu_torch.tools import bf16_convergence as bc

    runs = dict(plain, **convergence_arms(torch, dev, ("t",)))
    arms = {key: res for key, (res, _) in runs.items()}
    res = bc.gate(arms["f32"], arms["bf16"], 32, arms["bf16_plain"])
    log("convergence: " + "; ".join(
        f"{key} ({dn} {tier}) val cPSNR {arms[key]['val_cpsnr']:.4f} dB, "
        f"val loss {arms[key]['val_loss']:.4f}, {arms[key]['seconds']} s"
        for key, dn, tier in CONV_ARMS)
        + f"; delta_db {res['delta_db']}, kernel_delta_db "
        f"{res['kernel_delta_db']} (gate {bc.GATE_DB}); launches on the "
        f"bf16 t arm: " + ", ".join(f"{k} {v}" for k, v in
                                   runs["bf16"][1].items() if v)
        + f" [{card}]")
    log("convergence JSON: " + json.dumps(dict(res, tf32=False, card=card)))
    if not bc.passed(res):
        raise AssertionError(f"convergence gate failed: delta_db "
                             f"{res['delta_db']}, kernel_delta_db "
                             f"{res['kernel_delta_db']} > {bc.GATE_DB}")


def phase_rehearsal(card):
    """The port's four CLIs as subprocesses through the rehearsal tool on
    the card at REHEARSAL_SCALE (the flagship net, the "t" kernels in
    training and serving): every stage's exit 0 and a peak RSS, a
    device-memory peak above 0 in the train and serve stages, a finite
    score."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run(
            [sys.executable, "-m", "probav_tpu_torch.tools.full_rehearsal",
             "--workdir", tmp, "--scale", str(REHEARSAL_SCALE),
             "--epochs", str(REHEARSAL_EPOCHS), "--fused", "t"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"rehearsal exited {r.returncode}:\n"
                                 f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        with open(os.path.join(tmp, "rehearsal_report.json")) as f:
            rep = json.load(f)
    bands = ("NIR", "RED")
    stages = [f"preprocess_{b}" for b in bands] + \
        [f"train_BOTH_{REHEARSAL_EPOCHS}ep"] + \
        [f"serve_{t}_{b}" for t in ("TEST", "TRAIN") for b in bands] + \
        ["evaluate"]
    steps = rep["steps"]
    bad = [s for s in stages if steps.get(s, {}).get("exit") != 0 or
           not steps[s]["peak_rss_gb"] > 0]
    flat = [s for s in stages if s.startswith(("train", "serve")) and
            not steps[s]["device_peak_gb"] > 0]
    if bad or flat or rep["counts"] != REHEARSAL_COUNTS or \
            not np.isfinite(rep["score"]["normalized_score"]):
        raise AssertionError(f"rehearsal: stages not at exit 0 or with no "
                             f"RSS {bad}, no device memory {flat}: "
                             f"{json.dumps(rep)}")
    log(f"rehearsal report: {json.dumps(rep)}")
    log(f"rehearsal at --scale {REHEARSAL_SCALE} ({rep['counts']}), the "
        f"four CLIs as {len(stages)} subprocesses on the card, every stage "
        f"exit 0: "
        + ", ".join(f"{s} {steps[s]['wall_s']:.1f} s / RSS "
                    f"{steps[s]['peak_rss_gb']:.2f} GB / device "
                    f"{steps[s]['device_peak_gb']:.2f} GB" for s in stages)
        + f"; normalized score {rep['score']['normalized_score']:.4f}; "
        f"the phase {time.perf_counter() - t0:.1f} s [{card}]")


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

    secs = []

    def phase(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs.append((fn.__name__[len("phase_"):], time.perf_counter() - t0))
        log(f"phase {secs[-1][0]}: {secs[-1][1]:.1f} s")
        return out

    # nvcc builds the kernels in a thread while the convergence gate's
    # "off" arms, which launch none, train on the card.
    with ThreadPoolExecutor(1) as pool:
        build = pool.submit(_build.build, verbose=True)
        plain_arms = phase(phase_convergence_plain, torch, dev, card)
        path, build_s, report = build.result()
    ptxas = [ln.strip() for ln in report.splitlines()
             if "Function properties" in ln or "registers" in ln
             or "spill" in ln]
    print("\n".join(ptxas), file=sys.stderr)
    per_source = [ln[len("compiled "):] for ln in report.splitlines()
                  if ln.startswith("compiled ")]
    log(f"build: {os.path.relpath(path, ROOT)} in {build_s:.1f} s (nvcc "
        f"{' '.join(_build.NVCC_FLAGS)}, one process per source: "
        f"{'; '.join(per_source)})")

    rows = phase(phase_kernels, torch, ts, dev, card)
    phase(phase_widths, torch, ts, dev, card)
    phase(phase_model, torch, dev, card)
    phase(phase_stack_grad, torch, ts, dev, card)
    serve_launches = phase(phase_serve, torch, dev, card)
    phase(phase_warm, torch, dev, card)
    train_launches = phase(phase_train, torch, dev, card)
    phase(phase_train_device, torch, dev, card)
    phase(phase_mesh, torch, dev, card)
    phase(phase_mesh_model, torch, dev, card)
    loss_launches = phase(phase_train_step, torch, dev, card)
    phase(phase_train_warm, torch, dev, card)
    phase(phase_roofline, torch, ts, dev, card)
    phase(phase_train_more, torch, dev, card)
    phase(phase_convergence, torch, dev, card, plain_arms)
    phase(phase_preprocess, torch, dev, card)
    phase(phase_rehearsal, card)
    log(f"phases: {sum(t for _, t in secs):.1f} s (" +
        ", ".join(f"{n} {t:.1f}" for n, t in secs) + ")")

    # (name, source, the TPU kernel it replaces, the path whose counts
    # are its launches: each path's counts were reset just before it ran).
    # seg_fwd and conv_fwd are counted on the serve path, blk_bwd on the
    # bf16 train CLI run, wide_bwd on the bf16 --fused-stack flat run, the
    # shift tables on the float32 train step with the kernel loss.
    table = (
        ("seg_fwd", "tstack.cu", "pallas_tstack.py:244", serve_launches),
        ("conv_fwd", "tstack.cu", "pallas_tstack.py:290", serve_launches),
        ("blk_bwd", "blk_bwd.cu", "pallas_tstack.py:388",
         train_launches["bf16"]),
        ("wide_bwd", "blk_bwd.cu", "pallas_wide_block.py:110",
         train_launches["bf16 flat"]),
        ("shift_table_fwd", "shift_loss.cu", "pallas_shift_loss.py:108",
         loss_launches),
        ("shift_table_bwd", "shift_loss.cu", "pallas_shift_loss.py:126",
         loss_launches))
    kernels = []
    for name, src, tpu, counts in table:
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on its path")
        dn = "float32" if name.startswith("shift") else "bfloat16"
        kernels.append({"name": name, "route": "cuda",
                        "source": "probav_tpu_torch/csrc/" + src,
                        "replaces": "probav_tpu/ops/" + tpu,
                        "launches": counts[name], **rows[(name, dn)]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
