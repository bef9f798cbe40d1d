"""The port's one copy of the hand kernels' costs and its roofline tool
(``probav_tpu_torch/tools/tstack_roofline.py``), on the CPU: the bounds at
the flagship's shapes, the FLOPs against PyTorch's own counter over the
plain twins, the trace reader on a Chrome trace of the card's form, and
``kernel_ms``'s captures; ``geom_sweep``'s widths and refusal.  No nvcc
and no card are needed."""

import json
import types
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from probav_tpu_torch.config import Config
from probav_tpu_torch.ops import _build
from probav_tpu_torch.ops import tstack as ts
from probav_tpu_torch.ops import wide_block as wb
from probav_tpu_torch.tools import geom_sweep as gs
from probav_tpu_torch.tools import tstack_roofline as rf
from probav_tpu_torch.tools.dyadic import blk_bwd_inputs, wide_bwd_inputs

torch.set_num_threads(1)

CFG = str(Path(__file__).resolve().parent.parent / "cfg" /
          "p16t9c85r12.cfg")
N = 128 * 22 * 22 * 9
# PERF.md section 6: the bound of each kernel (f32, bf16) at the flagship.
FLAGSHIP = {"seg_fwd": (0.0987, 0.0190), "conv_fwd": (0.1461, 0.0296),
            "blk_bwd": (0.5449, 0.0909), "wide_bwd": (0.2528, 0.0935)}
PARTS = {"dd conv": (0.1461, 0.0244), "wgrad": (0.1461, 0.0244),
         "seg_bwd": (0.2528, 0.0421), "reduce": (0.0116, 0.0116)}
# The 0.9411 model's widths, 64/512/51.
WIDE64 = {("bfloat16", "seg_fwd"): 0.0664, ("bfloat16", "conv_fwd"): 0.0994,
          ("bfloat16", "blk_bwd"): 0.3685, ("bfloat16", "wide_bwd"): 0.3764,
          ("float32", "conv_fwd"): 0.5960, ("float32", "blk_bwd"): 2.2099}


def test_flagship_bounds_equal_perf_table_without_nvcc():
    """Every flagship bound to 4 decimals, computed without building or
    asking the kernels (this machine has no nvcc)."""
    for i, dn in enumerate(("float32", "bfloat16")):
        for k, want in FLAGSHIP.items():
            assert round(rf.kernel_costs(k, N, 32, 256, 25, dn)["bound_ms"],
                         4) == want[i], (k, dn)
        parts = rf.blk_bwd_part_costs(N, 32, 256, 25, dn)
        assert parts["reduce"]["bytes"] == 4 * 265 * rf.blk_bwd_slot(32, 256,
                                                                     25)
        for p, want in PARTS.items():
            assert round(parts[p]["bound_ms"], 4) == want[i], (p, dn)
        for (d, k), want in WIDE64.items():
            if d == dn:
                assert round(rf.kernel_costs(k, N, 64, 512, 51, dn)[
                    "bound_ms"], 4) == want, (k, dn)
    for hw, b, fwd, bwd in ((48, 128, 0.0012, 0.0027),
                            (384, 16, 0.0118, 0.0269)):
        assert round(rf.shift_costs("shift_table_fwd", b, hw, 3)["bound_ms"],
                     4) == fwd
        assert round(rf.shift_costs("shift_table_bwd", b, hw, 3)["bound_ms"],
                     4) == bwd
    # f32 seg_fwd on the CUDA cores: a second figure, never the bound.
    seg = rf.kernel_costs("seg_fwd", N, 32, 256, 25, "float32")
    assert round(seg["cuda_core_ms"], 4) == 0.2429
    assert round(seg["bound_ms"], 4) == 0.0987
    assert _build.library.cache_info().currsize == 0


def test_step_costs_read_the_cfg_shapes():
    """A train step of the flagship cfg gives the kernels 557,568 rows at
    32/256/25 and the shift tables 128 planes of 48^2 with border 3; at
    --filters 64 the widths follow the cfg's rates."""
    cfg = Config.from_file(CFG)
    shapes = rf.step_shapes(cfg)
    assert shapes == dict(n=N, c=32, cmid=256, cdec=25, blocks=12,
                          shift=(128, 48, 3))
    wide = rf.step_shapes(cfg, filters=64)
    assert (wide["c"], wide["cmid"], wide["cdec"]) == (64, 512, 51)
    costs = rf.step_costs(shapes, "bfloat16")
    assert set(costs) == set(rf.KERNELS)
    assert set(costs["blk_bwd"][1]) == set(rf.BLK_BWD_PARTS)
    assert round(costs["wide_bwd"][1]["reduce"]["bound_ms"], 4) == 0.0024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flops_equal_the_flop_counter_over_the_plain_twins(dtype):
    """``flops`` of seg_fwd, conv_fwd, blk_bwd and wide_bwd equals
    torch.utils.flop_counter's count over their plain twins at 2x5x5x3
    rows, widths 8/32/6.  The counter counts products (mm, convolution,
    convolution_backward) once each and leaves out the bias adds, relu and
    the reductions, as ``flops`` does; the bound's weighting (3xTF32 at
    float32, three bf16 products where bf16 wide_bwd has a float32
    operand) is ``ops``, checked beside it."""
    dn = str(dtype).split(".")[1]
    vol, (c, cmid, cdec) = (2, 5, 5, 3), (8, 32, 6)
    n = 2 * 5 * 5 * 3
    g = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g).to(dtype)
    x, d5, x5 = rn(n, c), rn(*vol, cdec), rn(*vol, c)
    blk = blk_bwd_inputs(vol, c, cmid, cdec, seed=3, dtype=dtype)
    wide = wide_bwd_inputs(n, c, cmid, cdec, seed=5, dtype=dtype)
    calls = {
        "seg_fwd": lambda: ts.seg_fwd_plain(x, rn(c, cmid), rn(cmid),
                                            rn(cmid, cdec), rn(cdec)),
        "conv_fwd": lambda: ts.conv_fwd_plain(d5, x5, rn(3, 3, 3, cdec, c),
                                              rn(c)),
        "blk_bwd": lambda: ts.blk_bwd_plain(*blk),
        "wide_bwd": lambda: wb.wide_bwd_plain(*wide)}
    for name, call in calls.items():
        with FlopCounterMode(display=False) as counter:
            call()
        cost = rf.kernel_costs(name, n, c, cmid, cdec, dn)
        assert cost["flops"] == counter.get_total_flops(), name
        one = 2 * n * cmid * (2 * c + cdec)
        want = (3 * cost["flops"] if dn == "float32" else
                cost["flops"] + (2 * one if name == "wide_bwd" else 0))
        assert cost["ops"] == want, name


def test_conv_cost_reads_a_recorded_convolution(tmp_path):
    """conv_cost on the ops of a real profiler trace (CPU, input shapes
    recorded): a forward with a stride, a transposed one (as blk_bwd's
    plain twin and the flat tier's backward run it) and the backward's
    two passes equal the flop counter's counts."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(2, 4, 5, 5, 3, requires_grad=True)
    w = torch.randn(6, 4, 3, 3, 3, requires_grad=True)
    y = torch.randn(2, 6, 5, 5, 3)
    run = lambda: (torch.nn.functional.conv3d(
        x, w, padding=1, stride=(1, 2, 1)).sum().backward(),
        torch.nn.functional.conv_transpose3d(y, w.detach(), padding=1))
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        run()
    with FlopCounterMode(display=False) as counter:
        run()
    counts = {str(k): v for k, v in counter.get_flop_counts()[
        "Global"].items()}
    p.export_chrome_trace(str(tmp_path / "t.json"))
    events = rf.load_trace(str(tmp_path / "t.json"))
    got = {}
    for e in events:
        if e.get("name") in rf.CONV_OPS:
            got[e["name"]] = got.get(e["name"], 0) + rf.conv_cost(e)["flops"]
    assert got == {"aten::convolution": counts["aten.convolution"],
                   "aten::convolution_backward":
                       counts["aten.convolution_backward"]}
    transposed = [rf.conv_cost(e) for e in events
                  if e.get("name") == "aten::convolution" and
                  e["args"]["Input Dims"][0] == [2, 6, 5, 5, 3]]
    assert transposed[0]["bytes"] == 4 * (2 * 6 * 75 + 6 * 4 * 27 +
                                          2 * 4 * 75)


NS = "(anonymous namespace)::"
ARGS = "(float const*, float const*, float*, int, int)"
# (name as the card's profiler prints it, (kernel, part), dur us a launch)
NAMES = (
    (NS + "seg_fwd_tf32_kernel" + ARGS, ("seg_fwd", None), 300.0),
    (NS + "conv_ring_kernel<float, 32, 4, 6, 2, true>" + ARGS,
     ("conv_fwd", None), 700.0),
    (NS + "conv_ring_kernel<float, 32, 4, 6, 2, false>" + ARGS,
     ("blk_bwd", "dd conv"), 600.0),
    (NS + "wgrad_ring_kernel" + ARGS, ("blk_bwd", "wgrad"), 500.0),
    (NS + "seg_bwd_tf32_kernel" + ARGS, ("blk_bwd", "seg_bwd"), 900.0),
    (NS + "reduce_partials_kernel(float const*, float*, int, long, long, "
     "int)", (None, "reduce"), 15.0),
    (NS + "shift_table_kernel<false, false>" + ARGS,
     ("shift_table_fwd", None), 13.0),
    (NS + "shift_table_kernel<true, false>" + ARGS,
     ("shift_table_bwd", None), 24.0))


def test_hand_kernel_files_each_name():
    for name, want, _ in NAMES:
        assert rf.hand_kernel(name) == want, name
    assert rf.hand_kernel(NS + "seg_bwd_kernel<float, 32, 32, true>" +
                          ARGS) == ("wide_bwd", "wide")
    assert rf.hand_kernel(NS + "seg_bwd_kernel<float, 32, 32, false>" +
                          ARGS) == ("blk_bwd", "seg_bwd")
    assert rf.hand_kernel(NS + "wide_bwd_bf16_kernel" + ARGS) == \
        ("wide_bwd", "wide")
    for name in ("seg_fwd_kernel<64, 64>", "seg_fwd_tf32_wide_kernel<8, 7>",
                 "seg_fwd_tf32_wide_kernel<6, 5>"):
        assert rf.hand_kernel(NS + name + ARGS) == ("seg_fwd", None), name
        assert not rf.is_tail(NS + name + ARGS)
    assert rf.hand_kernel("void at::native::reduce_kernel<512, 1, "
                          "at::native::ReduceOp<float>>(float*)") is None
    assert rf.hand_kernel("sm90_xmma_dgrad_implicit_gemm_bf16") is None
    for name, part in (("wgrad_tiles_kernel", "wgrad"),
                       ("seg_bwd_split_kernel", "seg_bwd"),
                       ("dx_sum_kernel<true>", "seg_bwd"),
                       ("wgrad_tf32_tiles_kernel", "wgrad"),
                       ("seg_bwd_tf32_split_kernel", "seg_bwd"),
                       ("dx_sum_kernel<float, true>", "seg_bwd")):
        assert rf.hand_kernel(NS + name + ARGS) == ("blk_bwd", part), name
        assert rf.is_tail(NS + name + ARGS) == name.startswith("dx_sum")
    assert rf.blk_bwd_part(NAMES[5][0]) == "reduce"
    assert rf.t_kernel_of(NAMES[1][0]) == "conv_fwd"
    assert rf.t_kernel_of(NAMES[2][0]) == "blk_bwd"
    assert rf.t_kernel_of(NAMES[6][0]) is None


def synthetic_trace(steps, per_step, dgrad_dims):
    """Chrome trace events of ``steps`` steps as the card's profiler
    writes them: for each step and each NAMES entry, ``per_step`` of its
    launches (the shift tables' own counts) with a runtime call on the
    host thread, inside a host op; one library kernel a step launched
    inside an op nested in aten::convolution_backward, whose input shapes
    it is filed under; a memcpy."""
    ev, corr, ts_ = [], 0, 0.0
    for _ in range(steps):
        for name, (kernel, part), dur in NAMES:
            count = per_step.get(kernel or part, per_step["default"])
            for _ in range(count):
                corr += 1
                ts_ += 100.0
                ev.append(dict(ph="X", cat="cpu_op", name="_StackBackward",
                               pid=1, tid=2, ts=ts_, dur=50.0, args={}))
                ev.append(dict(ph="X", cat="cuda_runtime",
                               name="cudaLaunchKernelExC", pid=1, tid=2,
                               ts=ts_ + 10, dur=5.0,
                               args={"correlation": corr}))
                ev.append(dict(ph="X", cat="kernel", name=name, pid=0,
                               tid=7, ts=ts_ + 20, dur=dur,
                               args={"correlation": corr}))
        corr += 1
        ts_ += 100.0
        ev.append(dict(ph="X", cat="cpu_op", name="aten::convolution_backward",
                       pid=1, tid=3, ts=ts_, dur=60.0, args={
                           "Input Dims": dgrad_dims,
                           "Input type": ["c10::BFloat16"] * 3,
                           "Concrete Inputs": ["", "", "", "[0]", "[1, 1]",
                                               "[1, 1]", "[1, 1]", "False",
                                               "[0, 0]", "1",
                                               "[True, False, False]"]}))
        ev.append(dict(ph="X", cat="cpu_op", name="aten::empty", pid=1,
                       tid=3, ts=ts_ + 1, dur=2.0, args={}))
        ev.append(dict(ph="X", cat="cpu_op", name="aten::nested_conv_pass",
                       pid=1, tid=3, ts=ts_ + 5, dur=20.0, args={}))
        ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                       pid=1, tid=3, ts=ts_ + 10, dur=5.0,
                       args={"correlation": corr}))
        ev.append(dict(ph="X", cat="kernel", name="sm90_xmma_dgrad_bf16",
                       pid=0, tid=7, ts=ts_ + 20, dur=3000.0,
                       args={"correlation": corr}))
        ev.append(dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", pid=0,
                       tid=7, ts=ts_ + 40, dur=100.0, args={}))
    return ev


@pytest.mark.parametrize("inst", ["3, 5", "4, 7", "4, 8"])
def test_bf16_wide_seg_fwd_files_under_seg_fwd(inst):
    """Each instantiation of seg_fwd_bf16_wide_kernel, the bf16 seg_fwd of
    the 48- and 64-filter widths, is a seg_fwd launch, no part's tail, and
    a kernel of the t stack."""
    name = NS + f"seg_fwd_bf16_wide_kernel<{inst}>" + ARGS
    assert rf.hand_kernel(name) == ("seg_fwd", None)
    assert not rf.is_tail(name)
    assert rf.t_kernel_of(name) == "seg_fwd"


def test_trace_reader_files_every_launch_and_gives_the_shares():
    """Two steps of a "t" train step's launches: each filed under its
    kernel or part, 12 a step (the reduce under blk_bwd), 2 and 1 of the
    shift tables; ms per launch and per step; shares of the bounds; the
    library's dgrad under its op with its shapes and conv bound; busy ms
    and the hand-kernel share."""
    dims = [[128, 9, 20, 20], [128, 9, 20, 20], [9, 9, 3, 3]]
    per = {"default": 12, "shift_table_fwd": 2, "shift_table_bwd": 1}
    events = synthetic_trace(2, per, dims)
    cfg = Config.from_file(CFG)
    rep = rf.roofline(rf.read_trace(events, 2),
                      rf.step_costs(rf.step_shapes(cfg), "float32"), top=3)
    k = rep["kernels"]
    assert {n: r["launches_per_step"] for n, r in k.items()} == dict(
        seg_fwd=12, conv_fwd=12, blk_bwd=12, shift_table_fwd=2,
        shift_table_bwd=1)
    assert {p: q["launches_per_step"] for p, q in k["blk_bwd"][
        "parts"].items()} == {p: 12 for p in rf.BLK_BWD_PARTS}
    assert k["seg_fwd"]["ms_per_launch"] == pytest.approx(0.3)
    assert k["seg_fwd"]["ms_per_step"] == pytest.approx(3.6)
    assert k["seg_fwd"]["share"] == pytest.approx(
        rf.kernel_costs("seg_fwd", N, 32, 256, 25, "float32")["bound_ms"]
        / 0.3)
    assert k["blk_bwd"]["ms_per_launch"] == pytest.approx(
        (600 + 500 + 900 + 15) / 1e3)
    assert k["blk_bwd"]["parts"]["reduce"]["share"] == pytest.approx(
        rf.blk_bwd_part_costs(N, 32, 256, 25, "float32")["reduce"][
            "bound_ms"] / 0.015)
    assert k["shift_table_bwd"]["ms_per_step"] == pytest.approx(0.024)
    lib = rep["library"]
    assert lib[0]["op"] == "aten::convolution_backward"
    assert lib[0]["shapes"] == dims
    assert lib[0]["kernels"] == [(3.0, "sm90_xmma_dgrad_bf16")]
    assert lib[0]["conv_flops"] == 2 * 128 * 9 * 20 * 20 * 9 * 3 * 3
    assert lib[1]["op"] is None and lib[1]["kernels"][0][1] == "Memcpy HtoD"
    hand = 12 * (0.3 + 0.7 + 0.6 + 0.5 + 0.9 + 0.015) + 2 * 0.013 + 0.024
    assert rep["hand_ms"] == pytest.approx(hand)
    assert rep["device_busy_ms"] == pytest.approx(hand + 3.0 + 0.1)
    assert rep["hand_share"] == pytest.approx(hand / (hand + 3.1))
    json.dumps(rep)


def test_trace_reader_files_the_reduce_under_wide_bwd_in_a_flat_step():
    events = []
    for i, name in enumerate((NS + "wide_bwd_bf16_kernel" + ARGS,
                              NAMES[5][0]) * 12):
        events.append(dict(ph="X", cat="kernel", name=name, pid=0, tid=7,
                           ts=100.0 * i, dur=380.0 if "wide" in name else 5,
                           args={}))
    rep = rf.roofline(rf.read_trace(events, 1), rf.step_costs(
        rf.step_shapes(Config.from_file(CFG)), "bfloat16"))
    w = rep["kernels"]["wide_bwd"]
    assert w["launches_per_step"] == 12
    assert {p: q["launches_per_step"] for p, q in w["parts"].items()} == \
        {"wide": 12, "reduce": 12}
    assert w["ms_per_launch"] == pytest.approx(0.385)


def test_trace_reader_counts_a_split_seg_bwd_once_a_block():
    """bf16 blk_bwd at 64/512/51 launches two kernels for its seg_bwd part,
    seg_bwd_split_kernel and dx_sum_kernel: the part has one launch a
    blk_bwd and the time of both, and blk_bwd's launches stay 12."""
    parts = (("conv_ring_kernel<__nv_bfloat16, 64, 8, 1, 2, false>", 1745),
             ("wgrad_tiles_kernel", 433), ("seg_bwd_split_kernel", 900),
             ("dx_sum_kernel<true>", 190), ("reduce_partials_kernel", 56))
    events = [dict(ph="X", cat="kernel", name=NS + name + ARGS, pid=0, tid=7,
                   ts=1e4 * i + j, dur=float(dur), args={})
              for i in range(12) for j, (name, dur) in enumerate(parts)]
    rep = rf.roofline(rf.read_trace(events, 1), rf.step_costs(
        rf.step_shapes(Config.from_file(CFG), filters=64), "bfloat16"))
    k = rep["kernels"]["blk_bwd"]
    assert k["launches_per_step"] == 12
    assert {p: q["launches_per_step"] for p, q in k["parts"].items()} == \
        {p: 12 for p in rf.BLK_BWD_PARTS}
    assert k["parts"]["seg_bwd"]["ms_per_launch"] == pytest.approx(1.09)
    assert k["ms_per_launch"] == pytest.approx(3.324)


def test_trace_reader_counts_a_float32_split_seg_bwd_once_a_block():
    """float32 blk_bwd at 64/512/51 launches seg_bwd_tf32_split_kernel and
    dx_sum_kernel<float> for its seg_bwd part and wgrad_tf32_tiles_kernel
    for its wgrad: each part has one launch a blk_bwd, the seg_bwd part the
    time of both its kernels, and blk_bwd's launches stay 12."""
    parts = (("conv_ring_kernel<float, 64, 8, 1, 1, false>", 8940),
             ("wgrad_tf32_tiles_kernel", 2150),
             ("seg_bwd_tf32_split_kernel", 3550),
             ("dx_sum_kernel<float, true>", 330),
             ("reduce_partials_kernel", 56))
    events = [dict(ph="X", cat="kernel", name=NS + name + ARGS, pid=0, tid=7,
                   ts=1e5 * i + j, dur=float(dur), args={})
              for i in range(12) for j, (name, dur) in enumerate(parts)]
    rep = rf.roofline(rf.read_trace(events, 1), rf.step_costs(
        rf.step_shapes(Config.from_file(CFG), filters=64), "float32"))
    k = rep["kernels"]["blk_bwd"]
    assert k["launches_per_step"] == 12
    assert {p: q["launches_per_step"] for p, q in k["parts"].items()} == \
        {p: 12 for p in rf.BLK_BWD_PARTS}
    assert k["parts"]["seg_bwd"]["ms_per_launch"] == pytest.approx(3.88)
    assert k["parts"]["wgrad"]["ms_per_launch"] == pytest.approx(2.15)
    assert k["ms_per_launch"] == pytest.approx(15.026)


def test_a_share_above_the_limit_raises_naming_the_kernel():
    """A launch faster than its bound means a wrong count: it raises."""
    fast = [dict(ph="X", cat="kernel", name=NAMES[0][0], pid=0, tid=7,
                 ts=100.0 * i, dur=50.0, args={}) for i in range(12)]
    costs = rf.step_costs(rf.step_shapes(Config.from_file(CFG)), "float32")
    with pytest.raises(AssertionError, match="seg_fwd: bound .* share"):
        rf.roofline(rf.read_trace(fast, 1), costs)


def test_trace_mode_of_the_command_line(tmp_path):
    """--trace reads a --profile-dir trace (no host ops): hand kernels by
    name per step over its 10 steps, the library by kernel name."""
    events = [e for e in synthetic_trace(
        rf.TRACE_STEPS, {"default": 12, "shift_table_fwd": 0,
                         "shift_table_bwd": 0}, [[1]])
        if e["cat"] not in ("cpu_op",)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = tmp_path / "roof.json"
    rep = rf.main(["--trace", str(path), "--dtype", "f32", "--json",
                   str(out), "--cfg", CFG])
    assert rep["kernels"]["blk_bwd"]["launches_per_step"] == 12
    assert "shift_table_fwd" not in rep["kernels"]
    assert rep["library"][0]["op"] is None
    assert rep["library"][0]["kernels"][0][1] == "sm90_xmma_dgrad_bf16"
    assert json.loads(out.read_text())["kernels"]["seg_fwd"][
        "launches_per_step"] == 12


class _Event:
    def __init__(self, key, us):
        self.key, self.self_device_time_total = key, us


def stub_profiler(captures):
    """A stand-in for torch.profiler.profile whose n-th capture's
    key_averages() are ``captures[n]`` ((key, us) pairs)."""
    taken = []

    class Profile:
        def __init__(self, activities):
            del activities

        def __enter__(self):
            taken.append(len(taken))
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [_Event(k, us) for k, us in captures[taken[-1]]]

    return Profile, taken


FAKE_TORCH = types.SimpleNamespace(
    cuda=types.SimpleNamespace(synchronize=lambda: None))


def test_kernel_ms_captures_again_where_a_named_kernel_has_no_time():
    """A first capture without device time for a named key is taken again
    (and logged), and the second is used."""
    profile, taken = stub_profiler([
        [("reduce_partials_kernel", 150.0), ("reduce_kernel<512>", 0.0)],
        [("reduce_partials_kernel", 150.0), ("reduce_kernel<512>", 200.0)]])
    logs, calls = [], []
    got = rf.kernel_ms(FAKE_TORCH, lambda: calls.append(1), reps=10,
                       need=("reduce_partials_kernel", "reduce_kernel<512>"),
                       profile=profile, log=logs.append)
    assert got == {"reduce_partials_kernel": 0.015,
                   "reduce_kernel<512>": 0.02}
    assert len(taken) == 2 and len(calls) == 1 + 2 * 10
    assert len(logs) == 1 and "reduce_kernel<512>" in logs[0]


def test_kernel_ms_raises_after_three_captures_without_the_key():
    profile, taken = stub_profiler([[("memset", 1.0)]] * 5)
    logs = []
    with pytest.raises(RuntimeError, match="3 captures held no device time "
                       "for \\['reduce_partials_kernel'\\]"):
        rf.kernel_ms(FAKE_TORCH, lambda: None, need=(
            "reduce_partials_kernel",), profile=profile, log=logs.append)
    assert len(taken) == rf.CAPTURES == 3 and len(logs) == 2
    # "" asks for any device time; without a need one capture is taken.
    profile, taken = stub_profiler([[("a", 0.0)], [("a", 5.0)]])
    assert rf.kernel_ms(FAKE_TORCH, lambda: None, reps=1, need=("",),
                        profile=profile, log=logs.append) == {"a": 0.005}
    profile, taken = stub_profiler([[("a", 0.0)]])
    assert rf.kernel_ms(FAKE_TORCH, lambda: None, profile=profile) == {}
    assert len(taken) == 1


def stub_trace_profiler(captures):
    """A stand-in for torch.profiler.profile whose n-th capture exports
    the Chrome trace events ``captures[n]``."""
    taken = []

    class Profile:
        def __init__(self, activities, record_shapes):
            assert record_shapes
            self.acts = activities

        def __enter__(self):
            taken.append(self.acts)
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            Path(path).write_text(json.dumps(
                {"traceEvents": captures[len(taken) - 1]}))

    return Profile, taken


def kernel_event(name, dur):
    return dict(ph="X", cat="kernel", name=name, pid=0, tid=7, ts=0.0,
                dur=dur, args={})


def test_capture_trace_captures_again_where_a_named_kernel_has_no_time():
    """A step's trace without device time for a kernel the caller names is
    taken again (and logged), and the second is used; one that never shows
    raises after 3 captures; without a need one capture is taken."""
    seg, conv = NAMES[0][0], NAMES[1][0]
    second = [kernel_event(seg, 300.0), kernel_event(conv, 700.0)]
    profile, taken = stub_trace_profiler([[kernel_event(seg, 300.0),
                                           kernel_event(conv, 0.0)], second])
    logs, calls = [], []
    got = rf.capture_trace(lambda: calls.append(1), True,
                           need=("seg_fwd", "conv_fwd"), profile=profile,
                           log=logs.append)
    assert got == second and len(taken) == 2 and len(calls) == 2
    assert len(taken[0]) == 2
    assert len(logs) == 1 and "['conv_fwd']" in logs[0]
    profile, taken = stub_trace_profiler([[kernel_event(seg, 300.0)]] * 5)
    with pytest.raises(RuntimeError, match="3 captures held no device time "
                       "for \\['wide_bwd'\\] \\(found \\['seg_fwd'\\]\\)"):
        rf.capture_trace(lambda: None, True, need=("wide_bwd",),
                         profile=profile, log=logs.append)
    assert len(taken) == rf.CAPTURES and len(logs) == 3
    profile, taken = stub_trace_profiler([[]])
    assert rf.capture_trace(lambda: None, False, profile=profile) == []
    assert len(taken) == 1 and len(taken[0]) == 1


def test_profile_train_files_a_step_through_the_trace_reader():
    """profile_train's breakdown of one step: busy ms, the kernels by
    time, and blk_bwd's parts and the shift tables as read_trace files
    them."""
    from probav_tpu_torch.tools.profile_train import step_breakdown
    per = {"default": 12, "shift_table_fwd": 2, "shift_table_bwd": 1}
    dims = [[128, 9, 20, 20], [128, 9, 20, 20], [9, 9, 3, 3]]
    busy, rows, hand = step_breakdown(synthetic_trace(1, per, dims))
    assert rows[0] == (pytest.approx(10.8), NAMES[4][0], 12)
    assert ("sm90_xmma_dgrad_bf16" in [k for _, k, _ in rows])
    assert busy == pytest.approx(sum(ms for ms, _, _ in rows))
    assert {p: q["launches"] for p, q in hand["blk_bwd"]["parts"].items()} \
        == {p: 12 for p in rf.BLK_BWD_PARTS}
    assert hand["blk_bwd"]["parts"]["reduce"]["ms"] == pytest.approx(0.18)
    assert (hand["shift_table_fwd"]["launches"],
            hand["shift_table_bwd"]["launches"]) == (2, 1)


def test_geom_sweep_widths_and_refusal():
    """--filters N gives N/8N/int(0.8N); N = 160 (C beyond 128) is
    refused before any work, with the kernels' limit."""
    assert [gs.widths(f) for f in gs.FILTERS] == [
        (16, 128, 12), (32, 256, 25), (48, 384, 38), (64, 512, 51),
        (160, 1280, 128)]
    assert [gs.refusal(f) for f in gs.FILTERS[:4]] == [None] * 4
    assert gs.refusal(160).startswith("the kernels refuse 160/1280/128")
    with pytest.raises(ValueError, match="refuse 160/1280/128: channels "
                       "from 1 to 128"):
        gs.run_width(torch, "cpu", torch.float32, 160)
