"""The port's bf16 convergence gate (``probav_tpu_torch/tools/
bf16_convergence.py``) against the JAX tool (``tools/bf16_convergence.py``)
on the CPU, at a small size: 2 blocks, 8 filters, 45 scenes (36 training
patches, 4 steps of 8 an epoch; 9 validation patches, a batch of 8 and a
ragged one of 1).

The JAX tool starts a non-daemon watchdog thread (``os._exit(17)`` after
3000 s) when it is imported, so these tests never import it: its
``make_dataset`` is compiled alone from the file's syntax tree, and its
``run_one`` is mirrored here from ``probav_tpu`` classes.

The f32 arm is held to JAX with the tolerances of
``tests/test_torch_fit_device.py``: val_loss to 1e-5 relative, val_cpsnr
to 1e-4 absolute.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from probav_tpu.data.loader import Batcher as JaxBatcher
from probav_tpu.models import WDSRConv3D as JaxWDSR
from probav_tpu.ops import ShiftCompensatedLosses as JaxLosses
from probav_tpu.train import ModelTrainer as JaxTrainer
from probav_tpu.train import build_optimizer as jax_optimizer
from probav_tpu_torch import convert
from probav_tpu_torch.tools import bf16_convergence as bc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_TOOL = ROOT / "tools" / "bf16_convergence.py"
SCENES, FILTERS, BLOCKS, BATCH, STEPS = 45, 8, 2, 8, 4


def jax_make_dataset():
    """The JAX tool's ``make_dataset``, compiled alone from its source
    (importing the file would start its watchdog)."""
    tree = ast.parse(JAX_TOOL.read_text(), str(JAX_TOOL))
    fn = [n for n in tree.body
          if isinstance(n, ast.FunctionDef) and n.name == "make_dataset"]
    assert len(fn) == 1
    namespace = {}
    exec(compile(ast.Module(body=fn, type_ignores=[]), str(JAX_TOOL),
                 "exec"), namespace)
    return namespace["make_dataset"]


@pytest.fixture(scope="module")
def data():
    return bc.make_dataset(np.random.default_rng(123), n_scenes=SCENES)


@pytest.fixture(scope="module")
def jax_arm(data, tmp_path_factory):
    """The JAX tool's f32 arm at the small size (use_pallas=False on the
    CPU), and its init as the port's state_dict."""
    tmp = tmp_path_factory.mktemp("jax_arm")
    lrs, hrs, masks = data
    n_val = len(lrs) // 5
    xt, xv = lrs[n_val:], lrs[:n_val]
    yt, yv = hrs[n_val:], hrs[:n_val]
    mt, mv = masks[n_val:], masks[:n_val]
    model = JaxWDSR(**bc.net(FILTERS, BLOCKS), fused_stack=False)
    losses = JaxLosses(target_shape=(48, 48, 1), use_pallas=False)
    trainer = JaxTrainer(model, losses.l1, losses.cpsnr,
                         jax_optimizer("nadam", 5e-4),
                         ckpt_dir=str(tmp / "ckpt"), log_dir=str(tmp / "log"),
                         eval_step=10 ** 9, log_every=10 ** 9)
    trainer.init_state(xt[:1], rng_seed=bc.SEED)
    # fit_device donates the state's buffers: convert them first.
    init = convert.to_state_dict(jax.tree.map(np.asarray,
                                              trainer.state.params))
    epochs = -(-STEPS // (len(xt) // BATCH))
    trainer.fit_device(xt, [yt, mt], batch_size=BATCH, epochs=epochs,
                       val_data=[xv, yv, mv], val_steps=10 ** 9,
                       save_best_only=False, seed=bc.SEED)
    vb = JaxBatcher((xv, yv, mv), BATCH, seed=1, drop_remainder=False)
    val_loss, val_psnr = trainer.evaluate(vb, val_steps=10 ** 9)
    return init, {"steps": int(trainer.state.step),
                  "val_loss": float(val_loss), "val_cpsnr": float(val_psnr)}


def port_arm(data, init, tier, monkeypatch):
    # The trainer's TensorBoard writer would import TensorFlow (~15 s).
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    return bc.run_one("f32", data, STEPS, fused_stack=tier,
                      num_filters=FILTERS, device="cpu", init=init,
                      num_res_blocks=BLOCKS, batch=BATCH)


@pytest.mark.parametrize("seed,n", [(123, 3), (7, 2)])
def test_make_dataset_equals_the_jax_tools_to_the_bit(seed, n):
    want = jax_make_dataset()(np.random.default_rng(seed), n_scenes=n)
    got = bc.make_dataset(np.random.default_rng(seed), n_scenes=n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (n, 22, 22, 9, 1)
    assert got[1].shape == got[2].shape == (n, 48, 48, 1)


def test_f32_arm_matches_the_jax_tools(data, jax_arm, monkeypatch):
    init, want = jax_arm
    got = port_arm(data, init, "off", monkeypatch)
    assert set(got) == {"dtype", "steps", "val_loss", "val_cpsnr",
                        "seconds"}
    assert got["dtype"] == "f32"
    assert got["steps"] == want["steps"] == STEPS
    assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-5)
    assert got["val_cpsnr"] == pytest.approx(want["val_cpsnr"], abs=1e-4)


def test_kernel_tier_arm_matches_the_plain_arm(data, jax_arm, monkeypatch):
    """The "t" tier (its plain twins on the CPU) pads the ragged
    validation batch of 1 to 8 with weight-0 rows; the loss and the
    cPSNR stay those of the unpadded "off" arm."""
    init, _ = jax_arm
    plain = port_arm(data, init, "off", monkeypatch)
    kernel = port_arm(data, init, "t", monkeypatch)
    assert kernel["steps"] == plain["steps"] == STEPS
    assert kernel["val_loss"] == pytest.approx(plain["val_loss"], rel=1e-5)
    assert kernel["val_cpsnr"] == pytest.approx(plain["val_cpsnr"],
                                                abs=1e-4)


def test_seeded_init_is_one_state_for_every_arm():
    a = bc.seeded_init(FILTERS, num_res_blocks=BLOCKS)
    b = bc.seeded_init(FILTERS, num_res_blocks=BLOCKS)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) and a[k].dtype == torch.float32
               for k in a)


def arm(cpsnr, dtype="f32"):
    return {"dtype": dtype, "steps": 402, "val_loss": 100.0,
            "val_cpsnr": cpsnr, "seconds": 1.0}


@pytest.mark.parametrize("bf16_db,ok", [(30.09, True), (29.91, True),
                                        (30.11, False), (29.89, False)])
def test_gate_passes_within_a_tenth_of_a_db(bf16_db, ok):
    res = bc.gate(arm(30.0), arm(bf16_db, "bf16"), 32)
    assert set(res) == {"f32", "bf16", "delta_db", "pass_0.1db", "filters"}
    assert res["pass_0.1db"] is ok and bc.passed(res) is ok
    assert res["delta_db"] == round(abs(bf16_db - 30.0), 4)
    assert res["filters"] == 32


def test_gate_rounds_as_the_jax_tool_and_holds_the_kernel_arm():
    res = bc.gate(arm(30.0), arm(30.0123456, "bf16"), 64,
                  arm(30.2, "bf16"))
    assert res["delta_db"] == 0.0123
    assert res["kernel_delta_db"] == round(abs(30.2 - 30.0123456), 4)
    assert res["pass_0.1db"] and not bc.passed(res)
    assert res["bf16_plain"]["val_cpsnr"] == 30.2


@pytest.mark.parametrize("plain_db,code", [(30.05, 0), (30.2, 1)])
def test_main_prints_the_gate_and_exits_1_when_it_fails(
        tmp_path, monkeypatch, capsys, plain_db, code):
    """Stubbed arms: the tiers main asks for, the JSON it prints and
    writes, and its exit code."""
    calls = []
    dbs = {("f32", "off"): 30.0, ("bf16", "t"): 30.04,
           ("bf16", "off"): plain_db}

    def run_one(dtype_name, data, steps, seed=bc.SEED, fused_stack="off",
                num_filters=32, **kw):
        calls.append((dtype_name, fused_stack, steps, num_filters,
                      kw["device"]))
        return arm(dbs[dtype_name, fused_stack], dtype_name)

    monkeypatch.setattr(bc, "run_one", run_one)
    monkeypatch.setattr(bc, "make_dataset", lambda rng: None)
    out = tmp_path / "gate.json"
    argv = ["7", "--fused", "--isolate-kernel", "--filters", "8",
            "--device", "cpu", "--json", str(out)]
    assert bc.main(argv) == code
    assert calls == [("f32", "off", 7, 8, "cpu"), ("bf16", "t", 7, 8, "cpu"),
                     ("bf16", "off", 7, 8, "cpu")]
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(out.read_text())
    assert printed["delta_db"] == 0.04 and printed["pass_0.1db"] is True
    assert printed["kernel_delta_db"] == round(abs(plain_db - 30.04), 4)
    assert printed["tf32"] is False and printed["card"] is None
    assert printed["filters"] == 8
    # Without --fused both arms run "off", and no third arm.
    calls.clear()
    dbs["bf16", "off"] = 30.04
    assert bc.main(["3", "--isolate-kernel", "--device", "cpu"]) == 0
    assert calls == [("f32", "off", 3, 32, "cpu"),
                     ("bf16", "off", 3, 32, "cpu")]


def test_tool_imports_nothing_of_the_jax_package_and_starts_no_thread():
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "probav_tpu",
              "tools", "tests"}
    path = ROOT / "probav_tpu_torch" / "tools" / "bf16_convergence.py"
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in banned]
    assert found == []
    script = ("import sys, threading\n"
              "for m in ('jax', 'probav_tpu', 'tools', 'tests'):\n"
              "    sys.modules[m] = None\n"
              "import torch\n"
              "before = threading.active_count()\n"
              "import probav_tpu_torch.tools.bf16_convergence\n"
              "assert threading.active_count() == before, "
              "threading.enumerate()\n"
              "print('NO_THREAD')\n")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "NO_THREAD" in r.stdout
