"""The port's full-scale rehearsal tool
(``probav_tpu_torch/tools/full_rehearsal.py``) on the CPU, at a smoke scale.

Its raw-tree generator is held to the JAX tool's (``tools/full_rehearsal.py``)
file for file and pixel for pixel; its harness runs the port's four CLIs as
subprocesses at ``--scale 0.003 --tiny-net`` (2 scenes a band and split)
and is checked for exit codes, bounded RSS, artifact counts, the scaled
``norm.csv`` numbering, ``--reg-diff``, the report's resume contract, a
failing stage and its fixed seeds.
"""

import ast
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from probav_tpu_torch.tools import full_rehearsal as fr
from probav_tpu_torch.utils.png import read_png

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 600
SMOKE = ["--scale", "0.003", "--tiny-net", "--epochs", "1", "--fused", "off",
         "--device", "cpu"]
STAGES = ("preprocess_NIR", "preprocess_RED", "preprocess_numpyreg_NIR",
          "train_BOTH_1ep", "serve_TEST_NIR", "serve_TEST_RED",
          "serve_TRAIN_NIR", "serve_TRAIN_RED", "evaluate")


def run_tool(ws, *flags):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "probav_tpu_torch.tools.full_rehearsal",
         "--workdir", str(ws), *SMOKE, *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=TIMEOUT)


def report(ws):
    with open(os.path.join(ws, "rehearsal_report.json")) as f:
        return json.load(f)


def tree_digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """The smoke run with --reg-diff, then a second call that skips
    generation, preprocessing and training."""
    ws = tmp_path_factory.mktemp("rehearsal") / "ws"
    first = run_tool(ws, "--reg-diff")
    assert first.returncode == 0, (first.stdout[-4000:], first.stderr[-4000:])
    r1 = report(ws)
    second = run_tool(ws, "--skip-gen", "--skip-preprocess", "--skip-train")
    assert second.returncode == 0, (second.stdout[-4000:],
                                    second.stderr[-4000:])
    return ws, r1, report(ws)


def test_every_stage_exits_0_with_bounded_rss(rehearsal):
    _, r1, _ = rehearsal
    assert "failed" not in r1
    assert r1["steps"]["generate"]["scenes"] == 8
    for name in STAGES:
        step = r1["steps"][name]
        assert step["exit"] == 0, (name, step)
        # The smoke must stay far below a full-scale stage's memory.
        assert 0 < step["peak_rss_gb"] < 4.0, (name, step)
        assert step["rss_field"] in ("VmHWM", "VmRSS"), (name, step)
        assert step["device_peak_gb"] is None, (name, step)
        assert step["wall_s"] > 0


def test_counts_outputs_and_norm_csv(rehearsal):
    ws, r1, _ = rehearsal
    # max(2, round(n * 0.003)): 594 -> 2, 712 -> 2, 146 -> 2, 144 -> 2
    assert r1["counts"] == {"RED_train": 2, "NIR_train": 2,
                            "RED_test": 2, "NIR_test": 2}
    out = os.path.join(ws, "out")
    test_out = [d for d in os.listdir(out) if d.startswith("testout")]
    assert len(test_out) == 1
    pngs = [f for f in os.listdir(os.path.join(out, test_out[0]))
            if f.endswith(".png")]
    assert len(pngs) == 4
    # NIR is numbered from the RED train count, as evaluate numbers the
    # candidates, so the normalized score covers both bands.
    with open(os.path.join(ws, "norm.csv")) as f:
        lines = f.read().splitlines()
    assert lines == ["scene,norm"] + [f"imgset{i:04d},45.0" for i in range(4)]
    assert set(r1["score"]["bands"]) == {"RED", "NIR"}
    assert np.isfinite(r1["score"]["normalized_score"])


def test_reg_diff_digests_of_torch_and_numpy_registration(rehearsal):
    _, r1, _ = rehearsal
    assert sorted(r1["reg_diff"]) == sorted(fr.REG_DIFF_FILES)
    for name, d in r1["reg_diff"].items():
        assert d["equal"] and d["torch"] == d["numpy"], (name, d)


def test_second_call_keeps_the_earlier_steps(rehearsal):
    _, r1, r2 = rehearsal
    for name in ("generate", "preprocess_NIR", "preprocess_RED",
                 "preprocess_numpyreg_NIR", "train_BOTH_1ep"):
        assert r2["steps"][name] == r1["steps"][name], name
    assert r2["reg_diff"] == r1["reg_diff"]
    for name in STAGES[4:]:
        assert r2["steps"][name]["exit"] == 0
    assert r2["args"]["skip_train"] and not r1["args"]["skip_train"]


def test_same_seeds_give_the_same_tree(rehearsal, tmp_path):
    ws, r1, _ = rehearsal
    assert r1["seeds"] == {f"{b}_{s}": fr.SEEDS[b, s] for b, s in fr.COUNTS}
    again = tmp_path / "raw"
    for (band, split), n in fr.COUNTS.items():
        fr.make_band_tree(str(again), band, split,
                          r1["counts"][f"{band}_{split}"],
                          seed=r1["seeds"][f"{band}_{split}"])
    got = tree_digests(again)
    assert len(got) > 8 * 18
    assert got == tree_digests(os.path.join(ws, "raw"))


def test_failed_stage_names_itself(tmp_path):
    """A stage's failure is not caught: the tool exits non-zero and the
    report names the stage (here serving with no preprocessed arrays)."""
    ws = tmp_path / "ws"
    r = run_tool(ws, "--skip-gen", "--skip-preprocess", "--skip-train")
    assert r.returncode != 0
    rep = report(ws)
    assert rep["failed"] == "serve_TEST_NIR"
    assert rep["steps"]["serve_TEST_NIR"]["exit"] != 0
    assert "evaluate" not in rep["steps"]


def test_differing_scenes_counts_rows(tmp_path):
    a = np.ma.masked_array(np.arange(24.0).reshape(4, 2, 3),
                           mask=np.zeros((4, 2, 3), bool))
    b = a.copy()
    b.data[1, 0, 0] += 1
    b.mask[3, 1, 2] = True
    pa, pb, pc = (str(tmp_path / f"{k}.npy") for k in "abc")
    a.dump(pa)
    b.dump(pb)
    a[:3].dump(pc)
    assert fr.differing_scenes(pa, pa) == 0
    assert fr.differing_scenes(pa, pb) == 2
    assert fr.differing_scenes(pa, pc) == 1


def test_tool_imports_nothing_of_the_jax_package_tools_or_tests():
    path = REPO / "probav_tpu_torch" / "tools" / "full_rehearsal.py"
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    tops = {n.split(".")[0] for n in names}
    assert tops and not tops & {"probav_tpu", "tools", "tests", "jax"}


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_full_rehearsal", REPO / "tools" / "full_rehearsal.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("band,split", sorted(fr.COUNTS))
def test_generator_matches_the_jax_tool(tmp_path, band, split):
    """Three scenes a (band, split) from one seed: the same file names and
    pixel-equal LR, QM, HR and SM, each tree read by its own package."""
    from probav_tpu.utils.io import read_png as jax_read_png

    jr = jax_tool()
    assert jr.COUNTS == fr.COUNTS and jr.FRAME_CYCLE == fr.FRAME_CYCLE
    seed = fr.SEEDS[band, split]
    fr.make_band_tree(str(tmp_path / "port"), band, split, 3, seed)
    jr.make_band_tree(str(tmp_path / "jax"), band, split, 3, seed)
    sub = os.path.join(split, band)
    port_dir, jax_dir = tmp_path / "port" / sub, tmp_path / "jax" / sub
    scenes = sorted(os.listdir(port_dir))
    assert scenes == sorted(os.listdir(jax_dir)) == [
        f"imgset{s:04d}" for s in range(3)]
    kinds = set()
    for scene in scenes:
        names = sorted(os.listdir(port_dir / scene))
        assert names == sorted(os.listdir(jax_dir / scene))
        for name in names:
            got = read_png(str(port_dir / scene / name))
            want = jax_read_png(str(jax_dir / scene / name))
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want), (scene, name)
            kinds.add(name[:2])
    assert kinds == ({"LR", "QM", "HR", "SM"} if split == "train"
                     else {"LR", "QM"})
