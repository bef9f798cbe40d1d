"""The port's preprocessing stage (probav_tpu_torch/data/pipeline.py and
python3 -m probav_tpu_torch.preprocess) against the JAX package's
pipeline on the CPU: the synthetic raw tree (3 train and 2 test scenes of
5 frames, 32^2) through all five stages, with the port's 'numpy' and
'torch' (on CPU tensors) registration backends in directories of their
own; every artifact equal to the JAX pipeline's in data, mask, shape and
dtype.  Also the native frame selector against its plain twin and the
JAX package's selector."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from probav_tpu.config import Config as JaxConfig
from probav_tpu.data import pipeline as jpipeline
from probav_tpu.data import qc as jqc
from probav_tpu_torch import preprocess
from probav_tpu_torch.config import Config
from probav_tpu_torch.data import _native, pipeline, qc
from probav_tpu_torch.ops import registration
from synthetic_data import make_raw_tree, write_cfg

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_DIRS = ("arrayDir", "trimmedArrayDir", "patchesDir",
              "trimmedPatchesDir", "resolverDir", "augmentedPatchesDir")


def cfg_file(root, name, raw, **keys):
    """A synthetic cfg whose outputs live under root/name, with ``keys``
    replaced."""
    path = write_cfg(str(root / f"{name}.cfg"), raw=raw,
                     out=str(root / name / "data"),
                     model_out=str(root / name / "model"),
                     train_out=str(root / name / "trainout"),
                     test_out=str(root / name / "testout"))
    with open(path) as f:
        text = f.read()
    for k, v in keys.items():
        text = "\n".join(f"{k}={v}" if line.startswith(f"{k}=") else line
                         for line in text.split("\n"))
    with open(path, "w") as f:
        f.write(text)
    return path


def assert_artifacts_equal(got_dir, want_dir):
    """Every file of want_dir exists in got_dir with the same content:
    pickled arrays equal in type, data, mask, shape and dtype (scene by
    scene for object arrays), text files byte for byte."""
    names = sorted(os.listdir(want_dir))
    assert names and sorted(os.listdir(got_dir)) == names
    for name in names:
        a, b = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(".txt"):
            with open(a) as f, open(b) as g:
                assert f.read() == g.read(), name
            continue
        got, want = (np.load(p, allow_pickle=True) for p in (a, b))
        assert type(got) is type(want), name
        assert got.shape == want.shape and got.dtype == want.dtype, name
        pairs = zip(got, want) if want.dtype == object else [(got, want)]
        for x, y in pairs:
            assert type(x) is type(y) and x.dtype == y.dtype, name
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=name)
            np.testing.assert_array_equal(np.ma.getmaskarray(x),
                                          np.ma.getmaskarray(y),
                                          err_msg=name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX pipeline (numpy registration) and the port's, with each
    backend, over one raw tree; the port's run statistics by backend."""
    root = tmp_path_factory.mktemp("pipeline")
    raw = make_raw_tree(str(root / "raw"), train_scenes=3, test_scenes=2,
                        frames=5)
    jpipeline.run(JaxConfig.from_file(cfg_file(root, "jax", raw)), "NIR",
                  progress=False)
    stats = {}
    registration.reset_chunks()
    for backend in ("numpy", "torch"):
        cfg = Config.from_file(cfg_file(root, backend, raw))
        stats[backend] = pipeline.run(cfg, "NIR", progress=False,
                                      registration_backend=backend,
                                      device="cpu")
    stats["chunks"] = dict(registration.CHUNKS)
    return root, stats


@pytest.mark.parametrize("stage_dir", STAGE_DIRS)
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_every_stage_artifact_equals_jax(runs, backend, stage_dir):
    root, _ = runs
    assert_artifacts_equal(str(root / backend / "data" / stage_dir),
                           str(root / "jax" / "data" / stage_dir))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_removed_sets_and_run_statistics(runs, backend):
    root, stats = runs
    name = "removedTrainSetsNIR.txt"
    with open(root / backend / "data" / name) as f, \
            open(root / "jax" / "data" / name) as g:
        assert f.read() == g.read()
    st = stats[backend]
    assert sorted(st["seconds"]) == [1, 2, 3, 4, 5]
    assert st["scenes"] == {1: 10, 2: 5}      # both bands ingested
    assert 0 < st["register_s"] < st["seconds"][2]
    # two device calls (train, test) on the CPU; none for numpy
    assert stats["chunks"] == {"cpu": 2}


def test_preprocess_cli_with_augments_and_outlier_filter(tmp_path):
    """python3 -m probav_tpu_torch.preprocess through main(argv) on the CPU
    with a permutation, flips, rotations and the outlier filter (one train
    scene removed, two test scenes kept whole), against the JAX pipeline
    run with the same arguments."""
    raw = make_raw_tree(str(tmp_path / "raw"), bands=("NIR",),
                        train_scenes=3, test_scenes=2, frames=5)
    keys = dict(num_low_res_permute=1, to_flip=1, to_rotate=1)
    jpipeline.run(JaxConfig.from_file(cfg_file(tmp_path, "jax", raw, **keys)),
                  "NIR", progress=False, outlier_threshold=45000.0,
                  outlier_min_frames=3)
    stats = preprocess.main(["--cfg", cfg_file(tmp_path, "port", raw, **keys),
                             "--band", "NIR", "--device", "cpu",
                             "--outlier-threshold", "45000",
                             "--outlier-min-frames", "3"])
    assert stats["scenes"][2] == 2 + 2
    for d in STAGE_DIRS:
        assert_artifacts_equal(str(tmp_path / "port" / "data" / d),
                               str(tmp_path / "jax" / "data" / d))
    removed = np.loadtxt(tmp_path / "port" / "data" /
                         "removedTrainSetsNIR.txt")
    assert np.atleast_1d(removed).tolist() == [594 + 2]
    lr = np.load(tmp_path / "port" / "data" / "augmentedPatchesDir" /
                 "TRAINpatchesLR_NIR.npy", allow_pickle=True)
    val = np.load(tmp_path / "port" / "data" / "augmentedPatchesDir" /
                  "TRAINVALpatchesLR_NIR.npy", allow_pickle=True)
    assert len(lr) % (2 * 4 * 4) == 0 and len(val) > 0   # x2 x4 x4


def test_preprocess_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    """The default registers on the card; without one it raises before
    any stage runs, and never registers on the host instead."""
    raw = make_raw_tree(str(tmp_path / "raw"), bands=("NIR",),
                        train_scenes=1, test_scenes=1, frames=2)
    cfgp = cfg_file(tmp_path, "port", raw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess.main(["--cfg", cfgp])
    assert not (tmp_path / "port" / "data").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.run(Config.from_file(cfgp), "NIR", ckpts=[1, 2],
                     progress=False)


def test_preprocess_module_runs_and_defaults_to_the_card(tmp_path):
    """``python3 -m probav_tpu_torch.preprocess`` is the entry point; its
    default device is the card, and without one it fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    raw = make_raw_tree(str(tmp_path / "raw"), bands=("NIR",),
                        train_scenes=1, test_scenes=1, frames=2)
    r = subprocess.run([sys.executable, "-m", "probav_tpu_torch.preprocess",
                        "--cfg", cfg_file(tmp_path, "port", raw)],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def occlusions(seed, s, p, t, hw):
    r = np.random.default_rng(seed)
    occ = r.integers(0, hw, size=(s, p, t)).astype(np.int64)
    occ[0, 0] = hw                    # all-dirty patches: no replacement
    occ[-1, -1] = hw
    occ[1 % s, 0, :2] = 0             # ties on occlusion
    return occ


@pytest.mark.parametrize("s,p,t,k", [(5, 7, 9, 6), (2, 3, 5, 9), (1, 4, 19, 9),
                                     (3, 2, 1, 4)])
def test_native_selector_matches_plain_twin_and_jax(s, p, t, k):
    occ = occlusions(s * 100 + t, s, p, t, 64)
    got = qc.select_frame_indices(occ, k, 0.85, 64)
    assert got[0].dtype == np.int32 and got[0].shape == (s, p, k)
    for want in (qc._select_frame_indices_py(occ, k, 0.85, 64),
                 jqc.select_frame_indices(occ, k, 0.85, 64)):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == tuple(want[1:])
    assert _native.library_path().exists()


def test_native_selector_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message; there is
    no fallback to the Python twin."""
    bad = tmp_path / "select_frames.cpp"
    bad.write_text('extern "C" int probav_select_frames( { }\n')
    monkeypatch.setattr(_native, "SRC", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    _native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ select_frames.cpp"):
            qc.select_frame_indices(np.zeros((1, 1, 3), np.int64), 2, 0.85,
                                    64)
        assert not list((tmp_path / "build").glob("*.so"))
    finally:
        _native.library.cache_clear()
