"""The port's serve CLI (python3 -m probav_tpu_torch.serve) on the CPU,
against the JAX Resolver + write_submission on the same parameters, and
its PNG codec against imageio."""

import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probav_tpu.config import Config
from probav_tpu.infer import Resolver as JaxResolver
from probav_tpu.infer import write_submission as jax_write_submission
from probav_tpu.models import build_model as jax_build_model
from probav_tpu.utils.io import read_png as imageio_read_png
from probav_tpu_torch import serve
from probav_tpu_torch.convert import flatten_tree
from probav_tpu_torch.utils import png
from probav_tpu_torch.utils.png import read_png, write_png
from synthetic_data import write_cfg

torch.set_num_threads(1)


@pytest.fixture
def tree(tmp_path):
    """Synthetic cfg (4 filters, 1 block) + a 2-scene, 2x2-grid resolver
    input in the pipeline's [S, P, T, C, h, w] layout + params .npz."""
    cfgp = write_cfg(str(tmp_path / "synth.cfg"), raw=str(tmp_path / "raw"),
                     out=str(tmp_path / "chkpt"),
                     model_out=str(tmp_path / "mi"),
                     train_out=str(tmp_path / "to"),
                     test_out=str(tmp_path / "te"))
    cfg = Config.from_file(cfgp)
    os.makedirs(cfg.stage_dir("resolverDir"))
    r = np.random.default_rng(40)
    lr = r.uniform(4000, 12000, (2, 4, 9, 1, 22, 22)).astype(np.float32)
    np.save(os.path.join(cfg.stage_dir("resolverDir"),
                         "TESTpatchesLR_NIR.npy"), lr)
    jm = jax_build_model(cfg, "NIR")
    x = jnp.asarray(lr.transpose(0, 1, 4, 5, 2, 3)[0])
    params = jm.init(jax.random.PRNGKey(2), x[:1])["params"]
    params = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, params)
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **flatten_tree(params))
    return cfgp, cfg, lr, jm, params, npz


def tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_on(monkeypatch):
    """cuDNN's and cuBLAS's TF32 switched on (cuDNN's default), restored
    after the test."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)


def test_serve_cli_matches_jax_submission(tree, tmp_path, tf32_on):
    """The float32 CLI also turns TF32 off (cuDNN and matmul), so its convs
    compute float32 products on the card."""
    cfgp, cfg, lr, jm, params, npz = tree
    assert tf32_flags() == (True, True)
    res = serve.main(["--cfg", cfgp, "--band", "NIR", "--totest", "TEST",
                      "--params", npz, "--device", "cpu"])
    assert tf32_flags() == (False, False)
    names = [os.path.basename(p) for p in res["written"]]
    assert names == ["imgset1306.png", "imgset1307.png"]
    patches = lr.transpose(0, 1, 4, 5, 2, 3)
    scenes = JaxResolver(jm, params, scene_size=96).resolve_all(
        patches, progress=False)
    want = jax_write_submission(scenes, str(tmp_path / "jax"), "NIR",
                                "TEST", removed=[])
    assert [os.path.basename(p) for p in want] == names
    for got_p, want_p in zip(res["written"], want):
        a = read_png(got_p).astype(np.int64)
        b = imageio_read_png(want_p).astype(np.int64)
        assert a.shape == b.shape == (96, 96)
        assert np.abs(a - b).max() <= 1


def test_serve_cli_refuses_cuda_without_a_card(tree, monkeypatch):
    cfgp, _, _, _, _, npz = tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--cfg", cfgp, "--band", "NIR", "--params", npz])


def test_serve_without_params_restores_the_trainers_checkpoint(tree,
                                                                tmp_path):
    """Without --params the CLI serves the newest checkpoint that the train
    CLI wrote for the (cfg, band), as test.py does: the same PNGs as
    serving that checkpoint's parameters through --params."""
    from probav_tpu_torch.convert import save_npz
    from probav_tpu_torch.train import cli
    from probav_tpu_torch.train.trainer import restore_params
    from test_torch_train_cli import stage5_tree

    cfgp, cfg = stage5_tree(tmp_path)         # the same cfg as ``tree``'s
    cli.main(["--cfg", cfgp, "--band", "NIR", "--device", "cpu"])
    assert sorted(os.listdir(cfg.ckpt_dir("NIR")))[-1] == "step_00000004.pt"
    args = ["--cfg", cfgp, "--band", "NIR", "--totest", "TEST",
            "--device", "cpu"]
    out = cfg.out_dir("TEST")
    res = serve.main(args)
    os.rename(out, out + "_ckpt")
    npz = str(tmp_path / "trained.npz")
    save_npz(npz, restore_params(cfg.ckpt_dir("NIR")))
    want = serve.main(args + ["--params", npz])
    assert [os.path.basename(p) for p in res["written"]] == \
        [os.path.basename(p) for p in want["written"]] == \
        ["imgset1306.png", "imgset1307.png"]
    for p in want["written"]:
        got = read_png(os.path.join(out + "_ckpt", os.path.basename(p)))
        np.testing.assert_array_equal(got, read_png(p))
    # and not the seeded init's: the trained parameters were served
    init = str(tmp_path / "init.npz")
    from probav_tpu_torch.models.wdsr import build_model
    save_npz(init, build_model(cfg, "NIR", generator=torch.Generator()
                               .manual_seed(0)).state_dict())
    os.rename(out, out + "_npz")
    fresh = serve.main(args + ["--params", init])
    assert any((read_png(p) != read_png(os.path.join(
        out + "_npz", os.path.basename(p)))).any() for p in fresh["written"])


def test_serve_without_params_or_checkpoint_raises(tree):
    cfgp, cfg = tree[:2]
    with pytest.raises(FileNotFoundError, match="no checkpoint under .*"
                       "ckpt_synth"):
        serve.main(["--cfg", cfgp, "--band", "NIR", "--device", "cpu"])


def test_profile_serve_warm_rates_on_the_cpu(tree):
    """The warm-throughput helpers that chip_smoke.py and
    tools/profile_serve share: a warm-up resolve, then timed repeats."""
    from probav_tpu_torch.tools import profile_serve
    cfgp = tree[0]
    patches = serve.model_layout(profile_serve.synthetic_patches(1))
    assert patches.shape == (1, 64, 22, 22, 9, 1)
    assert 4000 <= patches.min() and patches.max() <= 12000
    r = profile_serve.make_resolver(cfgp, "float32", True, "cpu")
    assert r.scene_size == 16 * 3 * 8
    rates = profile_serve.warm_rates(r, patches, 2)
    assert len(rates) == 2 and all(x > 0 for x in rates)


def test_png_round_trip_against_imageio(tmp_path):
    r = np.random.default_rng(41)
    img = r.integers(0, 65536, (37, 53)).astype(np.uint16)
    img[0, :3] = (0, 65535, 1)
    path = str(tmp_path / "a.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(imageio_read_png(path), img)
    # clipped before the cast, as the JAX writer does (2**16 -> 65535)
    write_png(path, np.array([[70000.0, -3.0]]))
    np.testing.assert_array_equal(read_png(path), [[65535, 0]])


@pytest.mark.parametrize("depth,color,ftype", [(8, 2, 0), (16, 0, 5)],
                         ids=["8-bit", "filtered"])
def test_png_reader_refuses_what_the_writer_never_writes(tmp_path, depth,
                                                         color, ftype):
    """The reader covers grayscale at depths 1-16 with any of the PNG
    filter types 0-4 (tests/test_torch_evaluation.py,
    tests/test_torch_ingest.py); another colour type (8-bit RGB here) or
    filter type raises rather than decoding wrongly."""
    raw = bytes([ftype]) + bytes(2 * (3 if color == 2 else 1) * depth // 8)
    ihdr = struct.pack(">IIBBBBB", 2, 1, depth, color, 0, 0, 0)
    path = tmp_path / "x.png"
    path.write_bytes(png._SIG + png._chunk(b"IHDR", ihdr) +
                     png._chunk(b"IDAT", zlib.compress(raw)) +
                     png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="not supported|only"):
        read_png(str(path))
