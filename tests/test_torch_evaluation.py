"""The port's scorer (probav_tpu_torch/evaluation), its evaluate CLI and
its PNG reader, against the JAX package on the same seeded numpy inputs.

Scores agree within the JAX scorer's own bound, rtol 1e-5 and atol 1e-4 dB
(tests/test_eval_scorer.py); the port scores on the CPU here.
"""

import json
import logging
import os
import shutil
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from probav_tpu.config import BAND_OFFSETS as JAX_BAND_OFFSETS
from probav_tpu.config import Config as JaxConfig
from probav_tpu.evaluation import compare as jax_compare
from probav_tpu.infer import load_removed_sets as jax_load_removed_sets
from probav_tpu.utils.io import dump_masked
from probav_tpu.utils.io import read_png as imageio_read_png
from probav_tpu.utils.io import write_png as imageio_write_png
from probav_tpu_torch import evaluate
from probav_tpu_torch.evaluation import compare
from probav_tpu_torch.tools.time_png import (encode, filter_types,
                                             imageio_kinds)
from probav_tpu_torch.utils import png
from probav_tpu_torch.utils.png import read_png
from synthetic_data import write_cfg

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4


def scenes(n, size, seed, hidden=0.1, noise=300.0):
    """(masked hr [n, size, size, 1] float32, pred): values over the 16-bit
    range, ``hidden`` of the pixels masked with their data kept, pred the
    truth plus Gaussian noise, clipped."""
    r = np.random.default_rng(seed)
    data = r.uniform(0, 60000, (n, size, size, 1)).astype(np.float32)
    mask = r.uniform(size=data.shape) < hidden
    pred = np.clip(data + r.normal(0, noise, data.shape), 0,
                   65535).astype(np.float32)
    return np.ma.masked_array(data, mask=mask), pred


@pytest.mark.parametrize("n,size,batch", [(5, 24, 2), (2, 384, 16)],
                         ids=["24px_ragged", "384px"])
def test_per_scene_cpsnr_matches_jax(n, size, batch):
    """5 scenes at batch 2 leave a ragged tail of one; 384^2 is a scene."""
    hr, pred = scenes(n, size, seed=size)
    got = compare.per_scene_cpsnr(hr, pred, batch=batch, device="cpu")
    want = jax_compare.per_scene_cpsnr(hr, pred, batch=batch)
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_batch_size_invariance():
    hr, pred = scenes(5, 24, seed=1)
    a = compare.per_scene_cpsnr(hr, pred, batch=2, device="cpu")
    for batch in (1, 3, 16):
        np.testing.assert_allclose(
            compare.per_scene_cpsnr(hr, pred, batch=batch, device="cpu"), a,
            rtol=RTOL, atol=ATOL)


def test_two_prediction_stacks_in_one_call_equal_separate_calls():
    hr, pred = scenes(5, 24, seed=2)
    other = np.clip(pred + np.random.default_rng(3).normal(0, 500, pred.shape),
                    0, 65535).astype(np.float32)
    data, mask = np.asarray(hr, np.float32), ~np.ma.getmaskarray(hr)
    both = compare._score_batches(data, mask, [pred, other], batch=2,
                                  device="cpu")
    for got, p in zip(both, (pred, other)):
        np.testing.assert_array_equal(
            got, compare.per_scene_cpsnr(hr, p, batch=2, device="cpu"))


def test_masked_truth_keeps_its_data_as_in_jax():
    """The ground truth under the mask is the masked array's data, not
    zeros: both packages score it so, and zeroing it changes the score."""
    hr, pred = scenes(4, 32, seed=4, hidden=0.2)
    assert np.abs(hr.data[hr.mask]).min() > 0
    got = compare.per_scene_cpsnr(hr, pred, device="cpu")
    np.testing.assert_allclose(got, jax_compare.per_scene_cpsnr(hr, pred),
                               rtol=RTOL, atol=ATOL)
    zeroed = np.ma.masked_array(hr.filled(0), mask=hr.mask)
    assert (np.abs(compare.per_scene_cpsnr(zeroed, pred, device="cpu") - got)
            > 1.0).all()


def test_exact_prediction_without_mask_scores_inf_in_both():
    """mask=False gives a scalar mask: a full clear mask.  L2 = 0 at the
    zero shift gives +inf, unclamped."""
    data = np.random.default_rng(5).uniform(0, 60000, (3, 16, 16, 1)
                                            ).astype(np.float32)
    hr = np.ma.masked_array(data, mask=False)
    got = compare.per_scene_cpsnr(hr, data.copy(), device="cpu")
    want = jax_compare.per_scene_cpsnr(hr, data.copy())
    assert np.isposinf(got).all() and np.isposinf(want).all()


def test_empty_stack_and_bad_shapes():
    hr = np.ma.masked_array(np.zeros((0, 16, 16, 1), np.float32))
    assert compare.per_scene_cpsnr(hr, np.zeros((0, 16, 16, 1)),
                                   device="cpu").shape == (0,)
    z = torch.zeros(2, 16, 16, 1)
    with pytest.raises(ValueError, match="shapes"):
        compare.cpsnr_batch(z, z, torch.zeros(2, 16, 15, 1))
    with pytest.raises(ValueError, match="centre crop"):
        compare.cpsnr_batch(*(torch.zeros(1, 6, 6, 1),) * 3)


# -- compare_runs: the cases of tests/test_eval_alignment.py ---------------

def write_hr(resolver, band, data, hidden):
    """A stage-2 file: masked [S, 1, 1, H, W] float64, data kept under the
    mask."""
    arr = np.ma.masked_array(data[:, None, None], mask=hidden[:, None, None])
    dump_masked(arr, str(resolver / f"TRAINimgHR_{band}.npy"))


def write_preds(d, named):
    """PNGs through the JAX package's imageio writer (filtered rows)."""
    os.makedirs(d, exist_ok=True)
    for name, img in named:
        imageio_write_png(str(d / name), img)


def renamed(src, dst):
    """src's files, sorted, copied to dst as scene_<i>.png."""
    os.makedirs(dst, exist_ok=True)
    for i, n in enumerate(sorted(os.listdir(src))):
        shutil.copy(src / n, dst / f"scene_{i}.png")
    return dst


def alignment_tree(tmp_path, case):
    """(preprocessing_out, benchmark dir, candidate dir, red_count, bands,
    the pairing expected).  The benchmark is the truth plus noise, the
    candidate the truth itself; 10% of the truth masked, data kept."""
    r = np.random.default_rng(7)
    resolver = tmp_path / "chkpt" / "resolverDir"
    os.makedirs(resolver)
    noisy = lambda a: a + r.normal(0, 300, a.shape)
    if case in ("removed_scene_by_id", "positional_fallback"):
        # 4 NIR scenes (ids 594..597); 595 was removed.
        nir = r.uniform(0, 60000, (4, 32, 32))
        write_hr(resolver, "NIR", nir, r.uniform(size=nir.shape) < 0.1)
        keep = [(594, nir[0]), (596, nir[2]), (597, nir[3])]
        bands, red_count = ("NIR",), 0
    else:
        red = r.uniform(0, 60000, (3, 16, 16))
        nir = r.uniform(0, 60000, (2, 16, 16))
        write_hr(resolver, "RED", red, r.uniform(size=red.shape) < 0.1)
        write_hr(resolver, "NIR", nir, r.uniform(size=nir.shape) < 0.1)
        # RED ids 0, 1 (id 2 capped away by red_count) and both NIR scenes.
        keep = [(0, red[0]), (1, red[1]), (594, nir[0]), (595, nir[1])]
        bands, red_count = ("RED", "NIR"), 2
    bench, cand = tmp_path / "bench", tmp_path / "cand"
    write_preds(bench, [(f"imgset{sid:04d}.png", noisy(img))
                        for sid, img in keep])
    write_preds(cand, [(f"imgset{sid:04d}.png", img) for sid, img in keep])
    pairing = "by scene id"
    if case in ("positional_fallback", "red_count_positional"):
        bench = renamed(bench, tmp_path / "bench_alt")
        cand = renamed(cand, tmp_path / "cand_alt")
        pairing = "by position"
    return str(tmp_path / "chkpt"), str(bench), str(cand), red_count, bands, \
        pairing


@pytest.mark.parametrize("case", ["removed_scene_by_id", "red_count_ids",
                                  "red_count_positional",
                                  "positional_fallback"])
def test_compare_runs_matches_jax(tmp_path, caplog, case):
    pre, bench, cand, red_count, bands, pairing = alignment_tree(tmp_path,
                                                                 case)
    caplog.set_level(logging.INFO, logger=compare.logger.name)
    got = compare.compare_runs(pre, bench, cand, red_count=red_count,
                               bands=bands, device="cpu")
    assert pairing in caplog.text
    want = jax_compare.compare_runs(pre, bench, cand, red_count=red_count,
                                    bands=bands)
    assert list(got) == list(want) == list(bands)
    for band in bands:
        for k in ("benchmark", "candidate"):
            assert len(got[band][k]) == len(want[band][k]) > 0
            np.testing.assert_allclose(got[band][k], want[band][k],
                                       rtol=RTOL, atol=ATOL)


def test_missing_stage2_file_names_the_band(tmp_path):
    os.makedirs(tmp_path / "pred")
    with pytest.raises(FileNotFoundError, match="TRAINimgHR_RED.npy.*--bands"):
        compare.compare_runs(str(tmp_path), str(tmp_path / "pred"),
                             str(tmp_path / "pred"), device="cpu")


# -- the CLI ---------------------------------------------------------------

@pytest.fixture
def cli_tree(tmp_path):
    """A cfg over a stage-2 NIR file of 5 scenes (ids 594..598), with 595
    in removedTrainSetsNIR.txt, two prediction dirs, and a norm.csv."""
    cfgp = write_cfg(str(tmp_path / "synth.cfg"), raw=str(tmp_path / "raw"),
                     out=str(tmp_path / "chkpt"),
                     model_out=str(tmp_path / "mi"),
                     train_out=str(tmp_path / "to"),
                     test_out=str(tmp_path / "te"))
    cfg = JaxConfig.from_file(cfgp)
    resolver = tmp_path / "chkpt" / "resolverDir"
    os.makedirs(resolver)
    r = np.random.default_rng(9)
    nir = r.uniform(0, 60000, (5, 32, 32))
    write_hr(resolver, "NIR", nir, r.uniform(size=nir.shape) < 0.1)
    (tmp_path / "chkpt" / "removedTrainSetsNIR.txt").write_text("595\n")
    ids = (594, 596, 597, 598)
    bench, cand = tmp_path / "bench", tmp_path / "cand"
    write_preds(bench, [(f"imgset{sid:04d}.png",
                         nir[sid - 594] + r.normal(0, 300, (32, 32)))
                        for sid in ids])
    write_preds(cand, [(f"imgset{sid:04d}.png",
                        nir[sid - 594] + r.normal(0, 100, (32, 32)))
                       for sid in ids])
    norm = tmp_path / "norm.csv"
    norm.write_text("set,norm\n" + "".join(
        f"imgset{sid:04d},{40 + sid % 7}\n" for sid in range(594, 599)))
    argv = ["--cfg", cfgp, "--benchmark", str(bench), "--toCompare",
            str(cand), "--bands", "NIR", "--red-count", "0", "--norm-csv",
            str(norm), "--score-json", str(tmp_path / "score.json"),
            "--out", str(tmp_path / "comparison.png")]
    return argv, cfg, str(bench), str(cand), str(norm), tmp_path


def jax_report(cfg, bench, cand, norm):
    """What evaluate.py reports, from the JAX library functions."""
    res = jax_compare.compare_runs(cfg.preprocessing_out, bench, cand,
                                   red_count=0, bands=("NIR",))
    r = res["NIR"]
    scores, i = {}, JAX_BAND_OFFSETS[("TRAIN", "NIR")]
    removed = set(jax_load_removed_sets("NIR",
                                        search_dirs=(cfg.preprocessing_out,)))
    for v in r["candidate"]:
        while i in removed:
            i += 1
        scores[f"imgset{i:04d}"] = float(v)
        i += 1
    return {"bands": {"NIR": {
        "benchmark_mean_cpsnr": float(np.mean(r["benchmark"])),
        "candidate_mean_cpsnr": float(np.mean(r["candidate"])),
        "scenes": len(r["candidate"])}},
        "normalized_score": jax_compare.normalized_score(
            scores, jax_compare.load_norm_csv(norm))}


def test_evaluate_cli_matches_jax_library(cli_tree):
    argv, cfg, bench, cand, norm, tmp = cli_tree
    report = evaluate.main(argv + ["--device", "cpu"])
    with open(tmp / "score.json") as f:
        assert json.load(f) == report
    assert (tmp / "comparison.png").stat().st_size > 0
    want = jax_report(cfg, bench, cand, norm)
    assert report["bands"]["NIR"]["scenes"] == 4
    assert report.keys() == want.keys()
    for k, v in want["bands"]["NIR"].items():
        np.testing.assert_allclose(report["bands"]["NIR"][k], v, rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(report["normalized_score"],
                               want["normalized_score"], rtol=RTOL)


def test_evaluate_cli_without_matplotlib_skips_the_plot(cli_tree, caplog,
                                                        monkeypatch):
    argv, *_, tmp = cli_tree
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # import fails
    caplog.set_level(logging.INFO, logger=evaluate.logger.name)
    report = evaluate.main(argv + ["--device", "cpu"])
    with open(tmp / "score.json") as f:
        assert json.load(f) == report
    assert not (tmp / "comparison.png").exists()
    assert "[ SKIP ]" in caplog.text and "matplotlib" in caplog.text


def test_evaluate_cli_on_cuda_without_a_card_raises(cli_tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv, *_, tmp = cli_tree
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(argv)                      # --device defaults to cuda
    assert not (tmp / "score.json").exists()


# -- read_png --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_read_png_reads_the_jax_writers_scenes(tmp_path, kind):
    """384^2 uint16 PNGs written by the JAX package (imageio filters their
    rows), read pixel for pixel as imageio reads them."""
    r = np.random.default_rng(11)
    if kind == "random":
        img = r.integers(0, 65536, (384, 384))
    else:
        y, x = np.mgrid[0:384, 0:384]
        img = 30000 + 20000 * np.sin(x / 40.0) * np.cos(y / 55.0)
    path = str(tmp_path / "scene.png")
    imageio_write_png(path, img)
    rows = filter_types(open(path, "rb").read())
    assert rows.max() > 0                        # filtered scanlines
    # imageio's choice of filter per row, as tools/time_png.py makes it
    np.testing.assert_array_equal(
        rows, imageio_kinds(np.clip(img, 0, 65535).astype(np.uint16)))
    want = imageio_read_png(path)
    got = read_png(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


def test_read_png_undoes_each_filter_type(tmp_path):
    """Rows of every filter type 0-4, each after every other (the row above
    a row is already reconstructed), on values that carry across bytes and
    wrap mod 256."""
    r = np.random.default_rng(12)
    types = [0, 1, 2, 3, 4, 4, 3, 2, 1, 0, 3, 1, 4, 2, 0, 2, 4, 0, 1, 3]
    img = r.integers(0, 65536, (len(types), 9)).astype(np.uint16)
    img[3:6] = np.array([0, 65535, 255, 256, 65280, 1, 32768, 0, 65535])
    path = tmp_path / "filters.png"
    path.write_bytes(encode(img, types))
    assert filter_types(path.read_bytes()).tolist() == types
    np.testing.assert_array_equal(read_png(str(path)), img)
    np.testing.assert_array_equal(imageio_read_png(str(path)), img)


@pytest.mark.parametrize("kinds", [(0, 1, 2), (0, 1, 2, 3, 4)])
def test_read_png_undoes_rows_of_random_filter_types(tmp_path, kinds):
    """64x48 images whose rows take filter types drawn from ``kinds``: by
    whole rows where no row needs its left neighbour's sums (types 0-2),
    else by diagonals."""
    r = np.random.default_rng(len(kinds))
    img = r.integers(0, 65536, (64, 48)).astype(np.uint16)
    path = tmp_path / "rows.png"
    path.write_bytes(encode(img, r.choice(kinds, size=64)))
    np.testing.assert_array_equal(read_png(str(path)), img)


def test_time_png_tool_on_cpu(tmp_path):
    """tools/time_png.py at 2 scenes on the CPU: the port's rows all None,
    imageio's mostly Paeth, one JSON line appended."""
    from probav_tpu_torch.tools import time_png

    res = time_png.main(["--scenes", "2", "--reps", "1", "--device", "cpu",
                         "--out", str(tmp_path)])
    port, iio = (res["layouts"][k]["rows_by_filter_type"]
                 for k in ("port", "imageio"))
    assert port == [2 * 384, 0, 0, 0, 0]
    assert sum(iio) == 2 * 384 and iio[3] == 0 and iio[4] > 384
    line = (tmp_path / "time_png.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in line] == [res]


def test_read_png_refuses_interlaced_files(tmp_path):
    ihdr = struct.pack(">IIBBBBB", 2, 1, 16, 0, 0, 0, 1)
    path = tmp_path / "adam7.png"
    path.write_bytes(png._SIG + png._chunk(b"IHDR", ihdr) +
                     png._chunk(b"IDAT", zlib.compress(bytes(5))) +
                     png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="non-interlaced"):
        read_png(str(path))
