"""Stage 1 and the host helpers of the port's preprocessing stage against
the JAX package: ``read_png`` at every grayscale bit depth against
imageio, the ingest of raw trees (16-, 8- and 1-bit masks, ragged frame
counts), ``extract_patches_np``, the stage-5 augments and the random
patch sampler, and the pickled artifacts across the two packages."""

import os
import zlib

import numpy as np
import pytest
import torch

from probav_tpu.data import augment as jaug
from probav_tpu.data import ingest as jingest
from probav_tpu.data import random_patches as jrp
from probav_tpu.ops.patches import extract_patches_np as jextract
from probav_tpu.utils import io as jio
from probav_tpu_torch.data import augment as paug
from probav_tpu_torch.data import ingest as pingest
from probav_tpu_torch.data import random_patches as prp
from probav_tpu_torch.ops.patches import extract_patches_np
from probav_tpu_torch.tools.time_png import predictors
from probav_tpu_torch.utils import io as pio
from probav_tpu_torch.utils import png
from probav_tpu_torch.utils.png import read_png
from synthetic_data import make_raw_tree

torch.set_num_threads(1)


def encode_gray(levels, depth, kinds) -> bytes:
    """A grayscale PNG of integer levels [h, w] (each < 2**depth) at
    ``depth`` bits, row y filtered with type kinds[y]."""
    h, w = levels.shape
    if depth == 16:
        raw = levels.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        raw = levels.astype(np.uint8)
    else:
        bits = (levels[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        raw = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
    pred = predictors(raw, bpp=max(1, depth // 8))
    rows = b"".join(bytes([k]) + ((raw[y] - pred[k][y]) % 256).astype(
        np.uint8).tobytes() for y, k in enumerate(kinds))
    ihdr = np.array([w, h], ">u4").tobytes() + bytes([depth, 0, 0, 0, 0])
    return (png._SIG + png._chunk(b"IHDR", ihdr) +
            png._chunk(b"IDAT", zlib.compress(rows, 6)) +
            png._chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [1, 2, 4, 8, 16])
def test_read_png_at_each_depth_matches_imageio(tmp_path, depth):
    """Odd widths (a row ends inside a byte below 8 bits), rows of every
    filter type: the values and dtype that imageio reads (bool at 1 bit,
    uint8 scaled by 255 / (2**depth - 1) at 2 and 4, uint8, uint16)."""
    r = np.random.default_rng(depth)
    levels = r.integers(0, 2 ** depth, (23, 37))
    path = tmp_path / f"d{depth}.png"
    path.write_bytes(encode_gray(levels, depth, r.integers(0, 5, 23)))
    got = read_png(str(path))
    want = jio.read_png(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape == (23, 37)
    np.testing.assert_array_equal(got, want)


def write_mask(path, clear, dtype):
    """A mask PNG as Pillow writes it: 1-bit from bool (imageio refuses
    bool arrays), else through imageio at the dtype's depth."""
    if dtype is bool:
        from PIL import Image
        Image.fromarray(clear).save(path)
    else:
        jio._iio.imwrite(path, clear.astype(dtype) * np.iinfo(dtype).max)


@pytest.mark.parametrize("dtype", [bool, np.uint8, np.uint16],
                         ids=["1-bit", "8-bit", "16-bit"])
def test_read_png_reads_imageio_written_masks(tmp_path, dtype):
    """Masks as Pillow writes them, read as imageio reads them (bool at 1
    bit, uint8 at 8)."""
    r = np.random.default_rng(3)
    m = r.uniform(size=(40, 31)) > 0.3
    path = str(tmp_path / "m.png")
    write_mask(path, m, dtype)
    got = read_png(path)
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, jio.read_png(path))
    np.testing.assert_array_equal(got > 0, m)


def test_read_png_refuses_a_transparent_colour(tmp_path):
    path = tmp_path / "t.png"
    ihdr = np.array([1, 1], ">u4").tobytes() + bytes([8, 0, 0, 0, 0])
    path.write_bytes(png._SIG + png._chunk(b"IHDR", ihdr) +
                     png._chunk(b"tRNS", b"\x00\x00") +
                     png._chunk(b"IDAT", zlib.compress(b"\x00\x07")) +
                     png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="tRNS"):
        read_png(str(path))


def rewrite_masks(raw, dtype):
    """Rewrite every QM and SM of a raw tree at ``dtype``'s depth."""
    for d, _, files in os.walk(raw):
        for f in files:
            if f.startswith(("QM", "SM")):
                p = os.path.join(d, f)
                write_mask(p, jio.read_png(p) > 0, dtype)


@pytest.mark.parametrize("masks", ["16-bit", "8-bit", "1-bit", "ragged"])
def test_ingest_matches_jax(tmp_path, masks):
    """Stage 1 of both packages on one raw tree: every array equal in
    data, shape and dtype; ragged frame counts give object arrays."""
    raw = make_raw_tree(str(tmp_path / "raw"), bands=("NIR",),
                        train_scenes=3, test_scenes=2, frames=5, seed=4)
    if masks in ("8-bit", "1-bit"):
        rewrite_masks(raw, np.uint8 if masks == "8-bit" else bool)
    if masks == "ragged":
        d = os.path.join(raw, "train", "NIR", "imgset0001")
        for f in ("LR004.png", "QM004.png", "LR003.png", "QM003.png"):
            os.unlink(os.path.join(d, f))
    for pkg, mod in (("jax", jingest), ("port", pingest)):
        for is_train in (True, False):
            n = mod.load_and_save_raw_data(raw, str(tmp_path / pkg), "NIR",
                                           is_train_data=is_train)
            if mod is pingest:
                assert n == (3 if is_train else 2)
    want = jingest.load_data(str(tmp_path / "jax"), "NIR")
    got = pingest.load_data(str(tmp_path / "port"), "NIR")
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype == object:
            assert masks == "ragged"
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(g, w)
    assert (got[0][0].dtype == object) == (masks == "ragged")


def test_missing_split_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="imgset"):
        pingest.load_and_save_raw_data(str(tmp_path), str(tmp_path / "a"),
                                       "NIR")


@pytest.mark.parametrize("patch,stride", [(22, 16), (48, 48), (5, 3)])
def test_extract_patches_np_matches_jax(patch, stride):
    x = np.random.default_rng(patch).uniform(size=(2, 3, 1, 70, 70))
    np.testing.assert_array_equal(extract_patches_np(x, patch, stride),
                                  jextract(x, patch, stride))


def test_augments_match_jax():
    r = np.random.default_rng(6)
    lr = np.ma.masked_array(r.uniform(size=(11, 6, 6, 9, 1)),
                            mask=r.uniform(size=(11, 6, 6, 9, 1)) > 0.8)
    hr = np.ma.masked_array(r.uniform(size=(11, 18, 18, 1)),
                            mask=r.uniform(size=(11, 18, 18, 1)) > 0.8)
    for n, split in ((90, 0.3), (11, 0.25), (7, 0.5)):
        for a, b in zip(paug.split_indices(n, split),
                        jaug.split_indices(n, split)):
            np.testing.assert_array_equal(a, b)
    outs = [
        (paug.split_patches(lr, hr, 0.25), jaug.split_patches(lr, hr, 0.25)),
        ([paug.augment_by_shuffling(lr, 2, np.random.default_rng(1))],
         [jaug.augment_by_shuffling(lr, 2, np.random.default_rng(1))]),
        ([paug.tile_hr_for_permutations(hr, 2)],
         [jaug.tile_hr_for_permutations(hr, 2)]),
        ([paug.augment_by_flipping(lr), paug.augment_by_rotating(hr)],
         [jaug.augment_by_flipping(lr), jaug.augment_by_rotating(hr)]),
    ]
    for got, want in outs:
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            np.testing.assert_array_equal(np.ma.getmaskarray(g),
                                          np.ma.getmaskarray(w))


def test_random_patches_match_jax():
    r = np.random.default_rng(7)
    lr = np.ma.masked_array(r.uniform(size=(3, 4, 1, 32, 32)),
                            mask=r.uniform(size=(3, 4, 1, 32, 32)) > 0.7)
    hr = np.ma.masked_array(r.uniform(size=(3, 1, 1, 96, 96)),
                            mask=r.uniform(size=(3, 1, 1, 96, 96)) > 0.9)
    args = (16, 6, 3, 5, 0.2)
    got = prp.sample_patch_dataset(lr, hr, *args, seed=3)
    want = jrp.sample_patch_dataset(lr, hr, *args, seed=3)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        np.testing.assert_array_equal(np.ma.getmaskarray(g),
                                      np.ma.getmaskarray(w))


def test_artifacts_load_across_packages(tmp_path):
    """The port's dump_masked loads in the JAX package's load_npy and the
    reverse, a masked array and a ragged object array alike; the port's
    pickles hold numpy objects only."""
    r = np.random.default_rng(8)
    masked = np.ma.masked_array(r.uniform(size=(2, 3, 4)),
                                mask=r.uniform(size=(2, 3, 4)) > 0.5)
    ragged = np.empty(2, object)
    ragged[0], ragged[1] = np.ones((3, 1, 2, 2), np.uint16), np.zeros(
        (4, 1, 2, 2), np.uint16)
    for i, arr in enumerate((masked, ragged)):
        for dump, load in ((pio.dump_masked, jio.load_npy),
                           (jio.dump_masked, pio.load_npy)):
            path = str(tmp_path / f"{i}_{dump.__module__}.npy")
            dump(arr, path)
            back = load(path)
            assert type(back) is type(arr) and back.dtype == arr.dtype
            if arr.dtype == object:
                for a, b in zip(back, arr):
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(back.data, arr.data)
                np.testing.assert_array_equal(back.mask, arr.mask)
            if dump is pio.dump_masked:
                with open(path, "rb") as f:
                    assert b"torch" not in f.read()
    with pytest.raises(TypeError, match="numpy"):
        pio.dump_masked(torch.zeros(2), str(tmp_path / "t.npy"))
