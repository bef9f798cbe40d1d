"""The port's registration (probav_tpu_torch/ops/registration.py) against
the JAX package's on the CPU: the host path (numpy, float64) against
``probav_tpu.ops.registration``'s, and the device path
(``register_scenes_torch`` on CPU tensors) against ``register_scenes_jax``
on the CPU, for both techniques: the same shifts and the same registered
arrays, exactly."""

import numpy as np
import pytest
import torch

from probav_tpu.ops import registration as jreg
from probav_tpu_torch.data import ingest
from probav_tpu_torch.ops import registration as preg
from synthetic_data import _base_scene, make_raw_tree

torch.set_num_threads(1)
TECHS = ("freq", "time")


def assert_same(got, want):
    """Two masked scene stacks equal in data, mask, shape and dtype."""
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.ma.getmaskarray(got),
                                  np.ma.getmaskarray(want))


def shifted(img, msk, dy, dx, tech):
    """The frame (and its clear mask) moved by an integer (dy, dx), as each
    technique resamples: a roll ('freq'), scipy's reflect mode for the
    image and constant 0 for the mask ('time'); order 0 is an exact
    gather."""
    if tech == "freq":
        return (np.roll(img, (dy, dx), axis=(-2, -1)),
                np.roll(msk, (dy, dx), axis=(-2, -1)))
    from scipy import ndimage
    s = (0, dy, dx)
    return (ndimage.shift(img, s, order=0, mode="reflect"),
            ndimage.shift(msk.astype(np.uint8), s, order=0,
                          mode="constant", cval=0) > 0)


def check_shifts(out, shifts, img, msk, tech, atol=0.0):
    """out (a registered scene) is img's frames, clearest first, each moved
    by its row of shifts: the frame the reference elected is frame 0.
    ``atol`` for the host 'time' path, whose cubic spline reproduces an
    integer shift only to rounding (~1e-11 at these values)."""
    order = np.argsort([-np.count_nonzero(m) for m in msk])
    img = np.asarray(img, np.float64)[order]
    clear = np.asarray(msk)[order] > 0
    assert (shifts[0] == 0).all()
    for k, (dy, dx) in enumerate(shifts):
        want_i, want_m = shifted(img[k], clear[k], int(dy), int(dx), tech)
        np.testing.assert_allclose(np.asarray(out[k]), want_i, rtol=0,
                                   atol=atol)
        np.testing.assert_array_equal(~np.ma.getmaskarray(out[k]), want_m)


@pytest.fixture(scope="module")
def raw_scenes(tmp_path_factory):
    """The synthetic NIR tree (3 train and 2 test scenes of 5 frames,
    32^2) through the port's stage 1: uint16 frames and QM masks."""
    root = tmp_path_factory.mktemp("reg")
    raw = make_raw_tree(str(root / "raw"), bands=("NIR",), train_scenes=3,
                        test_scenes=2, frames=5)
    arrays = str(root / "arrays")
    for is_train in (True, False):
        ingest.load_and_save_raw_data(raw, arrays, "NIR",
                                      is_train_data=is_train)
    (img, msk, _, _), (img_t, msk_t) = ingest.load_data(arrays, "NIR")
    return (list(img) + list(img_t), list(msk) + list(msk_t))


@pytest.mark.parametrize("tech", TECHS)
def test_host_path_matches_jax(raw_scenes, tech):
    imgs, msks = raw_scenes
    for img, msk in zip(imgs, msks):
        got, shifts = preg.register_image_set(img, msk, tech=tech,
                                              return_shifts=True)
        assert_same(got, jreg.register_image_set(img, msk, tech=tech))
        assert shifts.shape == (len(img), 3) and (shifts[:, 0] == 0).all()
        check_shifts(got, shifts[:, 1:], img, msk, tech,
                     atol=1e-6 if tech == "time" else 0.0)


def test_host_shift_estimators_match_jax():
    r = np.random.default_rng(5)
    big = r.uniform(0, 255, (48, 48))
    ref, mov = big[8:40, 8:40][None], big[11:43, 6:38][None]
    rm = np.ones(ref.shape, bool)
    mm = r.uniform(size=mov.shape) > 0.3
    np.testing.assert_array_equal(preg.phase_correlation_shift(ref, mov),
                                  jreg.phase_correlation_shift(ref, mov))
    got = preg.masked_phase_correlation_shift(ref, mov, rm, mm)
    np.testing.assert_array_equal(
        got, jreg.masked_phase_correlation_shift(ref, mov, rm, mm))
    np.testing.assert_array_equal(got, [0, 3, -2])
    for tech in TECHS:
        for a, b in zip(preg.register_frame(mov, mm, ref, rm, tech=tech),
                        jreg.register_frame(mov, mm, ref, rm, tech=tech)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tech", TECHS)
def test_register_scenes_torch_matches_jax(raw_scenes, tech):
    imgs, msks = raw_scenes
    preg.reset_chunks()
    got, shifts = preg.register_scenes_torch(imgs, msks, "cpu", tech=tech,
                                             return_shifts=True)
    assert preg.CHUNKS == {"cpu": 1}          # one bucket, one chunk
    want = jreg.register_scenes_jax(imgs, msks, tech=tech)
    for g, w, s, img, msk in zip(got, want, shifts, imgs, msks):
        assert_same(g, w)
        assert s.dtype == np.int64 and s.shape == (len(img), 2)
        check_shifts(w, s, img, msk, tech)       # JAX applied these shifts


@pytest.mark.parametrize("tech", TECHS)
def test_ragged_buckets_chunk_tails_and_one_frame(tech):
    """Frame counts 3, 4 and 1 interleaved: buckets by count, five scenes
    of 3 frames at chunk 2 (a tail of one), and a one-frame scene, which
    is its own reference.  The scene order out is the order in."""
    r = np.random.default_rng(8)

    def scene(n):
        img = r.uniform(0, 60000, (n, 1, 24, 24)).round()
        for k in range(1, n):
            img[k] = np.roll(img[0], (k % 3 - 1, 2 - k % 5), axis=(1, 2))
        msk = (r.uniform(size=img.shape) > 0.2).astype(np.uint16) * 255
        return img.astype(np.uint16), msk

    counts = (3, 4, 3, 1, 3, 4, 3, 3)
    scenes = [scene(n) for n in counts]
    imgs = np.empty(len(scenes), object)
    msks = np.empty(len(scenes), object)
    for i, (a, b) in enumerate(scenes):
        imgs[i], msks[i] = a, b
    preg.reset_chunks()
    got, shifts = preg.register_scenes_torch(imgs, msks, "cpu", chunk=2,
                                             tech=tech, return_shifts=True)
    assert preg.CHUNKS == {"cpu": 3 + 1}     # 3-frame: 2+2+1, 4-frame: 2
    want = jreg.register_scenes_jax(imgs, msks, chunk=2, tech=tech)
    for i, n in enumerate(counts):
        assert got[i].shape == (n, 1, 24, 24)
        assert_same(got[i], want[i])
        check_shifts(got[i], shifts[i], imgs[i], msks[i], tech)
    np.testing.assert_array_equal(np.asarray(got[3][0]), imgs[3][0])
    # the pipeline's entry point, both backends: an object array of scenes
    for backend in ("torch", "numpy"):
        out = preg.register_images(imgs, msks, tech=tech, backend=backend,
                                   device="cpu")
        assert out.dtype == object and len(out) == len(counts)
        if tech == "freq" or backend == "torch":
            for i in range(len(counts)):
                assert_same(out[i], got[i])


@pytest.mark.parametrize("tech", TECHS)
def test_frames_that_tie_on_clearness_elect_jax_reference(tech):
    """19 frames, most of them fully clear, so their clearness ties: the
    reference frame is numpy's argsort's first, as in the JAX package
    (torch.argsort orders such ties differently)."""
    r = np.random.default_rng(9)
    base = r.uniform(0, 60000, (1, 20, 20))
    img = np.stack([np.roll(base, (k % 5 - 2, k % 3 - 1), axis=(1, 2))
                    for k in range(19)]).round().astype(np.uint16)
    msk = np.full(img.shape, 255, np.uint16)
    msk[[2, 7, 11], :, :3, :3] = 0
    order = np.argsort([-np.count_nonzero(m) for m in msk])
    got = preg.register_image_set_torch(img, msk, "cpu", tech=tech)
    want = jreg.register_scenes_jax([img], [msk], tech=tech)[0]
    assert_same(got, want)
    np.testing.assert_array_equal(np.asarray(got[0]), img[order[0]])
    assert_same(preg.register_image_set(img, msk, tech=tech)[:1], got[:1])


def planted_shifts(seed, band_count, train, test, frames, size):
    """The (dy, dx) that make_raw_tree rolled each frame by, scene by scene
    in its order, replaying its draws from the same Generator."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(band_count):
        for n in (train, test):
            for _ in range(n):
                _base_scene(rng, size)
                sh = []
                for f in range(frames):
                    sh.append(rng.integers(-2, 3, size=2))
                    rng.normal(0, 50, (size, size))
                    if f % 3 == 1:
                        rng.integers(0, size - 8, size=2)
                out.append(np.array(sh))
    return out


@pytest.mark.parametrize("tech", TECHS)
def test_both_recover_the_planted_shifts(raw_scenes, tech):
    """Each frame f of a synthetic scene is the base rolled by p[f] plus
    noise, so aligning frame f to the reference r takes p[r] - p[f]."""
    imgs, msks = raw_scenes
    planted = planted_shifts(0, 1, 3, 2, 5, 32)
    _, got = preg.register_scenes_torch(imgs, msks, "cpu", tech=tech,
                                        return_shifts=True)
    want = jreg.register_scenes_jax(imgs, msks, tech=tech)
    for p, s, w, img, msk in zip(planted, got, want, imgs, msks):
        order = np.argsort([-np.count_nonzero(m) for m in msk])
        np.testing.assert_array_equal(s, p[order[0]] - p[order])
        check_shifts(w, p[order[0]] - p[order], img, msk, tech)


def test_torch_backend_refuses_what_it_cannot_register():
    img = np.zeros((3, 2, 8, 8), np.uint16)
    with pytest.raises(ValueError, match="--reg-backend numpy"):
        preg.register_images([img], [img], backend="torch", device="cpu")
    with pytest.raises(ValueError, match="technique"):
        preg.register_scenes_torch([img[:, :1]], [img[:, :1]], "cpu",
                                   tech="fourier")
    with pytest.raises(ValueError, match="backend"):
        preg.register_images([img], [img], backend="jax")


def test_torch_backend_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((3, 1, 8, 8), np.uint16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preg.register_scenes_torch([img], [img], "cuda")
