"""The port's Resolver and submission writer against the JAX ones."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probav_tpu.infer import Resolver as JaxResolver
from probav_tpu.infer import write_submission as jax_write_submission
from probav_tpu.models import WDSRConv3D as JaxWDSR
from probav_tpu.ops.patches import reconstruct_from_patches as jax_paste
from probav_tpu_torch.convert import to_state_dict
from probav_tpu_torch.infer import Resolver, load_removed_sets, \
    write_submission
from probav_tpu_torch.models import WDSRConv3D
from probav_tpu_torch.ops.patches import reconstruct_from_patches

torch.set_num_threads(1)

KW = dict(scale=3, num_filters=8, num_res_blocks=2, exp_rate=4,
          decay_rate=0.8, num_img_lr=9, patch_size_lr=16, mean=100.0,
          std=50.0)


@pytest.fixture(scope="module")
def setup():
    """3 scenes of a 2x2 grid of 22x22x9 patches (96x96 scenes)."""
    r = np.random.default_rng(30)
    patches = r.uniform(50, 150, (3, 4, 22, 22, 9, 1)).astype(np.float32)
    jm = JaxWDSR(**KW)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(patches[0][:1]))
    params = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a,
                          params["params"])
    return patches, jm, params


def as_uint16(scenes):
    return np.stack([np.clip(s, 0, 65535).astype(np.uint16)
                     for s in scenes]).astype(np.int64)


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta3"])
def test_resolve_all_matches_jax(setup, tta):
    """uint16 outputs within 1 count, differing on <= 0.1% of pixels."""
    patches, jm, params = setup
    ref = JaxResolver(jm, params, scene_size=96).resolve_all(
        patches, progress=False, tta=tta, tta_repeats=3)
    port = Resolver(WDSRConv3D(fused_stack=True, **KW),
                    to_state_dict(params), scene_size=96, device="cpu",
                    patches_per_call=8)               # 2 scenes per group
    got = port.resolve_all(patches, tta=tta, tta_repeats=3)
    assert len(got) == 3 and got[0].shape == (96, 96, 1)
    a, b = as_uint16(got), as_uint16(ref)
    diff = np.abs(a - b)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    # one scene alone gives the same as the grouped call
    if not tta:
        np.testing.assert_array_equal(port.resolve_scene(patches[2]), got[2])


def test_tta_perms_equal_jax():
    for t, r, seed in ((9, 20, 0), (7, 3, 5)):
        np.testing.assert_array_equal(Resolver._tta_perms(t, r, seed),
                                      JaxResolver._tta_perms(t, r, seed))


def test_reconstruct_from_patches_matches_jax():
    p = np.random.default_rng(2).normal(size=(16, 5, 5, 2)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        reconstruct_from_patches(torch.from_numpy(p), 20).numpy(),
        np.asarray(jax_paste(jnp.asarray(p), 20)))


def test_reconstruct_from_patches_keeps_a_group_dimension():
    p = np.random.default_rng(3).normal(size=(3, 16, 5, 5, 2)) \
        .astype(np.float32)
    got = reconstruct_from_patches(torch.from_numpy(p), 20).numpy()
    assert got.shape == (3, 20, 20, 2)
    for g in range(3):
        np.testing.assert_array_equal(got[g],
                                      np.asarray(jax_paste(jnp.asarray(p[g]),
                                                           20)))
    with pytest.raises(ValueError, match="do not tile"):
        reconstruct_from_patches(torch.from_numpy(p[:, :15]), 20)


def test_submission_names_match_jax_with_removed_sets(tmp_path):
    (tmp_path / "pre").mkdir()
    (tmp_path / "pre" / "removedTrainSetsNIR.txt").write_text(
        "1307\n1309.0\n")
    removed = load_removed_sets("NIR", search_dirs=(str(tmp_path / "pre"),
                                                    "."))
    assert removed == [1307, 1309]
    scenes = [np.full((6, 6, 1), 70000.0 * (i % 2)) for i in range(4)]
    got = write_submission(scenes, str(tmp_path / "port"), "NIR", "TEST",
                           removed)
    want = jax_write_submission(scenes, str(tmp_path / "jax"), "NIR",
                                "TEST", removed)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == \
        ["imgset1306.png", "imgset1308.png", "imgset1310.png",
         "imgset1311.png"]
