"""The port's copy of the cfg parser (probav_tpu_torch/config.py) against
the JAX package's (probav_tpu/config.py): same flat dicts, same derived
values, same band tables."""

import glob
import os

import pytest

import probav_tpu.config as jcfg
import probav_tpu_torch.config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(ROOT, "cfg", "*.cfg")))


def test_both_cfgs_are_found():
    assert len(CFGS) >= 2


@pytest.mark.parametrize("path", CFGS, ids=os.path.basename)
def test_parse_cfg_matches_jax_package(path):
    assert tcfg.parse_cfg(path) == jcfg.parse_cfg(path)
    a, b = tcfg.Config.from_file(path), jcfg.Config.from_file(path)
    assert a.flat == b.flat and a.cfg_path == b.cfg_path
    for band in ("NIR", "RED"):
        assert a.ckpt_dir(band) == b.ckpt_dir(band)
        assert a.log_dir(band) == b.log_dir(band)
        assert a.band_stats(band) == b.band_stats(band)
    assert (a.lr_input_size, a.hr_patch_size) == (b.lr_input_size,
                                                  b.hr_patch_size)
    for name in tcfg.STAGE_DIRS:
        assert a.stage_dir(name) == b.stage_dir(name)
    assert a.out_dir("TEST") == b.out_dir("TEST")


def test_tables_match_jax_package():
    assert tcfg.BAND_STATS == jcfg.BAND_STATS
    assert tcfg.BAND_OFFSETS == jcfg.BAND_OFFSETS
    assert tcfg.SUPPORTED_KEYS == jcfg.SUPPORTED_KEYS
    assert tcfg.STAGE_DIRS == jcfg.STAGE_DIRS


def test_unsupported_key_raises_in_both(tmp_path):
    p = tmp_path / "bad.cfg"
    p.write_text("[Train]\nbatch_size=4\nnot_a_key=1\n")
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError, match="Unsupported"):
            mod.parse_cfg(str(p))
