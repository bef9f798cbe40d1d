"""The flax <-> PyTorch parameter converter (probav_tpu_torch/convert.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from probav_tpu.config import Config
from probav_tpu.models import build_model as jax_build_model
from probav_tpu.models import input_shape
from probav_tpu_torch.convert import (load_npz, save_npz, to_flat,
                                      to_state_dict, to_tree)
from probav_tpu_torch.models import WDSRConv3D, build_model

torch.set_num_threads(1)

FLAGSHIP = "cfg/p16t9c85r12.cfg"


def small_model(seed=0):
    return WDSRConv3D(num_filters=8, num_res_blocks=2, exp_rate=4,
                      patch_size_lr=4, generator=torch.Generator()
                      .manual_seed(seed))


def test_round_trip_tree_and_npz(tmp_path):
    state = small_model().state_dict()
    tree = to_tree(state)
    assert tree["resBlock_1"]["expand"]["kernel_v"].shape == (1, 1, 1, 8, 32)
    back = to_state_dict(tree)
    assert back.keys() == state.keys()
    for k in state:
        assert torch.equal(back[k], state[k]), k
    assert to_state_dict(to_flat(state)).keys() == state.keys()
    path = str(tmp_path / "p.npz")
    save_npz(path, state)
    loaded = load_npz(path)
    fresh = small_model(seed=1)
    fresh.load_state_dict(loaded)             # strict: same key set
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_flagship_parameter_count():
    m = build_model(Config.from_file(FLAGSHIP), "NIR")
    assert sum(p.numel() for p in m.parameters()) == 535_267


def test_build_model_from_a_cfg_path_equals_from_a_config():
    gen = lambda: torch.Generator().manual_seed(3)        # noqa: E731
    a = build_model(FLAGSHIP, "NIR", generator=gen())
    b = build_model(Config.from_file(FLAGSHIP), "NIR", generator=gen())
    assert (a.mean, a.std, a.block_names) == (b.mean, b.std, b.block_names)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_keys_and_shapes_equal_jax_init_tree():
    """Every flax parameter of the flagship has a port counterpart of the
    same shape (JAX layout kept), and nothing else exists."""
    cfg = Config.from_file(FLAGSHIP)
    jm = jax_build_model(cfg, "NIR")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros(input_shape(cfg), jnp.float32))
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}.{k}" if prefix else k
            if hasattr(v, "shape"):
                flat[key] = tuple(v.shape)
            else:
                walk(v, key)

    walk(shapes["params"], "")
    port = {k: tuple(v.shape) for k, v in
            build_model(cfg, "NIR").state_dict().items()}
    assert port == flat
    assert sum(int(np.prod(s)) for s in flat.values()) == 535_267


def test_exporter_writes_the_npz_the_port_loads(tmp_path):
    """tools/jax_params_to_npz.py restores an orbax checkpoint in the
    trainer's layout and writes flat keys that load strictly into the port."""
    import importlib.util
    from pathlib import Path

    import orbax.checkpoint as ocp
    from probav_tpu.models import WDSRConv3D as JaxWDSR

    kw = dict(num_filters=8, num_res_blocks=2, exp_rate=4, patch_size_lr=4)
    jm = JaxWDSR(**kw)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 10, 10, 9, 1)))
    payload = {"state": {"params": jax.tree.map(np.asarray, params["params"]),
                         "step": np.int32(7)}, "best_psnr": 1.5}
    ckpt = str(tmp_path / "ckpt")
    mngr = ocp.CheckpointManager(ckpt)
    mngr.save(7, args=ocp.args.StandardSave(payload))
    mngr.wait_until_finished()

    tool = Path(__file__).resolve().parent.parent / "tools" / \
        "jax_params_to_npz.py"
    spec = importlib.util.spec_from_file_location("jax_params_to_npz", tool)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = str(tmp_path / "p.npz")
    mod.main(["--ckpt-dir", ckpt, "--out", out])

    port = WDSRConv3D(**kw)
    port.load_state_dict(load_npz(out))
    want = to_state_dict(params["params"])
    for k, v in port.state_dict().items():
        assert torch.equal(v, want[k]), k
