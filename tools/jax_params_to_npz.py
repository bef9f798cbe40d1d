#!/usr/bin/env python3
"""Export a JAX checkpoint's model parameters to the ``.npz`` that the
PyTorch port's serve CLI reads.

    python3 tools/jax_params_to_npz.py --cfg cfg/p16t9c85r12.cfg --band NIR \\
        --out nir_params.npz

Restores the latest orbax checkpoint of the (cfg, band) pair, as
``test.py`` does, and writes every parameter under its flat flax path
(``"resBlock_0/expand/kernel_v"``, ...) in float32.  Then:

    python3 -m probav_tpu_torch.serve --cfg cfg/p16t9c85r12.cfg --band NIR \\
        --params nir_params.npz

This is the only piece of the port that needs JAX; the port never imports
it.
"""

import argparse
import os
import sys
from collections.abc import Mapping

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def flatten(tree, prefix=""):
    """Nested dicts -> {"a/b/c": float32 array}.  The same mapping as
    probav_tpu_torch.convert.flatten_tree, kept here so that the exporter
    runs where torch is not installed."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v, dtype=np.float32)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", default="cfg/p16t9c85r12.cfg")
    p.add_argument("--band", default="NIR")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (default: the cfg's)")
    p.add_argument("--out", required=True)
    opt = p.parse_args(argv)

    import orbax.checkpoint as ocp
    from probav_tpu.config import Config

    ckpt = opt.ckpt_dir or Config.from_file(opt.cfg).ckpt_dir(opt.band)
    mngr = ocp.CheckpointManager(os.path.abspath(ckpt))
    step = mngr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt}")
    params = flatten(mngr.restore(step)["state"]["params"])
    np.savez(opt.out, **params)
    print(f"wrote {len(params)} arrays from step {step} of {ckpt} "
          f"to {opt.out}")


if __name__ == "__main__":
    main()
