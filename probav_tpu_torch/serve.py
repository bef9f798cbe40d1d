"""Inference/submission CLI of the PyTorch port (counterpart of ``test.py``).

    python3 -m probav_tpu_torch.serve --cfg cfg/p16t9c85r12.cfg --band NIR \\
        --totest TEST [--params nir_params.npz] [--tta] [--bf16] [--plain]

Reads ``{totest}patchesLR_{band}.npy`` from the cfg's ``resolverDir``,
restores the model parameters from the newest checkpoint that
``python3 -m probav_tpu_torch.train`` wrote for the (cfg, band), as
``test.py`` does, or loads them from ``--params``, an ``.npz``
(``convert.save_npz``; ``tools/jax_params_to_npz.py`` exports one from a
JAX checkpoint), super-resolves every scene and writes
uint16 ``imgset%04d.png`` files with the reference numbering into the
cfg's output directory.  The WDSR-B stack runs on the hand-written CUDA
kernels unless ``--plain`` selects the plain PyTorch blocks.  ``--device``
defaults to ``cuda`` and fails without a card; ``--device cpu`` runs the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

logger = logging.getLogger("probav_tpu_torch.serve")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", default="cfg/p16t9c85r12.cfg")
    p.add_argument("--band", default="RED")
    p.add_argument("--totest", default="TEST")
    p.add_argument("--tta", action="store_true",
                   help="temporal-permutation test-time augmentation (20)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute dtype (default float32)")
    p.add_argument("--params", default=None,
                   help=".npz of the model parameters (flat 'a/b/c' keys); "
                        "default: the newest checkpoint of the cfg's "
                        "model_out/ckpt_<cfg>/<band>")
    p.add_argument("--device", default="cuda")
    p.add_argument("--plain", action="store_true",
                   help="plain PyTorch block stack instead of the kernels")
    return p.parse_args(argv)


def model_layout(patches) -> np.ndarray:
    """[S, P, T, C, h, w] resolver input -> the model's [S, P, h, w, T, C]
    (test.py:84-85), as a strided view that the resolver copies to the
    device as it is."""
    return np.asarray(patches, dtype=np.float32).transpose(0, 1, 4, 5, 2, 3)


def main(argv=None) -> dict:
    """Run the CLI; returns {"written": paths, "resolve_s": seconds}."""
    opt = parse_args(argv)
    import torch

    from probav_tpu_torch.config import Config
    from probav_tpu_torch.convert import load_npz
    from probav_tpu_torch.infer.resolver import (Resolver, load_removed_sets,
                                                 write_submission)
    from probav_tpu_torch.models.wdsr import build_model
    from probav_tpu_torch.train.trainer import restore_params

    if not opt.bf16:   # float32 products in float32: no one-pass TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    cfg = Config.from_file(opt.cfg)
    path = os.path.join(cfg.stage_dir("resolverDir"),
                        f"{opt.totest}patchesLR_{opt.band}.npy")
    logger.info("loading %s", path)
    patches = model_layout(np.load(path, allow_pickle=True))

    dtype = torch.bfloat16 if opt.bf16 else torch.float32
    model = build_model(cfg, opt.band, dtype=dtype,
                        fused_stack=not opt.plain)
    scene = cfg.patch_size * cfg.scale * int(np.sqrt(patches.shape[1]))
    params = (load_npz(opt.params) if opt.params else
              restore_params(cfg.ckpt_dir(opt.band)))
    resolver = Resolver(model, params, scene_size=scene, device=device)
    t0 = time.perf_counter()
    scenes = resolver.resolve_all(patches, tta=opt.tta)
    resolve_s = time.perf_counter() - t0

    removed = load_removed_sets(opt.band,
                                search_dirs=(cfg.preprocessing_out, "."))
    written = write_submission(scenes, cfg.out_dir(opt.totest), opt.band,
                               opt.totest, removed)
    logger.info("wrote %d scenes to %s (resolve %.3f s)", len(written),
                cfg.out_dir(opt.totest), resolve_s)
    return {"written": written, "resolve_s": resolve_s}


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s - %(message)s",
                        level=logging.INFO)
    main()
