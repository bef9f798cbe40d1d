"""Inference/submission CLI of the PyTorch port (counterpart of ``test.py``).

    python3 -m probav_tpu_torch.serve --cfg cfg/p16t9c85r12.cfg --band NIR \\
        --totest TEST [--params nir_params.npz] [--tta] [--bf16] [--plain] \\
        [--mesh-data N]

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
kernels' plain versions.  ``--mesh-data N`` (N >= 1; 0, the default, is
one process) serves on N ranks started by ``probav_tpu_torch.parallel
.launch`` (NCCL, rank r on ``cuda:r``; gloo under ``--device cpu``): each
rank predicts its share of every group's patches (the scene's patch count
must divide by N), and rank 0 writes the PNGs and returns the result.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

from typing import Optional

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
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel ranks, one a device (0: one process)")
    opt = p.parse_args(argv)
    if opt.mesh_data < 0:
        raise ValueError(f"--mesh-data {opt.mesh_data}: want 0 (one "
                         "process) or a rank count")
    return opt


def model_layout(patches) -> np.ndarray:
    """[S, P, T, C, h, w] resolver input -> the model's [S, P, h, w, T, C]
    (test.py:84-85), as a strided view that the resolver copies to the
    device as it is."""
    return np.asarray(patches, dtype=np.float32).transpose(0, 1, 4, 5, 2, 3)


def main(argv=None) -> dict:
    """Run the CLI; returns {"written": paths, "resolve_s": seconds}
    (rank 0's with --mesh-data)."""
    opt = parse_args(argv)
    import torch

    from probav_tpu_torch.parallel.launch import launch, set_tf32

    set_tf32(opt)
    if torch.device(opt.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    if opt.mesh_data:
        return launch(rank_main, opt.mesh_data, opt,
                      logging.getLogger().getEffectiveLevel(),
                      device=opt.device)
    return serve(opt)


def rank_main(mesh, opt, log_level) -> Optional[dict]:
    """One rank of ``--mesh-data``: ``serve`` on this rank's mesh
    (``cli_rank`` sets up its logging and precision)."""
    from probav_tpu_torch.parallel.launch import cli_rank

    cli_rank(mesh, opt, log_level)
    return serve(opt, mesh)


def serve(opt, mesh=None) -> Optional[dict]:
    """Resolve the cfg's scenes and write them (rank 0 of a mesh alone
    writes and returns the result; the other ranks return None)."""
    import torch

    from probav_tpu_torch.config import Config
    from probav_tpu_torch.convert import load_npz
    from probav_tpu_torch.infer.resolver import (Resolver, load_removed_sets,
                                                 write_submission)
    from probav_tpu_torch.models.wdsr import build_model
    from probav_tpu_torch.train.trainer import restore_params

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
    resolver = Resolver(model, params, scene_size=scene,
                        device=torch.device(opt.device), mesh=mesh)
    t0 = time.perf_counter()
    scenes = resolver.resolve_all(patches, tta=opt.tta)
    resolve_s = time.perf_counter() - t0
    if mesh is not None and not mesh.is_chief:
        return None

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
