"""Preprocessing CLI of the PyTorch port (counterpart of
``data_generator.py``).

    python3 -m probav_tpu_torch.preprocess --cfg cfg/p16t9c85r12.cfg \\
        --band NIR [--ckpt 2,3] [--tech {freq,time}] \\
        [--reg-backend {torch,numpy}] [--device cuda] [--seed 0] \\
        [--outlier-threshold T] [--outlier-min-frames 9]

Runs the five resumable pipeline stages selected by the cfg ``ckpt`` list
(override with ``--ckpt 2,3``) from the raw PNG tree to the stage-5 arrays
that ``python3 -m probav_tpu_torch.train`` reads, with the JAX CLI's file
names in the same stage directories.  ``--tech time`` switches
registration to masked time-domain cross-correlation.

Registration runs on the card by default (``--reg-backend torch --device
cuda``), as every entry point of the port does, and fails without one: it
never quietly registers on the host.  ``--device cpu`` runs the torch
backend on the CPU; ``--reg-backend numpy`` registers on the host in
float64, which is the JAX CLI's default.  The other stages are host work.
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger("probav_tpu_torch.preprocess")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", default="cfg/p16t9c85r12.cfg", type=str)
    p.add_argument("--band", default="NIR", type=str)
    p.add_argument("--ckpt", default=None, type=str,
                   help="comma-separated stage list overriding the cfg")
    p.add_argument("--tech", default="freq", choices=["freq", "time"])
    p.add_argument("--reg-backend", default="torch",
                   choices=["torch", "numpy"],
                   help="'torch' registers on --device (both techniques); "
                        "'numpy' on the host")
    p.add_argument("--device", default="cuda",
                   help="device of the torch registration backend")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--outlier-threshold", default=None, type=float,
                   help="legacy v1 filter (utils/utils.py:492-531): drop "
                        "LR frames with any pixel above this (try "
                        "32000-60000); train scenes left with <9 frames "
                        "are removed")
    p.add_argument("--outlier-min-frames", default=9, type=int,
                   help="minimum LR frames a scene must keep after the "
                        "outlier filter (reference uses 9)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns ``pipeline.run``'s seconds and scene counts."""
    opt = parse_args(argv)
    import torch

    from probav_tpu_torch.config import Config
    from probav_tpu_torch.data import pipeline

    if opt.reg_backend == "torch" and \
            torch.device(opt.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(pass --device cpu to register on the CPU)")
    cfg = Config.from_file(opt.cfg)
    ckpts = ([int(x) for x in opt.ckpt.split(",")]
             if opt.ckpt else None)
    logger.info("[ CFG - INFO ] Using %s as config file...", opt.cfg)
    stats = pipeline.run(cfg, opt.band, ckpts=ckpts,
                         registration_tech=opt.tech,
                         registration_backend=opt.reg_backend,
                         device=opt.device, seed=opt.seed,
                         outlier_threshold=opt.outlier_threshold,
                         outlier_min_frames=opt.outlier_min_frames)
    for stage, secs in sorted(stats["seconds"].items()):
        n = stats["scenes"].get(stage)
        rate = f", {n / secs:.2f} scenes/s" if n and secs > 0 else ""
        logger.info("stage %d: %.3f s%s", stage, secs, rate)
    if stats["register_s"] > 0:
        logger.info("registration (%s, %s on %s): %.3f s", opt.tech,
                    opt.reg_backend, opt.device, stats["register_s"])
    return stats


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s - %(message)s",
                        level=logging.INFO)
    main()
