"""Evaluation CLI of the PyTorch port (counterpart of ``evaluate.py``).

    python3 -m probav_tpu_torch.evaluate --cfg cfg/p16t9c85r12.cfg \\
        --toCompare <candidate_scene_dir> --benchmark <benchmark_scene_dir>

Scores both directories of predicted scenes against the stage-2 HR ground
truth in the cfg's ``resolverDir`` with the shift-compensated cPSNR, logs
per-band means and writes ``--out`` (a benchmark-vs-candidate scatter)
where matplotlib is installed.  With ``--norm-csv`` (the ESA per-scene
baseline file) it also logs the leaderboard's normalized score (lower is
better); ``--score-json`` writes the means and that score as JSON.
``--device`` defaults to ``cuda`` and fails without a card;
``--device cpu`` scores on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np

logger = logging.getLogger("probav_tpu_torch.evaluate")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", type=str, default="cfg/p16t9c85r12.cfg")
    p.add_argument("--toCompare", type=str, required=True)
    p.add_argument("--benchmark", type=str, required=True)
    p.add_argument("--red-count", type=int, default=594,
                   help="sorted scenes [0, N) are RED, the rest NIR")
    p.add_argument("--bands", type=str, default="RED,NIR",
                   help="comma list of bands with stage-2 HR artifacts")
    p.add_argument("--norm-csv", type=str, default=None)
    p.add_argument("--score-json", type=str, default=None,
                   help="also write per-band means + normalized score as "
                        "JSON")
    p.add_argument("--out", type=str, default="comparison.png")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns the report that ``--score-json`` writes."""
    opt = parse_args(argv)
    import torch

    from probav_tpu_torch.config import BAND_OFFSETS, Config
    from probav_tpu_torch.evaluation import (compare_runs, load_norm_csv,
                                             normalized_score, scatter_plot)
    from probav_tpu_torch.infer.resolver import load_removed_sets

    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    cfg = Config.from_file(opt.cfg)
    bands = tuple(b.strip().upper() for b in opt.bands.split(",") if b.strip())
    results = compare_runs(cfg.preprocessing_out, opt.benchmark,
                           opt.toCompare, red_count=opt.red_count,
                           bands=bands, device=device)
    for band, r in results.items():
        logger.info("[ %s ] benchmark mean cPSNR %.3f | candidate %.3f",
                    band, float(np.mean(r["benchmark"])),
                    float(np.mean(r["candidate"])))
    try:
        import matplotlib  # noqa: F401  (scatter_plot's only dependency)
    except ImportError:
        logger.info("[ SKIP ] %s: matplotlib is not installed", opt.out)
    else:
        logger.info("[ SAVE ] %s", scatter_plot(results, opt.out))

    report = {"bands": {
        band: {"benchmark_mean_cpsnr": float(np.mean(r["benchmark"])),
               "candidate_mean_cpsnr": float(np.mean(r["candidate"])),
               "scenes": int(len(r["candidate"]))}
        for band, r in results.items()}}

    if opt.norm_csv:
        norms = load_norm_csv(opt.norm_csv)
        scores = {}
        for band in results:
            # The submission writer's numbering: the band's TRAIN offset,
            # skipping removed scene ids, so each cPSNR divides the
            # matching scene's norm.
            i = BAND_OFFSETS[("TRAIN", band)]
            removed = set(load_removed_sets(
                band, search_dirs=(cfg.preprocessing_out, ".")))
            for v in results[band]["candidate"]:
                while i in removed:
                    i += 1
                scores[f"imgset{i:04d}"] = float(v)
                i += 1
        report["normalized_score"] = float(normalized_score(scores, norms))
        logger.info("[ SCORE ] normalized (lower is better): %.4f",
                    report["normalized_score"])

    if opt.score_json:
        with open(opt.score_json, "w") as f:
            json.dump(report, f, indent=1)
        logger.info("[ SAVE ] %s", opt.score_json)
    return report


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s - %(message)s",
                        level=logging.INFO)
    main()
