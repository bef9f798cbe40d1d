"""Model-vs-model evaluation: per-scene cPSNR and ESA scoring (port of
``probav_tpu/evaluation``)."""

from probav_tpu_torch.evaluation.compare import (
    per_scene_cpsnr,
    compare_runs,
    scatter_plot,
    load_norm_csv,
    normalized_score,
)

__all__ = [
    "per_scene_cpsnr", "compare_runs", "scatter_plot",
    "load_norm_csv", "normalized_score",
]
