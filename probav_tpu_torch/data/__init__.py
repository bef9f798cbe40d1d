"""Host-side data: the preprocessing pipeline's stages (ingest, QC,
augment, random patches, the pipeline itself), the shuffled batcher and
device prefetch."""

from probav_tpu_torch.data.loader import Batcher, prefetch_to_device
from probav_tpu_torch.data import augment, ingest, pipeline, qc, random_patches

__all__ = [
    "Batcher", "prefetch_to_device",
    "augment", "ingest", "pipeline", "qc", "random_patches",
]
