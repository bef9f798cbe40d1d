"""Host-side data: the shuffled batcher and device prefetch."""
