from probav_tpu_torch.infer.resolver import (
    Resolver,
    load_removed_sets,
    write_submission,
)

__all__ = ["Resolver", "load_removed_sets", "write_submission"]
