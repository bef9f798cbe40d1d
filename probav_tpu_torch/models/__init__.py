from probav_tpu_torch.models.layers import WNConv, reflect_pad
from probav_tpu_torch.models.wdsr import (
    WDSRBlock,
    WDSRConv3D,
    build_model,
    input_shape,
    reduction_schedule,
)

__all__ = ["WNConv", "reflect_pad", "WDSRBlock", "WDSRConv3D",
           "build_model", "input_shape", "reduction_schedule"]
