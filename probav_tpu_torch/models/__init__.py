from probav_tpu_torch.models.layers import (Conv, InstanceNorm, WNConv,
                                            mish, reflect_pad)
from probav_tpu_torch.models.wdsr import (
    FuseNetConv2D,
    IWDSRConv3D,
    WDSRBlock,
    WDSRConv3D,
    build_model,
    input_shape,
    reduction_schedule,
)

__all__ = ["Conv", "InstanceNorm", "WNConv", "mish", "reflect_pad",
           "FuseNetConv2D", "IWDSRConv3D", "WDSRBlock", "WDSRConv3D",
           "build_model", "input_shape", "reduction_schedule"]
