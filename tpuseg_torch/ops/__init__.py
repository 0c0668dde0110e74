from tpuseg_torch.ops.normalize import device_label, device_normalize
from tpuseg_torch.ops.resize import (
    avg_pool2d,
    max_pool2d,
    resize_bilinear,
    resize_x,
    scale_as,
)

__all__ = ["avg_pool2d", "device_label", "device_normalize", "max_pool2d",
           "resize_bilinear", "resize_x", "scale_as"]
