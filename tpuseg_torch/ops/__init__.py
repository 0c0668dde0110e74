from tpuseg_torch.ops.normalize import device_label, device_normalize
from tpuseg_torch.ops.precision import at_least_f32, upcast
from tpuseg_torch.ops.resize import (
    MaxPool2d,
    avg_pool2d,
    global_avg_pool,
    max_pool2d,
    resize_bilinear,
    resize_x,
    scale_as,
)

__all__ = ["MaxPool2d", "at_least_f32", "avg_pool2d", "device_label",
           "device_normalize", "global_avg_pool", "max_pool2d",
           "resize_bilinear", "resize_x", "scale_as", "upcast"]
