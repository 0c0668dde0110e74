from tpuseg_torch.ops.normalize import device_label, device_normalize
from tpuseg_torch.ops.resize import resize_bilinear, resize_x, scale_as

__all__ = ["device_label", "device_normalize", "resize_bilinear",
           "resize_x", "scale_as"]
