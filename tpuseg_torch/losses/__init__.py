from tpuseg_torch.losses.ce import cross_entropy, image_weighted_cross_entropy
from tpuseg_torch.losses.factory import get_loss, get_val_loss
from tpuseg_torch.losses.rmi import rmi_loss

__all__ = ["cross_entropy", "get_loss", "get_val_loss",
           "image_weighted_cross_entropy", "rmi_loss"]
