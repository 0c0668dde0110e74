from tpuseg_torch.losses.ce import cross_entropy, image_weighted_cross_entropy
from tpuseg_torch.losses.factory import get_loss, get_val_loss
from tpuseg_torch.losses.relaxed import relaxed_soft_nll
from tpuseg_torch.losses.rmi import rmi_loss

__all__ = ["cross_entropy", "get_loss", "get_val_loss",
           "image_weighted_cross_entropy", "relaxed_soft_nll", "rmi_loss"]
