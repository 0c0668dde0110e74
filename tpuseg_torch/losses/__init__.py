from tpuseg_torch.losses.ce import cross_entropy
from tpuseg_torch.losses.factory import get_val_loss

__all__ = ["cross_entropy", "get_val_loss"]
