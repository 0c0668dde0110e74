from tpuseg_torch.utils.logging import Logger

__all__ = ["Logger"]
