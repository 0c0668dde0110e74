"""Command line: ``python -m tpuseg_torch.cli eval ...``."""
