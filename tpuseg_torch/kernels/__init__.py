"""Hand-written CUDA kernels for Hopper, one per ``tpuseg`` Pallas kernel.

Each module holds the kernel's wrapper (a CUDA tensor launches the kernel
or raises), its plain PyTorch version (taken for CPU tensors, and the
reference the kernel is checked against on the card) and a ``LAUNCHES``
counter. Each wrapper is a registered op (``tpuseg_torch::ocr_attention``,
``tpuseg_torch::bottleneck_fused``); importing this package registers both,
which loading an exported program needs. The CUDA sources are in
``tpuseg_torch/csrc`` and are built by ``_build`` at first use.
"""
from tpuseg_torch.kernels import bottleneck_fused, ocr_attention  # noqa: F401
