"""Hand-written CUDA kernels for Hopper, one per ``tpuseg`` Pallas kernel.

Each module holds the kernel's wrapper (a CUDA tensor launches the kernel
or raises), its plain PyTorch version (taken for CPU tensors, and the
reference the kernel is checked against on the card) and a ``LAUNCHES``
counter. The CUDA sources are in ``tpuseg_torch/csrc`` and are built by
``_build`` at first use.
"""
