"""Hand-written CUDA kernels for Hopper, one per ``tpuseg`` Pallas kernel.

Each module holds the kernel's wrapper (a CUDA tensor launches the kernel
or raises), its plain PyTorch version (taken for CPU tensors, and the
reference the kernel is checked against on the card). A launch counts in
the counter ``kernel.ocr_attention.launches``, ``kernel.bottleneck.launches``
or ``kernel.bottleneck_any.launches`` and runs under the span
``kernel.ocr_attention`` or ``kernel.bottleneck``
(``tpuseg_torch.utils.profiling``). Each wrapper is a registered op
(``tpuseg_torch::ocr_attention``, ``tpuseg_torch::bottleneck_fused``);
importing this package registers both,
which loading an exported program needs. The CUDA sources are in
``tpuseg_torch/csrc`` and are built by ``_build`` at first use.
"""
from tpuseg_torch.kernels import bottleneck_fused, ocr_attention  # noqa: F401
