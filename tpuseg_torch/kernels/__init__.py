"""Hand-written CUDA kernels for Hopper: one per ``tpuseg`` Pallas kernel,
and the forward of ASPP's dilated convs (``dilated_conv``, which replaces
cuDNN's, not a Pallas kernel).

Each module holds the kernel's wrapper (a CUDA tensor launches the kernel
or raises), its plain PyTorch version (taken for CPU tensors, and the
reference the kernel is checked against on the card). A launch counts in
the counter ``kernel.ocr_attention.launches``, ``kernel.bottleneck.launches``,
``kernel.bottleneck_any.launches`` or ``kernel.dilated_conv.launches`` and
runs under the span ``kernel.ocr_attention``, ``kernel.bottleneck`` or
``kernel.dilated_conv`` (``tpuseg_torch.utils.profiling``). Each wrapper is
a registered op (``tpuseg_torch::ocr_attention``,
``tpuseg_torch::bottleneck_fused``, ``tpuseg_torch::dilated_conv3x3``);
importing this package registers them, which loading an exported program
needs. The CUDA sources are in ``tpuseg_torch/csrc`` and are built by
``_build`` at first use.
"""
from tpuseg_torch.kernels import (bottleneck_fused, dilated_conv,  # noqa: F401
                                  ocr_attention)
