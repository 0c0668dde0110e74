"""The port's one rule for arithmetic that must not run in a narrow type.

Where ``tpuseg`` computes in f32 (batch-norm statistics, softmaxes, the
losses, resize weights, the scale-fusion chain) the port computes in
``at_least_f32(dtype)``: f32 for bf16, f16 and f32 tensors (and for
integer or bool ones), and the tensor's own type when it is wider. So a
bf16 or f32 forward is unchanged, and an f64 one stays f64 end to end
(the CPU tests hold the dp x sp bands against one process there, where
f32 rounding would hide what they check).
"""
import torch


def at_least_f32(dtype: torch.dtype) -> torch.dtype:
    """``dtype`` promoted to at least f32 (f64 stays f64)."""
    return torch.promote_types(dtype, torch.float32)


def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in :func:`at_least_f32` of its dtype (itself if it is
    already)."""
    return x.to(at_least_f32(x.dtype))
