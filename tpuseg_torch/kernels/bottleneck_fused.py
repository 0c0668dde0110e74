"""Fused eval-mode HRNet stage-1 Bottleneck: CUDA kernel wrapper, its plain
version and the BN folding.

Port of ``tpuseg/kernels/bottleneck_fused.py``. With each BN folded into
its conv, ``relu(conv1x1(relu(conv3x3(relu(conv1x1(x)+b1))+b2))+b3 + x)``
with bf16 operands and intermediates and f32 accumulation. The kernel is
``csrc/bottleneck_fused.cu``; its header says what bounds it on the H100
and how it is laid out.

The kernel computes the block's math, i.e. ``reference_bottleneck``: the
3x3 reads zero at taps outside the image. (The TPU kernel reads relu(b1)
there; see ROADMAP Queue 3.)

Folded weights, NHWC-friendly as in ``tpuseg``:
  w1 (C, M)      b1 (M,)   conv1 1x1 + bn1
  w2 (9, M, M)   b2 (M,)   conv2 3x3, tap-major (ky * 3 + kx, in, out)
  w3 (M, C)      b3 (C,)   conv3 1x1 + bn3
weights bf16, biases f32.

Dispatch: a CPU tensor takes :func:`bottleneck_reference`; a CUDA tensor
launches the kernel or raises. There is no fallback.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuseg_torch.kernels import _build

# kernel launches since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0

_SMEM_LIMIT = 232448  # H100 dynamic shared memory a block may use


def fold_bn(weight: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5):
    """Fold an eval-mode BN into the preceding bias-free conv (OIHW):
    ``w' = w * s``, ``b' = bias - mean * s``, ``s = scale / sqrt(var+eps)``.
    Returns (weight', bias') in f32."""
    s = scale.float() * torch.rsqrt(var.float() + eps)
    return (weight.float() * s[:, None, None, None],
            bias.float() - mean.float() * s)


def bottleneck_reference(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Plain version (tpuseg ``reference_bottleneck``): three convs over the
    folded weights, with the operands rounded to bf16, f32 accumulation and
    bf16 intermediates. x (B, H, W, C) NHWC -> same shape, x's dtype."""
    bf = torch.bfloat16
    m = w1.shape[-1]

    def conv(t, w_oihw, pad):
        # bf16-rounded operands, f32 products and sums
        return F.conv2d(t.to(bf).float(), w_oihw.to(bf).float(), padding=pad)

    xc = x.permute(0, 3, 1, 2)
    t = conv(xc, w1.t()[:, :, None, None], 0)
    t = torch.relu(t + b1.float()[:, None, None]).to(bf)
    w2_oihw = w2.reshape(3, 3, m, m).permute(3, 2, 0, 1)
    t = conv(t, w2_oihw, 1)
    t = torch.relu(t + b2.float()[:, None, None]).to(bf)
    t = conv(t, w3.t()[:, :, None, None], 0)
    y = torch.relu(t + b3.float()[:, None, None] + xc.float())
    return y.to(x.dtype).permute(0, 2, 3, 1)


def _check(x, w1, b1, w2, b2, w3, b3):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    m = w1.shape[-1]
    want = {"w1": (c, m), "b1": (m,), "w2": (9, m, m), "b2": (m,),
            "w3": (m, c), "b3": (c,)}
    got = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} shape {tuple(got[name].shape)} != "
                             f"{shape} (C={c}, M={m})")
        if got[name].device != x.device:
            raise ValueError(f"{name} on {got[name].device}, x on "
                             f"{x.device}")


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Fused block over NHWC ``x`` (B, H, W, C) bf16 with folded weights
    (see the module docstring). Returns the same shape and dtype."""
    _check(x, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return bottleneck_reference(x, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, h, w, c = x.shape
    m = w1.shape[-1]
    if c % 16 or m % 16:
        raise ValueError(f"C={c} and M={m} must be multiples of 16")
    tensors = {"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3,
               "b3": b3}
    for name, t in tensors.items():
        want = torch.float32 if name.startswith("b") else torch.bfloat16
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 32:
            raise ValueError(f"{name} must be 32-byte aligned")
    lib = _build.library()
    smem = lib.tpuseg_bottleneck_smem_bytes(c, m)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"C={c}, M={m} needs {smem} B of shared memory, "
                         f"above {_SMEM_LIMIT}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    global LAUNCHES
    err = lib.tpuseg_bottleneck(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        b, h, w, c, m, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bottleneck_fused")
    LAUNCHES += 1
    return out
