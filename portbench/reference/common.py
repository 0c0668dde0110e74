"""Plain PyTorch building blocks of the benchmark's frozen references.

Everything here computes in float32 with TF32 off (``f32_math``), with no
kernel, cache, band or batching trick of the program. Module names follow
the program's state-dict names, so one seeded state dict loads into both.

``Precision`` is the arithmetic of a reference: ``F32`` is the reference
itself; ``FP8`` is the benchmark's control, the same reference with every
convolution's and matrix product's operands rounded to float8 e4m3 with a
per-tensor scale (the step below the bfloat16 the configurations state).
Its rounding passes gradients straight through.

Imports nothing of the program, of ``tpuseg`` or of JAX.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


class Precision:
    """Operand rounding of a reference's convolutions and products."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        amax = t.detach().abs().amax().clamp_min(1e-30)
        scale = 448.0 / amax
        r = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
        return t + (r - t).detach()


F32 = Precision(False)
FP8 = Precision(True)


@contextlib.contextmanager
def f32_math():
    """Float32 matrix products without TF32 and PyTorch's own convolutions
    and batch norm (im2col and cuBLAS GEMMs) in place of cuDNN's, restored
    on exit (the program runs with the process's own settings). cuDNN's
    f32 convolutions without TF32 take ~0.4-0.6 s for the forward and
    backward of one 192-channel 3x3 conv of the W48 trunk at batch 4 (64 x
    128), against ~3 ms for PyTorch's own, on an H100."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.enabled) = saved


class Conv(nn.Conv2d):
    """A convolution whose operands pass through the model's precision."""

    prec = F32

    def forward(self, x):
        w = self.prec.q(self.weight)
        return F.conv2d(self.prec.q(x), w, self.bias, self.stride,
                        self.padding, self.dilation, self.groups)


def set_precision(model: nn.Module, prec: Precision) -> nn.Module:
    for m in model.modules():
        if hasattr(m, "prec"):
            m.prec = prec
    return model


def conv(cin, cout, k, stride=1, padding=None, dilation=1, bias=False):
    pad = padding if padding is not None else (k - 1) // 2 * dilation
    return Conv(cin, cout, k, stride=stride, padding=pad, dilation=dilation,
                bias=bias)


def norm(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def bn_relu(c: int) -> nn.Sequential:
    return nn.Sequential(norm(c), nn.ReLU())


def resize(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear, half-pixel centres (align_corners False), to ``size``."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def resize_scale(x: torch.Tensor, s: float) -> torch.Tensor:
    h, w = x.shape[-2:]
    return resize(x, (math.floor(h * s), math.floor(w * s)))


def normalize(image_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> f32 NCHW, (v / 255 - mean) / std."""
    x = image_u8.float() / 255.0
    x = (x - torch.tensor(mean, device=x.device)) / torch.tensor(
        std, device=x.device)
    return x.permute(0, 3, 1, 2).contiguous()


@contextlib.contextmanager
def _frozen_stats(module: nn.Module):
    """A recomputed block normalises with its batch statistics again but
    leaves the running statistics as the first pass set them."""
    bns = [m for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [(bn.momentum, bn.num_batches_tracked.clone()) for bn in bns]
    for bn in bns:
        bn.momentum = 0.0
    try:
        yield
    finally:
        for bn, (mom, n) in zip(bns, saved):
            bn.momentum = mom
            bn.num_batches_tracked.copy_(n)


def recompute(module: nn.Module, *inputs, on: bool = True):
    """``module(*inputs)``, its activations recomputed in the backward when
    ``on`` and autograd records (memory only: the result is the same)."""
    if not (on and module.training and torch.is_grad_enabled()):
        return module(*inputs)
    return checkpoint(module, *inputs, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _frozen_stats(module)))


# ------------------------------------------------------------ losses

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL over pixels whose label is a class. logits (B, C, H, W)."""
    c = logits.shape[1]
    valid = (labels >= 0) & (labels < c)
    safe = torch.where(valid, labels, 0).long()
    nll = -torch.log_softmax(logits, 1).gather(1, safe[:, None])[:, 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)


# ------------------------------------------------------------ inputs

def seeded_state(model: nn.Module, seed: int, device, tails=(),
                 tail_scale: float = 1.0) -> dict:
    """The weights of ``model``'s state dict drawn from ``seed`` on
    ``device`` in one normal draw: convolutions at sqrt(2 / fan in) (He),
    their biases at 0.05, batch-norm scales at 1 +- 0.2 and shifts at
    +- 0.1, running statistics 0 and 1. The entries ``tails`` (the last
    layer of each residual branch) are drawn ``tail_scale`` times that, as
    a small last batch-norm scale starts a residual net (arXiv:1706.02677):
    a random net so started does not blow rounding up into other classes,
    and a comparison with the reference can see the arithmetic."""
    bn_names = {n for n, m in model.named_modules()
                if isinstance(m, nn.BatchNorm2d)}
    sd = model.state_dict()
    keys, numels, scale, shift = [], [], [], []
    for k, t in sd.items():
        if not t.is_floating_point():
            continue
        owner, last = k.rsplit(".", 1)
        if last in ("running_mean", "running_var"):
            continue
        if owner in bn_names:
            s, b = (0.2, 1.0) if last == "weight" else (0.1, 0.0)
        elif t.dim() == 4:
            s, b = math.sqrt(2.0 / t[0].numel()), 0.0
        else:
            s, b = 0.05, 0.0
        if k in tails:
            s, b = s * tail_scale, b * tail_scale
        keys.append(k)
        numels.append(t.numel())
        scale.append(s)
        shift.append(b)
    gen = torch.Generator(device=device).manual_seed(seed)
    n = torch.tensor(numels, device=device)
    flat = torch.randn(int(sum(numels)), generator=gen, device=device)
    flat = flat * torch.repeat_interleave(
        torch.tensor(scale, device=device), n) + torch.repeat_interleave(
        torch.tensor(shift, device=device), n)
    out, at = {}, 0
    for k, m in zip(keys, numels):
        out[k] = flat[at:at + m].view(sd[k].shape)
        at += m
    for k, t in sd.items():
        last = k.rsplit(".", 1)[-1]
        if last == "running_mean":
            out[k] = torch.zeros(t.shape, device=device)
        elif last == "running_var":
            out[k] = torch.ones(t.shape, device=device)
        elif last == "num_batches_tracked":
            out[k] = torch.zeros((), dtype=torch.long, device=device)
    return out


@torch.no_grad()
def calibrate_bn(model: nn.Module, run, keep_unit=()) -> dict:
    """Running statistics that keep a randomly drawn net's activations
    O(1) in eval mode: every batch norm (but those whose name holds one of
    ``keep_unit``) takes the average batch statistics of ``run()``, its
    variance floored at a tenth of the channel's second moment. Returns
    the new statistics."""
    bns = {n: m for n, m in model.named_modules()
           if isinstance(m, nn.BatchNorm2d)
           and not any(k in n for k in keep_unit)}
    for bn in bns.values():
        bn.reset_running_stats()
        bn.momentum = None
        bn.train()
    run()
    out = {}
    for n, bn in bns.items():
        bn.momentum = 0.1
        bn.eval()
        second = bn.running_mean ** 2 + bn.running_var
        bn.running_var.copy_(torch.maximum(bn.running_var, 0.1 * second))
        bn.num_batches_tracked.zero_()
        out[f"{n}.running_mean"] = bn.running_mean.clone()
        out[f"{n}.running_var"] = bn.running_var.clone()
    return out
