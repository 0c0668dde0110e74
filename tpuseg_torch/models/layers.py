"""Shared building blocks: conv with compute-dtype casting, BN, heads.

Port of ``tpuseg/models/layers.py:93-230``. Parameters are f32; a conv
casts its weight (and bias) to the dtype of its input, so the compute dtype
is the dtype the trunk casts its input to (``model.compute_dtype``, bf16 by
default), as ``tpuseg``'s ``dtype=`` convs do.

Module names follow the NVIDIA reference's torch state-dict tree, so that
the key map ``tpuseg_torch/keymap.py`` (reference names <-> ``tpuseg``'s
flax paths) maps ``tpuseg``'s variables onto this package's parameters.

``Norm`` is ``nn.BatchNorm2d(eps=1e-5, momentum=0.1)``: ``tpuseg``'s
``TorchBatchNorm`` copies torch's own running-variance update. One case
differs: a training batch with one value per channel (ASPP's image-pool
branch at batch 1), where ``nn.BatchNorm2d`` raises and ``tpuseg`` returns
the BN bias (variance 0) and updates the running variance with Bessel's
factor ``n / max(n - 1, 1) = 1`` (``tpuseg/models/layers.py:78-85``).
``BatchNorm2d.forward`` computes that case explicitly.

With more than one rank (``tpuseg_torch.parallel``), a training
``BatchNorm2d`` takes its statistics over the global batch, as ``tpuseg``'s
batch norm does under the mesh (``tpuseg/models/layers.py:8-13``):
``_GlobalBatchNorm`` all-reduces the per-channel sums in the forward and
the gradient sums in the backward. ``nn.SyncBatchNorm`` raises on CPU
tensors, and ``convert_sync_batchnorm`` would replace this class.

Under dp x sp (``parallel/spatial.py``) each rank holds a band of every
image: ``Conv2d`` then fetches the halo rows its output band reads from the
neighbouring bands and convolves with no H padding (a 1x1 conv reads no
other row, and runs on the band's padding rows too: whatever it makes
there, every consumer leaves out), and batch norm's global statistics
cover every true pixel once: its sums, count and backward sums leave out
a band's padding rows (``spatial.valid_rows``), which it sets to zero.
The OCR block's class proxies are the same on every rank of an sp group
(``spatial.replicated``): there batch norm counts each value once for
Bessel's factor.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from tpuseg_torch.ops import upcast
from tpuseg_torch.parallel import process_count, spatial
from tpuseg_torch.utils.profiling import spanned


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose f32 parameters are cast to the input's dtype.
    With ``nchw`` set, input and weight go to NCHW memory first (cuDNN
    picks channels_last when either is; see ``heads.py`` for why). On a
    band (``spatial.sharded``), a conv that reads across rows takes its
    halo first."""

    nchw = False

    def band_rows(self, x: torch.Tensor) -> tuple:
        """(x, padding): on a band, x with the halo rows its output rows
        read and no H padding; else both as they are."""
        padding = self.padding
        if spatial.active() is not None and (
                self.kernel_size[0], self.stride[0], padding[0]) != (1, 1, 0):
            x = spatial.conv_rows(x, self.kernel_size[0], self.stride[0],
                                  padding[0], self.dilation[0])
            padding = (0, padding[1])
        return x, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        weight = self.weight.to(x.dtype)
        x, padding = self.band_rows(x)
        if self.nchw:
            x, weight = x.contiguous(), weight.contiguous()
        return F.conv2d(x, weight, bias, self.stride, padding,
                        self.dilation, self.groups)


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         padding: int | None = None, dilation: int = 1,
         bias: bool = False) -> Conv2d:
    """Conv with torch-style symmetric padding, ``(kernel-1)//2*dilation``
    by default (tpuseg ``layers.conv``)."""
    pad = padding if padding is not None else (kernel - 1) // 2 * dilation
    return Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                  dilation=dilation, bias=bias)


class _GlobalBatchNorm(torch.autograd.Function):
    """Training batch norm over every rank's batch, in f32, in two passes:
    the global sum and count give the mean, then the global sum of squared
    deviations the (biased) variance. The backward all-reduces the
    per-channel sums of ``dy`` and ``dy * xhat``, so each rank's input
    gradient is that of every rank's loss (nn.SyncBatchNorm's scheme);
    the weight and bias gradients stay local for DDP to average. Saves the
    input in its own dtype. On a band with padding rows (``valid`` true
    rows of its H, a prefix), every sum covers the true rows only, and
    the output and the input gradient are zero on the padding rows.
    Returns (y, mean, var, count)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, valid=None):
        c = x.shape[1]
        view = (1, c, 1, 1)
        xf = upcast(x)
        xt = xf if valid is None else xf.narrow(2, 0, valid)
        stats = torch.cat([xt.sum(dim=(0, 2, 3)),
                           xf.new_full((1,), xt.numel() // c)])
        dist.all_reduce(stats)
        n = stats[c]
        mean = stats[:c] / n
        xc = xf - mean.view(view)
        xct = xc if valid is None else xc.narrow(2, 0, valid)
        sq = (xct * xct).sum(dim=(0, 2, 3))
        dist.all_reduce(sq)
        var = sq / n
        invstd = torch.rsqrt(var + eps)
        y = xc * invstd.view(view)
        if weight is not None:
            y = y * weight.view(view) + bias.view(view)
        if valid is not None:
            y.narrow(2, valid, y.shape[2] - valid).zero_()
        ctx.valid = valid
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var, n)
        return y.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, dy, *_):
        x, weight, mean, invstd, n = ctx.saved_tensors
        valid = ctx.valid
        c = x.shape[1]
        view = (1, c, 1, 1)
        dyf = upcast(dy)
        xhat = (upcast(x) - mean.view(view)) * invstd.view(view)
        dyt, xht = ((dyf, xhat) if valid is None else
                    (dyf.narrow(2, 0, valid), xhat.narrow(2, 0, valid)))
        local = torch.cat([dyt.sum(dim=(0, 2, 3)),
                           (dyt * xht).sum(dim=(0, 2, 3))])
        total = local.clone()
        dist.all_reduce(total)
        scale = invstd if weight is None else invstd * weight
        dx = (dyf - (total[:c] / n).view(view)
              - xhat * (total[c:] / n).view(view)) * scale.view(view)
        if valid is not None:
            dx.narrow(2, valid, dx.shape[2] - valid).zero_()
        if weight is None:
            return dx.to(x.dtype), None, None, None, None
        return dx.to(x.dtype), local[c:], local[:c], None, None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that also trains on one value per channel, and
    over the global batch when more than one rank trains."""

    @spanned("op.bn")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and process_count() > 1:
            return self._global_batch(x)
        if self.training and x.numel() == x.shape[1]:
            return self._single_value(x)
        return super().forward(x)

    def _global_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Statistics over every rank's batch. One value per channel keys on
        the global count: ASPP's pooled BN at batch 1 a rank normalises
        ``world_size`` values, and one value over all ranks gives
        ``_single_value``'s result (mean = x, variance 0). The running
        variance takes Bessel's factor ``n / max(n - 1, 1)`` of the global
        count ``n``, each value held alike by the ranks of an sp group
        (``spatial.replicated``) counted once, and a band's padding rows
        not at all."""
        valid = spatial.valid_rows(x)
        y, mean, var, n = _GlobalBatchNorm.apply(
            x, self.weight, self.bias, self.eps,
            None if valid == x.shape[2] else valid)
        # a tensor held alike by every rank of an sp group counts once
        n = n / spatial.replicas()
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = (1.0 / float(self.num_batches_tracked)
                     if self.momentum is None else self.momentum)
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(
                    m * var * n / (n - 1).clamp_min(1))
        return y

    def _single_value(self, x: torch.Tensor) -> torch.Tensor:
        """``tpuseg``'s batch norm over n = 1 value per channel: mean = x,
        variance 0 (so the output is the bias, and x gets no gradient, as
        in ``tpuseg``), running variance updated with Bessel's factor 1."""
        xf = upcast(x)
        mean = xf.mean(dim=(0, 2, 3), keepdim=True)
        xc = xf - mean
        var = (xc * xc).mean(dim=(0, 2, 3), keepdim=True)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                # momentum None: the cumulative average, as nn.BatchNorm2d
                m = (1.0 / float(self.num_batches_tracked)
                     if self.momentum is None else self.momentum)
                self.running_mean.mul_(1 - m).add_(m * mean.flatten())
                self.running_var.mul_(1 - m).add_(m * var.flatten())
        y = xc * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def Norm(channels: int, eps: float = 1e-5) -> BatchNorm2d:
    """Batch norm with torch defaults, as the reference (mynn.py:18-24)."""
    return BatchNorm2d(channels, eps=eps, momentum=0.1)


def bn_relu(channels: int) -> nn.Sequential:
    """The reference's ``BNReLU`` (Sequential(BN, ReLU)): BN at ``.0``."""
    return nn.Sequential(Norm(channels), nn.ReLU())


def ConvNormAct(cin: int, cout: int, kernel: int = 3, bias: bool = False
                ) -> nn.Sequential:
    """conv -> BNReLU as the reference's OCR blocks name it: the conv at
    ``.0`` and the BN at ``.1.0`` (tpuseg ``ConvNormAct``)."""
    return nn.Sequential(conv(cin, cout, kernel, bias=bias), bn_relu(cout))


class ConvBnRelu(nn.Module):
    """conv -> BN -> relu as the reference's ConvBnRelu names it (``conv``,
    ``bn``; network/utils.py:144-159), for the Deeper decoders'
    ``conv_up2`` / ``conv_up3`` (tpuseg ``ConvNormAct``)."""

    def __init__(self, cin: int, cout: int, kernel: int, padding: int):
        super().__init__()
        self.conv = conv(cin, cout, kernel, padding=padding)
        self.bn = Norm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


def SegHead(cin: int, out_ch: int, bot_ch: int = 256) -> nn.Sequential:
    """3x3 -> BN -> relu -> 3x3 -> BN -> relu -> 1x1 classifier, as the
    reference's make_seg_head Sequential (network/utils.py:320-329: convs
    at ``.0``, ``.3``, ``.6``, BNs at ``.1``, ``.4``; tpuseg ``SegHead``)."""
    return nn.Sequential(conv(cin, bot_ch, 3), Norm(bot_ch), nn.ReLU(),
                         conv(bot_ch, bot_ch, 3), Norm(bot_ch), nn.ReLU(),
                         conv(bot_ch, out_ch, 1))


class AttnHead(nn.Module):
    """Scale-attention head: conv-BN-relu (x2) -> conv -> sigmoid in f32
    (tpuseg ``AttnHead``; reference make_attn_head, network/utils.py:
    343-367). ``old_arch`` keeps the reference's ``kernel_size=out_ch``,
    unpadded final conv and its zero init (utils.py:332-381)."""

    def __init__(self, cin: int, out_ch: int = 1, bot_ch: int = 256,
                 inner_3x3: bool = True, dropout: bool = False,
                 old_arch: bool = False):
        super().__init__()
        self.conv0 = conv(cin, bot_ch, 3)
        self.bn0 = Norm(bot_ch)
        if old_arch or inner_3x3:
            self.conv1 = conv(bot_ch, bot_ch, 3)
            self.bn1 = Norm(bot_ch)
        else:
            self.conv1 = self.bn1 = None
        self.drop = nn.Dropout(0.5) if dropout and not old_arch else None
        if old_arch:
            self.conv2 = conv(bot_ch, out_ch, out_ch, padding=0)
            for c in (self.conv0, self.conv1, self.conv2):
                c.zero_init = True  # init_attn (utils.py:370-381)
        else:
            self.conv2 = conv(bot_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn0(self.conv0(x)))
        if self.conv1 is not None:
            x = torch.relu(self.bn1(self.conv1(x)))
        if self.drop is not None:
            x = self.drop(x)
        # sigmoid in f32: attention weights feed long fusion chains
        return torch.sigmoid(upcast(self.conv2(x)))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded fresh init with ``tpuseg``'s defaults: kaiming-normal (fan_in,
    gain sqrt 2) convs, BN weight 1 / bias 0, running stats 0 / 1, conv
    biases 0. Modules may override with an ``init_std`` attribute on a conv
    (the HRNet trunk's normal(0.001)) or ``zero_init``."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            if getattr(m, "zero_init", False):
                nn.init.zeros_(m.weight)
            else:
                fan_in = m.weight[0].numel()
                std = getattr(m, "init_std", None) or math.sqrt(2.0 / fan_in)
                with torch.no_grad():
                    m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.reset_running_stats()
