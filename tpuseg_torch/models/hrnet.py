"""HRNetV2-W48 trunk (NCHW-logical tensors in channels_last memory).

Port of ``tpuseg/models/hrnet.py`` (reference: network/hrnetv2.py:263-449):
stem (2x stride-2 3x3) -> stage-1 bottlenecks -> three multi-resolution
stages with full cross-resolution fusion -> upsample-concat of all four
branches (48+96+192+384 = 720 ch at W48).

The module tree reproduces the reference's state-dict names: ``conv1``,
``bn1``, ``layer1.{b}``, ``transition{t}.{i}.0/1`` and
``transition{t}.{i}.{j}.0/1``, ``stage{s}.{m}.branches.{i}.{b}``,
``stage{s}.{m}.fuse_layers.{i}.{j}.0/1`` (j > i) and
``.fuse_layers.{i}.{j}.{k}.0/1`` (j < i), with ``None`` in identity slots.

On bands (dp x sp, ``parallel/spatial.py``) the upsamples take the
image's global sizes; the convs fetch their own halos.

``fused_stage1`` routes the eval-mode stage-1 identity bottlenecks through
the fused kernel (tpuseg_torch/kernels/bottleneck_fused.py).

``remat`` recomputes the listed stages' activations in the backward pass
instead of keeping them (``tpuseg/models/hrnet.py:252-308``): stage 1 per
``Bottleneck``, stages 2-4 per ``HRModule``; transitions never.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from tpuseg_torch.kernels.bottleneck_fused import (
    PackedWeights,
    fold_bn,
    fused_bottleneck_packed,
    pack_weights,
    supports,
)
from tpuseg_torch.models.layers import Norm, conv
from tpuseg_torch.ops import resize_bilinear
from tpuseg_torch.parallel import spatial
from tpuseg_torch.utils.profiling import span, spanned


@dataclass(frozen=True)
class HRNetSpec:
    """Stage spec; defaults = HRNetV2-W48 (reference: config.py:161-190).
    The same fields and values as ``tpuseg.models.hrnet.HRNetSpec``."""

    stage1_blocks: int = 4
    stage1_channels: int = 64
    stage2_modules: int = 1
    stage2_channels: Sequence[int] = (48, 96)
    stage2_blocks: int = 4
    stage3_modules: int = 4
    stage3_channels: Sequence[int] = (48, 96, 192)
    stage3_blocks: int = 4
    stage4_modules: int = 3
    stage4_channels: Sequence[int] = (48, 96, 192, 384)
    stage4_blocks: int = 4

    @property
    def high_level_ch(self) -> int:
        return int(sum(self.stage4_channels))


W48_SPEC = HRNetSpec()
# same topology, tiny widths (tests and smoke runs)
TINY_SPEC = HRNetSpec(
    stage1_blocks=1, stage1_channels=8,
    stage2_modules=1, stage2_channels=(8, 16), stage2_blocks=1,
    stage3_modules=1, stage3_channels=(8, 16, 32), stage3_blocks=1,
    stage4_modules=1, stage4_channels=(8, 16, 32, 64), stage4_blocks=1,
)


def _tconv(cin: int, cout: int, kernel: int, stride: int = 1):
    """Trunk conv: normal(std=0.001) init (reference: hrnetv2.py:457-458)."""
    c = conv(cin, cout, kernel, stride)
    c.init_std = 0.001
    return c


def _conv_bn(cin: int, cout: int, kernel: int, stride: int = 1, relu=True):
    layers = [_tconv(cin, cout, kernel, stride), Norm(cout)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


class BasicBlock(nn.Module):
    """3x3 -> BN -> relu -> 3x3 -> BN + residual (reference: hrnetv2.py:37-66)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _tconv(inplanes, planes, 3, stride)
        self.bn1 = Norm(planes)
        self.conv2 = _tconv(planes, planes, 3)
        self.bn2 = Norm(planes)
        self.downsample = (_conv_bn(inplanes, planes, 1, stride, relu=False)
                           if downsample else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + residual)


# the buffers Bottleneck.freeze_folded keeps: folded weights, packed block
_FROZEN = ("folded_w1", "folded_b1", "folded_w2", "folded_b2", "folded_w3",
           "folded_b3", "folded_blob")


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1(x4) bottleneck (reference: hrnetv2.py:69-106).

    With ``fused_kernel``, eval-mode blocks that are the stage-1 identity
    shape (no downsample, stride 1, bf16, C == 4 * planes) run the fused
    kernel over BN-folded weights, where a kernel ``supports`` the width:
    on CUDA, (C, planes) = (256, 64), W48's stage-1 width, runs the wgmma
    kernel, and every other width with planes a multiple of 8 up to 256
    the kernel of the other widths; any other width runs the unfused
    convs, as ``tpuseg``'s gate does for shapes its tiling does not take.
    ``tpuseg``'s TPU tiling conditions (batch 1, H % 16, W % 128) are not
    needed: the CUDA kernels cover the batch and ragged edges."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, fused_kernel: bool = False):
        super().__init__()
        self.planes = planes
        self.stride = stride
        self.fused_kernel = fused_kernel
        out = planes * self.expansion
        self.conv1 = _tconv(inplanes, planes, 1)
        self.bn1 = Norm(planes)
        self.conv2 = _tconv(planes, planes, 3, stride)
        self.bn2 = Norm(planes)
        self.conv3 = _tconv(planes, out, 1)
        self.bn3 = Norm(out)
        self.downsample = (_conv_bn(inplanes, out, 1, stride, relu=False)
                           if downsample else None)

    def _folded(self):
        """BN-folded weights packed for the kernel, built once and kept
        until a conv weight or a BN parameter or buffer is replaced or
        changed in place (``load_state_dict``, a BN calibration, ``.to``):
        the key is each source tensor's storage and version counter."""
        pairs = ((self.conv1, self.bn1), (self.conv2, self.bn2),
                 (self.conv3, self.bn3))
        key = tuple((t.data_ptr(), t._version) for c, bn in pairs
                    for t in (c.weight, bn.weight, bn.bias, bn.running_mean,
                              bn.running_var))
        cached = getattr(self, "_folded_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        with torch.no_grad():
            (w1, b1), (w2, b2), (w3, b3) = (
                fold_bn(c.weight, bn.weight, bn.bias, bn.running_mean,
                        bn.running_var, bn.eps) for c, bn in pairs)
            m, bf = self.planes, torch.bfloat16
            weights = pack_weights(
                w1[:, :, 0, 0].t().to(bf).contiguous(), b1,          # (C, M)
                w2.permute(2, 3, 1, 0).reshape(9, m, m).to(bf).contiguous(),
                b2, w3[:, :, 0, 0].t().to(bf).contiguous(), b3)      # (M, C)
        self._folded_cache = (key, weights)
        return weights

    def freeze_folded(self) -> None:
        """Fold and pack now, and keep the result as non-persistent
        buffers that the fused path reads until :meth:`thaw_folded` (the
        packed block is None on the CPU).
        ``torch.export`` cannot trace :meth:`_folded` (its cache key reads
        storage pointers and version counters, and the CUDA block is
        packed on the host); it carries these buffers as constants of the
        exported program. The state dict is unchanged."""
        packed = self._folded()
        for name, t in zip(_FROZEN, (*packed.weights, packed.blob)):
            self.register_buffer(name, t, persistent=False)

    def thaw_folded(self) -> None:
        """Back to folding on the weights' versions (eager eval)."""
        for name in _FROZEN:
            self._buffers.pop(name, None)

    def _fused_eval(self, x):
        # NHWC view of the channels_last activation (a no-op copy there)
        x = x.permute(0, 2, 3, 1).contiguous()
        if _FROZEN[0] in self._buffers:
            packed = PackedWeights(
                tuple(self._buffers[n] for n in _FROZEN[:6]),
                self._buffers[_FROZEN[6]])
        else:
            packed = self._folded()
        y = fused_bottleneck_packed(x, packed)
        return y.permute(0, 3, 1, 2)

    @property
    def fusable(self) -> bool:
        """Whether eval forwards may take the fused kernel: ``fused_kernel``
        on an identity block (no downsample, stride 1)."""
        return (self.fused_kernel and self.downsample is None
                and self.stride == 1)

    def forward(self, x):
        if (self.fusable and not self.training
                and x.dtype == torch.bfloat16
                and x.shape[1] == self.planes * self.expansion
                and supports(x.device, x.shape[1], self.planes)):
            return self._fused_eval(x)
        residual = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + residual)


class HRModule(nn.Module):
    """One HighResolutionModule: per-branch basic blocks + full cross-scale
    fusion (reference: hrnetv2.py:109-254)."""

    def __init__(self, channels: Sequence[int], num_blocks: int,
                 align_corners: bool = False):
        super().__init__()
        self.align_corners = align_corners
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(c, c) for _ in range(num_blocks)))
            for c in channels)
        if n == 1:
            self.fuse_layers = None
            return
        self.fuse_layers = nn.ModuleList()
        for i in range(n):
            row = nn.ModuleList()
            for j in range(n):
                if j == i:
                    row.append(None)
                elif j > i:
                    # 1x1 to C_i + BN; upsampled in forward
                    row.append(_conv_bn(channels[j], channels[i], 1,
                                        relu=False))
                else:
                    # (i-j) stride-2 3x3 convs; the last one to C_i, no relu
                    steps = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        out = channels[i] if last else channels[j]
                        steps.append(_conv_bn(channels[j], out, 3, 2,
                                              relu=not last))
                    row.append(nn.Sequential(*steps))
            self.fuse_layers.append(row)

    def forward(self, *xs):
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                if j == i:
                    contrib = ys[j]
                elif j > i:
                    # f32 resize island (tpuseg hrnet.py:190-191)
                    contrib = resize_bilinear(layer(ys[j]),
                                              spatial.global_size(ys[i]),
                                              self.align_corners)
                else:
                    contrib = layer(ys[j])
                acc = contrib if acc is None else acc + contrib
            fused.append(torch.relu(acc))
        return fused


class Transition(nn.ModuleList):
    """Channel-adapt existing branches + spawn the new lower-res branch
    (reference: hrnetv2.py:317-351). ``None`` marks an identity slot."""

    def __init__(self, prev: Sequence[int], nxt: Sequence[int]):
        super().__init__()
        self.n_prev = len(prev)
        for i, c in enumerate(nxt):
            if i < len(prev):
                self.append(None if prev[i] == c
                            else _conv_bn(prev[i], c, 3))
            else:
                steps = []
                for j in range(i + 1 - len(prev)):
                    out = c if j == i - len(prev) else prev[-1]
                    steps.append(_conv_bn(prev[-1], out, 3, 2))
                self.append(nn.Sequential(*steps))

    def forward(self, xs):
        out = []
        for i, layer in enumerate(self):
            x = xs[i] if i < self.n_prev else xs[-1]
            out.append(x if layer is None else layer(x))
        return out


@contextlib.contextmanager
def _frozen_bn_stats(module: nn.Module):
    """Recompute context of a remat'd block: its train-mode BNs normalise
    with the batch statistics as in the forward pass but leave their
    running statistics as they are, so a recomputed block updates them
    once, as flax's ``nn.remat`` does. A momentum of 0 keeps the same
    kernel (and so the same tensors saved for backward) and writes back
    ``1 * running + 0 * batch``, the old value exactly;
    ``num_batches_tracked`` is restored."""
    bns = [m for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [(bn.momentum, bn.num_batches_tracked.clone()) for bn in bns]
    for bn in bns:
        bn.momentum = 0.0
    try:
        yield
    finally:
        for bn, (momentum, tracked) in zip(bns, saved):
            bn.momentum = momentum
            bn.num_batches_tracked.copy_(tracked)


def remat_call(module: nn.Module, *inputs):
    """``module(*inputs)`` with its activations recomputed in the backward
    pass (non-reentrant ``torch.utils.checkpoint``), BN running statistics
    updated once. The block runs under the span ``remat.block``, in the
    forward and again where the backward recomputes it."""
    def block(*xs):
        with span("remat.block"):
            return module(*xs)

    return checkpoint(
        block, *inputs, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            _frozen_bn_stats(module)))


def remat_stages(remat) -> tuple:
    """``model.remat`` -> the stage numbers to remat: ``True`` is every
    stage (1-4), a sequence only those stages, ``False`` none."""
    if isinstance(remat, (tuple, list)):
        return tuple(int(s) for s in remat)
    return (1, 2, 3, 4) if remat else ()


class HRNetV2(nn.Module):
    """Full trunk over an NCHW image. Returns ``(None, None, features)``,
    the reference trunk triple (network/hrnetv2.py:399-449). The input is
    cast to ``dtype`` (the compute dtype) and channels_last memory.
    ``remat`` (see :func:`remat_stages`) acts only in training with
    autograd on."""

    def __init__(self, spec: HRNetSpec = W48_SPEC,
                 align_corners: bool = False, dtype=torch.bfloat16,
                 fused_stage1: bool = False, remat=False):
        super().__init__()
        self.spec = spec
        self.align_corners = align_corners
        self.dtype = dtype
        self.remat = remat_stages(remat)
        # stem (reference: hrnetv2.py:270-276)
        self.conv1 = _tconv(3, 64, 3, 2)
        self.bn1 = Norm(64)
        self.conv2 = _tconv(64, 64, 3, 2)
        self.bn2 = Norm(64)
        # stage 1 (reference: hrnetv2.py:278-283)
        s = spec
        stage1_out = s.stage1_channels * Bottleneck.expansion
        self.layer1 = nn.Sequential(*(
            Bottleneck(64 if b == 0 else stage1_out, s.stage1_channels,
                       downsample=b == 0, fused_kernel=fused_stage1)
            for b in range(s.stage1_blocks)))
        prev = (stage1_out,)
        for t, (mods, chans, blocks) in enumerate(
                ((s.stage2_modules, s.stage2_channels, s.stage2_blocks),
                 (s.stage3_modules, s.stage3_channels, s.stage3_blocks),
                 (s.stage4_modules, s.stage4_channels, s.stage4_blocks)),
                start=1):
            setattr(self, f"transition{t}", Transition(prev, tuple(chans)))
            setattr(self, f"stage{t + 1}", nn.Sequential(*(
                HRModule(tuple(chans), blocks, align_corners)
                for _ in range(mods))))
            prev = tuple(chans)

    @spanned("model.trunk")
    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        remat = (self.remat if self.training and torch.is_grad_enabled()
                 else ())
        for block in self.layer1:
            x = remat_call(block, x) if 1 in remat else block(x)
        xs = [x]
        for t in (1, 2, 3):
            xs = getattr(self, f"transition{t}")(xs)
            for hrm in getattr(self, f"stage{t + 1}"):
                xs = (remat_call(hrm, *xs) if t + 1 in remat
                      else hrm(*xs))
        # final 4-branch upsample-concat (reference: hrnetv2.py:438-447)
        size = spatial.global_size(xs[0])
        ups = [xs[0]] + [resize_bilinear(b, size, self.align_corners)
                         for b in xs[1:]]
        feats = torch.cat([u.to(self.dtype) for u in ups], dim=1)
        return None, None, feats
