"""Plain PyTorch reference of ``deepv3plus-effb4``: DeepLabV3+
(arXiv:1802.02611) on an EfficientNet-B4 trunk (arXiv:1905.11946) at output
stride 8, in float32, with the recipe's loss: cross entropy over the
labelled pixels.

Trunk, as the paper gives it: a 3x3 stride-2 stem, then the B0 stage table
(expansion, width, repeats, stride, kernel) with every width scaled by
``width_mult`` and rounded to a multiple of 8, never more than 10 % down
(Sec. 3.3), and every stage's repeats by ``depth_mult``, rounded up. Each
block is an MBConv: a 1x1 expansion (none where the expansion is 1), a
k x k depthwise conv, squeeze-and-excitation whose bottleneck is
``se_ratio`` of the block's *input* width (a global mean, a 1x1 conv with
bias, SiLU, a 1x1 conv with bias, a sigmoid gate), a 1x1 projection, batch
norm (eps ``bn_eps``) after each conv, SiLU after the first two. A block of
stride 1 whose input and output widths agree adds its input back, its
branch first dropped per sample (stochastic depth) at ``drop_path_rate *
i / n`` for the i-th of the n blocks, counted from 0.

The drop path's masks are drawn as the program draws them: one (N, 1, 1, 1)
Bernoulli draw of the keep probability a residual block, on the device's
default generator, in the forward's order, and kept samples scaled by
1 / keep; so the same seed gives both the same masks. A block recomputed in
the backward (``set_remat``) restores the generator's state first
(``torch.utils.checkpoint``), so its masks are the forward's.

Head: ASPP (image pool + 1x1 + 3x3 at rates 12 / 24 / 36) over the last
stage's map, a 1x1 to 256 brought to the stride-2 tap (the first stage's
output, ``s2_ch`` wide), concatenated with the tap's 1x1 to 48, two 3x3
convs and the classifier, brought to the input's size: the model of
``deepv3plus-w38.py`` above the trunk, copied.

Departures from the paper, each the DeepLabV3+ recipe's or the program's:

- output stride 8: a stage whose stride would take the map past stride 8
  runs stride 1 and doubles the dilation of every depthwise conv from
  there on (the stride-16 stage and the one after it at dilation 2, the
  stride-32 stage and the one after it at 4), each padded to keep its size;
- no head of the classifier (1x1 to 1280, pooling, dropout, fully
  connected layer): the trunk ends at the last stage;
- batch-norm momentum 0.1 in PyTorch's convention (the paper's 0.99 in
  TensorFlow's is 0.01), as the program has it.

State-dict names are timm's under ``backbone.``: ``conv_stem``, ``bn1``,
``blocks.<stage>.<block>.{conv_pw, bn1, conv_dw, bn2, se.conv_reduce,
se.conv_expand, conv_pwl, bn3}`` (a block without expansion: ``conv_dw``,
``bn1``, ``se``, ``conv_pw``, ``bn2``); then ``aspp``, ``bot_fine``,
``bot_aspp`` and ``final``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.common import (
    Conv,
    calibrate_bn,
    conv,
    cross_entropy,
    norm,
    normalize,
    recompute,
    resize,
)

KEEP_UNIT = (".img_conv.",)


def round_filters(c: int, width_mult: float, divisor: int = 8) -> int:
    """A width times ``width_mult`` to the nearest multiple of ``divisor``,
    raised by one step where that loses more than a tenth."""
    c = c * width_mult
    out = max(divisor, int(c + divisor / 2) // divisor * divisor)
    return int(out + divisor if out < 0.9 * c else out)


def round_repeats(n: int, depth_mult: float) -> int:
    return int(math.ceil(n * depth_mult))


def drop_path(x: torch.Tensor, rate: float) -> torch.Tensor:
    keep = 1.0 - rate
    mask = torch.empty((x.shape[0], 1, 1, 1), device=x.device,
                       dtype=torch.float32).bernoulli_(keep)
    return x * mask / keep


def bn(c: int, eps: float) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=eps, momentum=0.1)


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, se_ch: int):
        super().__init__()
        self.conv_reduce = conv(c, se_ch, 1, bias=True)
        self.conv_expand = conv(se_ch, c, 1, bias=True)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    def __init__(self, cin, cout, expand, k, stride, dil, se_ratio, eps,
                 drop):
        super().__init__()
        mid = cin * expand
        self.expand = expand
        self.drop = drop
        self.residual = stride == 1 and cin == cout
        dw = Conv(mid, mid, k, stride=stride, padding=(k - 1) // 2 * dil,
                  dilation=dil, groups=mid, bias=False)
        se = SqueezeExcite(mid, max(1, int(cin * se_ratio)))
        if expand != 1:
            self.conv_pw = conv(cin, mid, 1)
            self.bn1 = bn(mid, eps)
            self.conv_dw = dw
            self.bn2 = bn(mid, eps)
            self.se = se
            self.conv_pwl = conv(mid, cout, 1)
            self.bn3 = bn(cout, eps)
        else:
            self.conv_dw = dw
            self.bn1 = bn(mid, eps)
            self.se = se
            self.conv_pw = conv(mid, cout, 1)
            self.bn2 = bn(cout, eps)

    def forward(self, x):
        if self.expand != 1:
            y = F.silu(self.bn1(self.conv_pw(x)))
            y = F.silu(self.bn2(self.conv_dw(y)))
            y = self.bn3(self.conv_pwl(self.se(y)))
        else:
            y = F.silu(self.bn1(self.conv_dw(x)))
            y = self.bn2(self.conv_pw(self.se(y)))
        if not self.residual:
            return y
        if self.training and self.drop > 0:
            y = drop_path(y, self.drop)
        return y + x


class EfficientNet(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        wm, dm, eps = m["width_mult"], m["depth_mult"], m["bn_eps"]
        stem = round_filters(m["stem_ch"], wm)
        self.conv_stem = conv(3, stem, 3, 2)
        self.bn1 = bn(stem, eps)
        table = m["stages"]
        repeats = [round_repeats(r, dm) for _, _, r, _, _ in table]
        n, i = sum(repeats), 0
        stride_now, dil = 2, 1
        cin = stem
        stages = []
        for (expand, c, _, stride, k), reps in zip(table, repeats):
            cout = round_filters(c, wm)
            if stride == 2 and stride_now >= m["output_stride"]:
                stride, dil = 1, dil * 2
            blocks = []
            for b in range(reps):
                blocks.append(MBConv(cin, cout, expand, k,
                                     stride if b == 0 else 1, dil,
                                     m["se_ratio"], eps,
                                     m["drop_path_rate"] * i / n))
                cin = cout
                i += 1
            stride_now *= stride
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.widths = (round_filters(table[0][1], wm), cin)
        self.remat = False

    def forward(self, x):
        x = F.silu(self.bn1(self.conv_stem(x)))
        taps = []
        for stage in self.blocks:
            for blk in stage:
                x = recompute(blk, x, on=self.remat)
            taps.append(x)
        return taps[0], x


class ASPP(nn.Module):
    def __init__(self, cin, r=256, rates=(12, 24, 36)):
        super().__init__()
        self.img_conv = nn.Sequential(conv(cin, r, 1), norm(r), nn.ReLU())
        self.features = nn.ModuleList(
            [nn.Sequential(conv(cin, r, 1), norm(r), nn.ReLU())]
            + [nn.Sequential(conv(cin, r, 3, dilation=d), norm(r), nn.ReLU())
               for d in rates])

    def forward(self, x):
        img = self.img_conv(x.mean((2, 3), keepdim=True))
        img = img.expand(-1, -1, *x.shape[-2:])
        return torch.cat([img] + [f(x) for f in self.features], 1)


class DeepV3Plus(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        self.backbone = EfficientNet(m)
        if self.backbone.widths != (m["s2_ch"], m["high_ch"]):
            raise ValueError(f"the stage table gives widths "
                             f"{self.backbone.widths}, the configuration "
                             f"{(m['s2_ch'], m['high_ch'])}")
        self.aspp = ASPP(m["high_ch"])
        self.bot_fine = conv(m["s2_ch"], 48, 1)
        self.bot_aspp = conv(5 * 256, 256, 1)
        k = m["num_classes"]
        self.final = nn.Sequential(conv(304, 256, 3), norm(256), nn.ReLU(),
                                   conv(256, 256, 3), norm(256), nn.ReLU(),
                                   conv(256, k, 1))

    def set_remat(self, on: bool):
        self.backbone.remat = on
        return self

    def forward(self, x):
        s2, high = self.backbone(x)
        a = resize(self.bot_aspp(self.aspp(high)), s2.shape[-2:])
        y = self.final(torch.cat([self.bot_fine(s2), a], 1))
        return {"pred": resize(y, x.shape[-2:])}


def build(m: dict) -> DeepV3Plus:
    return DeepV3Plus(m)


def tails(model: DeepV3Plus) -> set:
    """The last batch norm of every residual MBConv, the one after its
    projection (``bn3``; ``bn2`` without expansion): its scale and shift.
    (Scaling the projection conv instead would change nothing that the
    batch norm after it puts out.)"""
    out = set()
    for n, mod in model.named_modules():
        if isinstance(mod, MBConv) and mod.residual:
            last = "bn3" if mod.expand != 1 else "bn2"
            out |= {f"{n}.{last}.weight", f"{n}.{last}.bias"}
    return out


def eval_logits(model, image_u8, m: dict) -> torch.Tensor:
    return model(normalize(image_u8, m["mean"], m["std"]))["pred"]


def train_loss(model, image_u8, labels, m: dict) -> torch.Tensor:
    out = model(normalize(image_u8, m["mean"], m["std"]))
    return cross_entropy(out["pred"], labels.long())


def calibrate(model, image_u8, m: dict) -> dict:
    x = normalize(image_u8, m["mean"], m["std"])
    return calibrate_bn(model, lambda: model(x), KEEP_UNIT)
