"""Plain PyTorch reference of ``deepv3plus-w38``: DeepLabV3+ (arXiv:1802.02611)
on the dilated WideResNet-38-A2 trunk (arXiv:1611.10080) at output stride
8, in float32, with the recipe's loss: cross entropy over the labelled
pixels.

Trunk: a 3x3 stem, max pools before mod2 and mod3, pre-activation
residual blocks (mod2-mod5 two 3x3 convs, mod6-mod7 1x1-3x3-1x1), a
stride-2 first block in mod4, dilation 2 in mod5 and 4 in mod6-mod7. Head:
ASPP (image pool + 1x1 + 3x3 at rates 12 / 24 / 36), a 1x1 to 256 brought
to the stride-2 tap, concatenated with the tap's 1x1 to 48, two 3x3 convs
and the classifier, brought to the input's size.

Widths come from the configuration file (``model``: ``structure``,
``channels``, ``stem_ch``, ``s2_ch``, ``num_classes``), and so does
``dropout``, each module's channel dropout before its last conv (0.3 in
mod6, 0.5 in mod7). Its masks are drawn on the device's default generator
as the program draws them, one (N, C, 1, 1) Bernoulli draw a block in the
forward's order, so that the same seed gives both the same masks.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.common import (
    bn_relu,
    calibrate_bn,
    conv,
    cross_entropy,
    norm,
    normalize,
    recompute,
    resize,
)

KEEP_UNIT = (".img_conv.",)


class Block(nn.Module):
    def __init__(self, cin, c, stride, dil, drop=0.0):
        super().__init__()
        self.bn1 = bn_relu(cin)
        self.proj_conv = (conv(cin, c[-1], 1, stride)
                          if stride != 1 or cin != c[-1] else None)
        d = [("dropout", nn.Dropout2d(drop))] if drop else []
        if len(c) == 2:
            layers = [("conv1", conv(cin, c[0], 3, stride, dilation=dil)),
                      ("bn2", bn_relu(c[0])), *d,
                      ("conv2", conv(c[0], c[1], 3, dilation=dil))]
        else:
            layers = [("conv1", conv(cin, c[0], 1, stride)),
                      ("bn2", bn_relu(c[0])),
                      ("conv2", conv(c[0], c[1], 3, dilation=dil)),
                      ("bn3", bn_relu(c[1])), *d,
                      ("conv3", conv(c[1], c[2], 1))]
        self.convs = nn.Sequential(OrderedDict(layers))

    def forward(self, x):
        a = self.bn1(x)
        short = x if self.proj_conv is None else self.proj_conv(a)
        return self.convs(a) + short


class WRN38(nn.Module):
    def __init__(self, structure, channels, stem_ch, dropout):
        super().__init__()
        self.mod1 = nn.Sequential(OrderedDict(conv1=conv(3, stem_ch, 3)))
        cin = stem_ch
        for i, n in enumerate(structure):
            dil = 2 if i == 3 else (4 if i > 3 else 1)
            blocks = []
            for b in range(n):
                blocks.append((f"block{b + 1}", Block(
                    cin, channels[i], 2 if b == 0 and i == 2 else 1, dil,
                    dropout[i])))
                cin = channels[i][-1]
            setattr(self, f"mod{i + 2}", nn.Sequential(OrderedDict(blocks)))
        self.n = len(structure)
        self.remat = False

    def forward(self, x):
        x = self.mod1(x)
        taps = []
        for i in range(self.n):
            if i < 2:
                x = F.max_pool2d(x, 3, 2, 1)
            for blk in getattr(self, f"mod{i + 2}"):
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
        ch = m["channels"]
        self.backbone = WRN38(m["structure"], ch, m["stem_ch"],
                              m["dropout"])
        self.aspp = ASPP(ch[-1][-1])
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
    """The last conv of every pre-activation residual branch."""
    return {f"{n}.convs.{list(mod.convs._modules)[-1]}.weight"
            for n, mod in model.named_modules() if isinstance(mod, Block)}


def eval_logits(model, image_u8, m: dict) -> torch.Tensor:
    return model(normalize(image_u8, m["mean"], m["std"]))["pred"]


def train_loss(model, image_u8, labels, m: dict) -> torch.Tensor:
    out = model(normalize(image_u8, m["mean"], m["std"]))
    return cross_entropy(out["pred"], labels.long())


def calibrate(model, image_u8, m: dict) -> dict:
    x = normalize(image_u8, m["mean"], m["std"])
    return calibrate_bn(model, lambda: model(x), KEEP_UNIT)
