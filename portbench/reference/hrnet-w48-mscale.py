"""Plain PyTorch reference of ``hrnet-w48-mscale``: HRNetV2 (arXiv:1908.07919)
under OCR (arXiv:1909.11065) with hierarchical multi-scale attention
(arXiv:2005.10821), in float32: the eval forward, the chained n-scale
fusion over the configuration's scales (high to low; a scale at or above 1
fuses at its own size after the accumulated prediction is brought there, a
lower one is premultiplied by its attention and brought up). Dropout acts
only in training and is absent.

Widths come from the configuration file (``model``: ``spec``,
``mid_channels``, ``key_channels``, ``attn_bot_ch``, ``num_classes``).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from portbench.reference.common import (
    F32,
    bn_relu,
    calibrate_bn,
    conv,
    norm,
    normalize,
    resize,
    resize_scale,
)

# the class-proxy batch norms keep unit statistics under calibration: their
# K inputs are averages over many pixels and nearly equal
KEEP_UNIT = (".f_object.", ".f_down.")


def _conv_bn(cin, cout, k, stride=1, relu=True):
    return nn.Sequential(conv(cin, cout, k, stride), norm(cout),
                         *([nn.ReLU()] if relu else []))


class BasicBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1, self.bn1 = conv(c, c, 3), norm(c)
        self.conv2, self.bn2 = conv(c, c, 3), norm(c)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + x)


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, downsample):
        super().__init__()
        out = 4 * planes
        self.conv1, self.bn1 = conv(cin, planes, 1), norm(planes)
        self.conv2, self.bn2 = conv(planes, planes, 3), norm(planes)
        self.conv3, self.bn3 = conv(planes, out, 1), norm(out)
        self.downsample = (_conv_bn(cin, out, 1, relu=False)
                           if downsample else None)

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        return torch.relu(self.bn3(self.conv3(y)) + res)


class HRModule(nn.Module):
    def __init__(self, chans, blocks):
        super().__init__()
        n = len(chans)
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(c) for _ in range(blocks)))
            for c in chans)
        self.fuse_layers = nn.ModuleList()
        for i in range(n):
            row = nn.ModuleList()
            for j in range(n):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append(_conv_bn(chans[j], chans[i], 1, relu=False))
                else:
                    row.append(nn.Sequential(*(
                        _conv_bn(chans[j],
                                 chans[i] if k == i - j - 1 else chans[j], 3,
                                 2, relu=k != i - j - 1)
                        for k in range(i - j))))
            self.fuse_layers.append(row)

    def forward(self, *xs):
        ys = [b(x) for b, x in zip(self.branches, xs)]
        out = []
        for i, row in enumerate(self.fuse_layers):
            acc = 0
            for j, layer in enumerate(row):
                if j == i:
                    acc = acc + ys[j]
                elif j > i:
                    acc = acc + resize(layer(ys[j]), ys[i].shape[-2:])
                else:
                    acc = acc + layer(ys[j])
            out.append(torch.relu(acc))
        return out


class Transition(nn.ModuleList):
    def __init__(self, prev, nxt):
        super().__init__()
        self.n_prev = len(prev)
        for i, c in enumerate(nxt):
            if i < len(prev):
                self.append(None if prev[i] == c else _conv_bn(prev[i], c, 3))
            else:
                self.append(nn.Sequential(*(
                    _conv_bn(prev[-1], c if j == i - len(prev) else prev[-1],
                             3, 2)
                    for j in range(i + 1 - len(prev)))))

    def forward(self, xs):
        return [(xs[i] if i < self.n_prev else xs[-1]) if layer is None
                else layer(xs[i] if i < self.n_prev else xs[-1])
                for i, layer in enumerate(self)]


class HRNetV2(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        self.conv1, self.bn1 = conv(3, 64, 3, 2), norm(64)
        self.conv2, self.bn2 = conv(64, 64, 3, 2), norm(64)
        c1 = s["stage1_channels"]
        self.layer1 = nn.Sequential(*(
            Bottleneck(64 if b == 0 else 4 * c1, c1, b == 0)
            for b in range(s["stage1_blocks"])))
        prev = (4 * c1,)
        for t in (1, 2, 3):
            chans = tuple(s[f"stage{t + 1}_channels"])
            setattr(self, f"transition{t}", Transition(prev, chans))
            setattr(self, f"stage{t + 1}", nn.Sequential(*(
                HRModule(chans, s[f"stage{t + 1}_blocks"])
                for _ in range(s[f"stage{t + 1}_modules"]))))
            prev = chans

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        for block in self.layer1:
            x = block(x)
        xs = [x]
        for t in (1, 2, 3):
            xs = getattr(self, f"transition{t}")(xs)
            for m in getattr(self, f"stage{t + 1}"):
                xs = m(*xs)
        size = xs[0].shape[-2:]
        return torch.cat([xs[0]] + [resize(b, size) for b in xs[1:]], 1)


def _flat(x):
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


class ObjectAttention(nn.Module):
    prec = F32

    def __init__(self, cin, kc):
        super().__init__()
        self.kc = kc
        self.f_pixel = nn.Sequential(conv(cin, kc, 1), bn_relu(kc),
                                     conv(kc, kc, 1), bn_relu(kc))
        self.f_object = nn.Sequential(conv(cin, kc, 1), bn_relu(kc),
                                      conv(kc, kc, 1), bn_relu(kc))
        self.f_down = nn.Sequential(conv(cin, kc, 1), bn_relu(kc))
        self.f_up = nn.Sequential(conv(kc, cin, 1), bn_relu(cin))

    def forward(self, x, proxy):
        b, _, h, w = x.shape
        img = proxy.permute(0, 2, 1)[..., None]
        q = self.prec.q(_flat(self.f_pixel(x)))
        key = self.prec.q(_flat(self.f_object(img)))
        val = self.prec.q(_flat(self.f_down(img)))
        attn = torch.softmax(q @ key.transpose(1, 2) * self.kc ** -0.5, -1)
        ctx = self.prec.q(attn) @ val
        return self.f_up(ctx.reshape(b, h, w, self.kc).permute(0, 3, 1, 2))


class SpatialOCR(nn.Module):
    def __init__(self, mid, kc):
        super().__init__()
        self.object_context_block = ObjectAttention(mid, kc)
        self.conv_bn_dropout = nn.Sequential(conv(2 * mid, mid, 1),
                                             bn_relu(mid))

    def forward(self, feats, proxy):
        ctx = self.object_context_block(feats, proxy)
        return self.conv_bn_dropout(torch.cat([ctx, feats], 1))


class OCRBlock(nn.Module):
    prec = F32

    def __init__(self, high, k, mid, kc):
        super().__init__()
        self.conv3x3_ocr = nn.Sequential(conv(high, mid, 3, bias=True),
                                         bn_relu(mid))
        self.ocr_distri_head = SpatialOCR(mid, kc)
        self.cls_head = conv(mid, k, 1, bias=True)
        self.aux_head = nn.Sequential(conv(high, high, 1, bias=True),
                                      bn_relu(high),
                                      conv(high, k, 1, bias=True))

    def forward(self, high):
        feats = self.conv3x3_ocr(high)
        aux = self.aux_head(high)
        b, k = aux.shape[:2]
        p = torch.softmax(aux.reshape(b, k, -1), -1)
        proxy = self.prec.q(p) @ self.prec.q(_flat(feats))
        mid = self.ocr_distri_head(feats, proxy)
        return self.cls_head(mid), aux, mid


class AttnHead(nn.Module):
    def __init__(self, cin, bot):
        super().__init__()
        self.conv0, self.bn0 = conv(cin, bot, 3), norm(bot)
        self.conv1, self.bn1 = conv(bot, bot, 3), norm(bot)
        self.conv2 = conv(bot, 1, 1)

    def forward(self, x):
        x = torch.relu(self.bn0(self.conv0(x)))
        x = torch.relu(self.bn1(self.conv1(x)))
        return torch.sigmoid(self.conv2(x))


class MscaleOCR(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        spec = m["spec"]
        high = sum(spec["stage4_channels"])
        self.backbone = HRNetV2(spec)
        self.ocr = OCRBlock(high, m["num_classes"], m["mid_channels"],
                            m["key_channels"])
        self.scale_attn = AttnHead(m["mid_channels"], m["attn_bot_ch"])
        self.n_scales = tuple(m["n_scales"])

    def single(self, x):
        """One scale's class logits and attention at its input's size."""
        cls, _, mid = self.ocr(self.backbone(x))
        size = x.shape[-2:]
        return resize(cls, size), resize(self.scale_attn(mid), size)

    def forward(self, x):
        pred = None
        for s in sorted(self.n_scales, reverse=True):
            xi = resize_scale(x, s) if s != 1.0 else x
            cls, attn = self.single(xi)
            if pred is None:
                pred = cls
            elif s >= 1.0:
                pred = resize(pred, cls.shape[-2:])
                pred = attn * cls + (1 - attn) * pred
            else:
                up = resize(attn * cls, pred.shape[-2:])
                pred = up + (1 - resize(attn, pred.shape[-2:])) * pred
        return {"pred": pred}


def build(m: dict) -> MscaleOCR:
    return MscaleOCR(m)


def tails(model: MscaleOCR) -> set:
    """The last batch norm of every residual branch and cross-resolution
    fuse path: BasicBlock's bn2, Bottleneck's bn3, a fuse path's last
    conv-BN."""
    out = set()
    for n, mod in model.named_modules():
        bn = None
        if isinstance(mod, BasicBlock):
            bn = f"{n}.bn2"
        elif isinstance(mod, Bottleneck):
            bn = f"{n}.bn3"
        elif isinstance(mod, HRModule):
            for i, row in enumerate(mod.fuse_layers):
                for j, layer in enumerate(row):
                    if j > i:
                        out |= {f"{n}.fuse_layers.{i}.{j}.1.{w}"
                                for w in ("weight", "bias")}
                    elif j < i:
                        out |= {f"{n}.fuse_layers.{i}.{j}.{i - j - 1}.1.{w}"
                                for w in ("weight", "bias")}
        if bn:
            out |= {f"{bn}.weight", f"{bn}.bias"}
    return out


def eval_logits(model, image_u8, m: dict) -> torch.Tensor:
    """uint8 NHWC images -> the eval forward's (B, C, H, W) logits."""
    return model(normalize(image_u8, m["mean"], m["std"]))["pred"]


def calibrate(model, image_u8, m: dict) -> dict:
    """Running statistics from one scene at each eval scale."""
    x = normalize(image_u8, m["mean"], m["std"])

    def run():
        for s in m["n_scales"]:
            model.single(resize_scale(x, s) if s != 1.0 else x)

    return calibrate_bn(model, run, KEEP_UNIT)
