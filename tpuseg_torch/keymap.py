"""The key map between ``tpuseg``'s flax variable paths and the NVIDIA
reference's torch state-dict names, which are the port's own names.

A copy of ``tools/convert_torch_ckpt.py:41-352`` (the HRNet, OCR and
AttnHead maps, the trunk maps, ``deepv3_key_fn``, ``_strip_prefixes`` and
``_flatten``), so that the port reads no file outside its package, extended
with what that map does not name:

- ``aspp/`` of ``OCRNetASPP`` (``flax_to_torch_key``), through the same
  ASPP layout as DeepLabV3+ (reference AtrousSpatialPyramidPoolingModule,
  network/utils.py:162-218), and DPC's five branches (``a``..``e``, each
  ``Sequential(conv, BN, ReLU)``, network/utils.py:263-298);
- the ``DeepV3`` seg head, ``final/conv0|conv1|cls`` -> the reference's
  ``make_seg_head`` Sequential (network/utils.py:320-329: conv at ``.0``,
  BN ``.1``, conv ``.3``, BN ``.4``, classifier ``.6``), the same slots
  DeepLabV3+'s ``final`` uses;
- the attention-scale family (``mscale``, ``mscale2``, ``attnscale``,
  ``basic``, ``deeper``), which ``tools/convert_torch_ckpt.py`` does not
  map: a head map a model class (``HEADS``) over the same trunk, ASPP and
  AttnHead maps, named after the reference modules ``tpuseg``'s
  docstrings cite (``seg_key_fn``);
- the ``wrn38_tiny``, ``xception71_tiny`` and ``hrnetv2_tiny`` trunks (the
  full trunks' names).

Each function maps a flax module path (``/``-separated) to the torch module
prefix, or returns None for a path it does not name.
"""
from __future__ import annotations

import re

# ---------------------------------------------------------------------------
# HRNet-OCR (reference: network/hrnetv2.py, ocrnet.py, ocr_utils.py)
# ---------------------------------------------------------------------------


def _hrnet_torch_prefix(flax_path: str) -> str | None:
    """One flax HRNetV2 module path -> the torch module prefix (the HRNet
    upstream scheme the reference uses, network/hrnetv2.py)."""
    m = re.match(r"stem_conv(\d)$", flax_path)
    if m:
        return f"conv{m.group(1)}"
    m = re.match(r"stem_bn(\d)$", flax_path)
    if m:
        return f"bn{m.group(1)}"
    m = re.match(r"layer1_block(\d+)/(.+)$", flax_path)
    if m:
        b, rest = m.groups()
        return f"layer1.{b}." + _block_sub(rest)
    m = re.match(r"transition(\d)/t(\d+)_conv(\d*)$", flax_path)
    if m:
        t, i, j = m.groups()
        if j == "":
            return f"transition{t}.{i}.0"
        return f"transition{t}.{i}.{j}.0"
    m = re.match(r"transition(\d)/t(\d+)_bn(\d*)$", flax_path)
    if m:
        t, i, j = m.groups()
        if j == "":
            return f"transition{t}.{i}.1"
        return f"transition{t}.{i}.{j}.1"
    m = re.match(r"stage(\d)_m(\d+)/branch(\d+)_block(\d+)/(.+)$", flax_path)
    if m:
        s, mod, br, b, rest = m.groups()
        return f"stage{s}.{mod}.branches.{br}.{b}." + _block_sub(rest)
    m = re.match(r"stage(\d)_m(\d+)/fuse(\d+)_(\d+)_conv(\d*)$", flax_path)
    if m:
        s, mod, i, j, k = m.groups()
        base = f"stage{s}.{mod}.fuse_layers.{i}.{j}"
        # j > i: Sequential(conv, bn); j < i: nested Sequentials
        return f"{base}.0" if k == "" else f"{base}.{k}.0"
    m = re.match(r"stage(\d)_m(\d+)/fuse(\d+)_(\d+)_bn(\d*)$", flax_path)
    if m:
        s, mod, i, j, k = m.groups()
        base = f"stage{s}.{mod}.fuse_layers.{i}.{j}"
        return f"{base}.1" if k == "" else f"{base}.{k}.1"
    return None


def _block_sub(rest: str) -> str:
    """conv1 -> conv1, bn2 -> bn2, downsample_conv -> downsample.0,
    downsample_bn -> downsample.1."""
    if rest == "downsample_conv":
        return "downsample.0"
    if rest == "downsample_bn":
        return "downsample.1"
    return rest


def _ocr_torch_prefix(flax_path: str) -> str | None:
    """OCR block (OCR_block + SpatialOCR/ObjectAttention, ocrnet.py:42-91,
    ocr_utils.py)."""
    table = {
        "conv3x3_ocr/conv": "conv3x3_ocr.0",
        "conv3x3_ocr/norm": "conv3x3_ocr.1.0",
        "aux0/conv": "aux_head.0",
        "aux0/norm": "aux_head.1.0",
        "aux_cls": "aux_head.2",
        "cls": "cls_head",
        "ocr_distri/conv_bn/conv": "ocr_distri_head.conv_bn_dropout.0",
        "ocr_distri/conv_bn/norm": "ocr_distri_head.conv_bn_dropout.1.0",
    }
    if flax_path in table:
        return table[flax_path]
    m = re.match(r"ocr_distri/object_context/f_(pixel|object)(\d)/(conv|norm)$",
                 flax_path)
    if m:
        which, idx, kind = m.groups()
        seq = int(idx) * 2
        sub = f"{seq}" if kind == "conv" else f"{seq + 1}.0"
        return f"ocr_distri_head.object_context_block.f_{which}.{sub}"
    m = re.match(r"ocr_distri/object_context/f_(down|up)/(conv|norm)$",
                 flax_path)
    if m:
        which, kind = m.groups()
        sub = "0" if kind == "conv" else "1.0"
        return f"ocr_distri_head.object_context_block.f_{which}.{sub}"
    return None


def _attn_head_torch_prefix(flax_path: str) -> str | None:
    """AttnHead (make_attn_head's conv0/bn0/conv1/bn1/conv2,
    network/utils.py:343-367)."""
    table = {
        "conv0/conv": "conv0", "conv0/norm": "bn0",
        "conv1/conv": "conv1", "conv1/norm": "bn1",
        "cls": "conv2",
    }
    return table.get(flax_path)


def _aspp_torch_prefix(p: str) -> str | None:
    """ASPP (AtrousSpatialPyramidPoolingModule, network/utils.py:162-218:
    ``features`` ModuleList of Sequential(conv, BN, ReLU), ``img_conv``
    apart) or DPC (``a``..``e``, each Sequential(conv, BN, ReLU),
    network/utils.py:263-298)."""
    table = {"img_conv/conv": "img_conv.0", "img_conv/norm": "img_conv.1"}
    if p in table:
        return table[p]
    m = re.match(r"branch(\d)/(conv|norm)$", p)
    if m:
        i, kind = m.groups()
        return f"features.{i}.{'0' if kind == 'conv' else '1'}"
    m = re.match(r"([a-e])/(conv|norm)$", p)
    if m:
        branch, kind = m.groups()
        return f"{branch}.{'0' if kind == 'conv' else '1'}"
    return None


def flax_to_torch_key(flax_path: str) -> str | None:
    """Full-model map for the ``ocrnet`` archs (HRNet, HRNet_Mscale and
    HRNet_ASPP_OCR)."""
    for flax_pre, torch_pre, fn in (
            ("backbone/", "backbone.", _hrnet_torch_prefix),
            ("aspp/", "aspp.", _aspp_torch_prefix),
            ("ocr/", "ocr.", _ocr_torch_prefix),
            ("scale_attn/", "scale_attn.", _attn_head_torch_prefix)):
        if flax_path.startswith(flax_pre):
            sub = fn(flax_path[len(flax_pre):])
            return f"{torch_pre}{sub}" if sub else None
    return None


# ---------------------------------------------------------------------------
# trunks (reference pretrained loads: wider_resnet.py:399-435,
# hrnetv2.py:451-477, Resnet.py:44-50, SEresnext.py:44-67,
# xception.py:270-279)
# ---------------------------------------------------------------------------


def _wrn38_torch_prefix(p: str) -> str | None:
    """WRN38 -> wider_resnet38 keys (wider_resnet.py:290-361; BN lives in
    bnrelu Sequentials, index 0)."""
    if p == "mod1_conv1":
        return "mod1.conv1"
    m = re.match(r"mod(\d)_block(\d+)/(.+)$", p)
    if not m:
        return None
    mod, blk, rest = m.groups()
    base = f"mod{mod}.block{blk}"
    if rest == "bn1":
        return f"{base}.bn1.0"
    if rest == "proj_conv":
        return f"{base}.proj_conv"
    m = re.match(r"conv(\d)$", rest)
    if m:
        return f"{base}.convs.conv{m.group(1)}"
    m = re.match(r"bn([23])$", rest)
    if m:
        return f"{base}.convs.bn{m.group(1)}.0"
    return None


def _resnet_block_sub(rest: str) -> str | None:
    if rest == "downsample_conv":
        return "downsample.0"
    if rest == "downsample_bn":
        return "downsample.1"
    if re.match(r"(conv|bn)\d$", rest):
        return rest
    return None


def _resnet_torch_prefix(p: str) -> str | None:
    """ResNet -> torchvision keys (network/Resnet.py:94-194)."""
    if p in ("conv1", "bn1"):
        return p
    m = re.match(r"layer(\d)_block(\d+)/(.+)$", p)
    if not m:
        return None
    layer, blk, rest = m.groups()
    sub = _resnet_block_sub(rest)
    return f"layer{layer}.{blk}.{sub}" if sub else None


def _seresnext_torch_prefix(p: str) -> str | None:
    """SEResNeXt -> Cadene keys (network/SEresnext.py:170-360; stem under
    layer0, the SE convs under se_module)."""
    if p == "conv1":
        return "layer0.conv1"
    if p == "bn1":
        return "layer0.bn1"
    m = re.match(r"layer(\d)_block(\d+)/(.+)$", p)
    if not m:
        return None
    layer, blk, rest = m.groups()
    base = f"layer{layer}.{blk}"
    m = re.match(r"se/fc(\d)$", rest)
    if m:
        return f"{base}.se_module.fc{m.group(1)}"
    sub = _resnet_block_sub(rest)
    return f"{base}.{sub}" if sub else None


# whether each reference xception Block starts with a ReLU in its `rep`
# Sequential (start_with_relu, xception.py:120-135): block1/2 do not
_XCEPTION_NO_RELU_BLOCKS = {1, 2}


def _xception_torch_prefix(p: str) -> str | None:
    """Xception71 -> aligned_xception71 keys (network/xception.py:24-200).
    The ``rep`` Sequential packs [relu, SeparableConv2d, BatchNorm] triples,
    so its indices depend on start_with_relu."""
    if re.match(r"(conv|bn)[12]$", p):
        return p
    part = {"depthwise": "conv1", "bn": "bn", "pointwise": "pointwise"}
    m = re.match(r"conv([345])/(depthwise|bn|pointwise)$", p)
    if m:
        i, sub = m.groups()
        return f"conv{i}.{part[sub]}"
    m = re.match(r"bn([345])$", p)
    if m:
        return f"bn{m.group(1)}"
    m = re.match(r"block(\d+)/(.+)$", p)
    if not m:
        return None
    blk, rest = int(m.group(1)), m.group(2)
    base = f"block{blk}"
    if rest == "skip_conv":
        return f"{base}.skip"
    if rest == "skip_bn":
        return f"{base}.skipbn"
    swr = blk not in _XCEPTION_NO_RELU_BLOCKS
    m = re.match(r"sep(\d+)/(depthwise|bn|pointwise)$", rest)
    if m:
        k, sub = int(m.group(1)), m.group(2)
        return f"{base}.rep.{3 * k + (1 if swr else 0)}.{part[sub]}"
    m = re.match(r"sepbn(\d+)$", rest)
    if m:
        return f"{base}.rep.{3 * int(m.group(1)) + (2 if swr else 1)}"
    return None


def _efficientnet_torch_prefix(p: str) -> str | None:
    """EfficientNetB4 -> the timm/geffnet efficientnet_b4 layout
    (conv_stem/bn1/blocks.{s}.{b}.*)."""
    if p in ("conv_stem", "bn1"):
        return p
    m = re.match(r"blocks_(\d+)_(\d+)/(.+)$", p)
    if m:
        s, b, rest = m.groups()
        return f"blocks.{s}.{b}.{rest.replace('se/', 'se.')}"
    return None


TRUNK_KEY_FNS = {
    "wrn38": _wrn38_torch_prefix,
    "wrn38_tiny": _wrn38_torch_prefix,
    "resnet-50": _resnet_torch_prefix,
    "resnet-101": _resnet_torch_prefix,
    "seresnext-50": _seresnext_torch_prefix,
    "seresnext-101": _seresnext_torch_prefix,
    "xception71": _xception_torch_prefix,
    "xception71_tiny": _xception_torch_prefix,
    "efficientnet_b4": _efficientnet_torch_prefix,
    # the HRNet ImageNet checkpoint uses the seg model's keys without
    # 'backbone.' ('model.'/'last_layer' go in strip_prefixes)
    "hrnetv2": _hrnet_torch_prefix,
    "hrnetv2_tiny": _hrnet_torch_prefix,
}


def trunk_key_fn(trunk_name: str, flax_prefix: str = "backbone/"):
    """A map of the flax ``backbone/`` subtree onto a trunk-only ImageNet
    checkpoint; other paths (heads) map to None."""
    fn = TRUNK_KEY_FNS[trunk_name]

    def key_fn(flax_path: str) -> str | None:
        if flax_prefix and not flax_path.startswith(flax_prefix):
            return None
        return fn(flax_path[len(flax_prefix):])

    return key_fn


# the seg head's slots: make_seg_head (network/utils.py:320-329) puts its
# convs at .0, .3, .6 and its BNs at .1, .4; DeepLabV3+'s ``final``
# (deepv3.py:40-93) and the hard-coded attention stacks of mscale2.py and
# attnscale.py share that layout
_SEG_HEAD = {"conv0/conv": "0", "conv0/norm": "1", "conv1/conv": "3",
             "conv1/norm": "4", "cls": "6"}

# A head map: tpuseg's top-level flax module -> (the torch prefix, a map of
# the rest of the path, or None for a bare conv at that prefix).
_V3PLUS_HEAD = {
    "bot_fine": ("bot_fine", None), "bot_aspp": ("bot_aspp", None),
    "final1": ("final", {"conv": "0", "norm": "1"}.get),
    "final2": ("final", {"conv": "3", "norm": "4"}.get),
    "final_cls": ("final.6", None),
    "final": ("final", _SEG_HEAD.get),
}
# the Deeper decoder (network/deeper.py:36-91, mscale.py:363-433):
# ConvBnRelu's ``conv`` / ``bn`` (network/utils.py:144-159)
_CONV_BN_RELU = {"conv": "conv", "norm": "bn"}.get
_DEEPER_HEAD = {
    "convs2": ("convs2", None), "convs4": ("convs4", None),
    "conv_up1": ("conv_up1", None), "conv_up5": ("conv_up5", None),
    "conv_up2": ("conv_up2", _CONV_BN_RELU),
    "conv_up3": ("conv_up3", _CONV_BN_RELU),
}
_ASPP_HEAD = {"bot_aspp": ("bot_aspp", None), "final": ("final", _SEG_HEAD.get)}
_ATTN_HEAD = {"scale_attn": ("scale_attn", _attn_head_torch_prefix)}

# each model class's head map (its trunk and ``aspp/`` map apart)
HEADS = {
    "DeepV3Plus": _V3PLUS_HEAD,
    "DeepV3": _V3PLUS_HEAD,
    "MscaleV3Plus": {**_V3PLUS_HEAD, **_ATTN_HEAD},
    "MscaleDeeper": {**_DEEPER_HEAD, **_ATTN_HEAD},
    "MscaleBasic": {"cls_head": ("cls_head", _SEG_HEAD.get), **_ATTN_HEAD},
    "MscaleASPP": {**_ASPP_HEAD, **_ATTN_HEAD},
    # mscale2.py:193-202: the hard-coded Sequential
    "MscaleV3Plus2": {**_V3PLUS_HEAD,
                      "scale_attn": ("scale_attn", _SEG_HEAD.get)},
    "Basic2": {"cls_head": ("cls_head", _SEG_HEAD.get), **_ATTN_HEAD},
    # attnscale.py:84-93: the BN head as make_seg_head (PLAIN_SCALE_ATTN
    # below is the other head)
    "ASDV3P": {**_V3PLUS_HEAD, "scale_attn": ("scale_attn", _SEG_HEAD.get)},
    "ASDV3P_Paired": {**_V3PLUS_HEAD,
                      "scale_attn": ("scale_attn", _SEG_HEAD.get)},
    "Basic": {"seg_head": ("seg_head", _SEG_HEAD.get)},
    "ASPPModel": _ASPP_HEAD,
    "DeeperS8": _DEEPER_HEAD,
}
# attnscale's plain attention head: conv0 - relu - cls (attnscale.py:95-99)
PLAIN_SCALE_ATTN = {"scale_attn": ("scale_attn",
                                   {"conv0": "0", "cls": "2"}.get)}


def seg_key_fn(trunk: str, heads: dict):
    """Full-model map of a segmentation model: ``backbone/`` by the trunk's
    map, ``aspp/`` by ``_aspp_torch_prefix``, the heads by ``heads`` (a
    head map above). ResNet stems sit in get_resnet's positional
    ``layer0`` inside seg checkpoints (utils.py:58-63)."""
    trunk_fn = trunk_key_fn(trunk, flax_prefix="")

    def trunk_sub(p: str) -> str | None:
        sub = trunk_fn(p)
        if sub is None:
            return None
        if trunk.startswith("resnet"):
            if sub.startswith("conv1"):
                sub = "layer0.0" + sub[len("conv1"):]
            elif sub.startswith("bn1"):
                sub = "layer0.1" + sub[len("bn1"):]
        return sub

    def key_fn(flax_path: str) -> str | None:
        top, _, rest = flax_path.partition("/")
        if top == "backbone":
            sub = trunk_sub(rest)
            return f"backbone.{sub}" if sub else None
        if top == "aspp":
            sub = _aspp_torch_prefix(rest)
            return f"aspp.{sub}" if sub else None
        if top not in heads:
            return None
        prefix, sub_fn = heads[top]
        if sub_fn is None:
            return None if rest else prefix
        sub = sub_fn(rest)
        return f"{prefix}.{sub}" if sub else None

    return key_fn


def deepv3_key_fn(trunk: str):
    """Full-model map for the ``deepv3`` archs (network/deepv3.py)."""
    return seg_key_fn(trunk, _V3PLUS_HEAD)


# ---------------------------------------------------------------------------
# state-dict helpers
# ---------------------------------------------------------------------------


def strip_prefixes(state_dict: dict) -> dict:
    """The reference's own checkpoint cleanups: a leading DataParallel
    ``module.`` or ``model.``, and ``last_layer`` -> ``aux_head``
    (hrnetv2.py:467-469, wider_resnet.py:406-412). Prefixes go only at the
    key's start: a substring replace would corrupt SEResNeXt's
    ``se_module.``."""
    out = {}
    for k, v in state_dict.items():
        for pre in ("module.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k.replace("last_layer", "aux_head")] = v
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out
