"""Model registry: ``cfg.model.arch`` = "module.Factory" (reference:
network/__init__.py:45-54), resolved against this package's modules.

``model.remat`` with ``model.remat_stages`` remats only the listed trunk
stages, as ``tpuseg/models/__init__.py:20-26`` does.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from tpuseg_torch.models.layers import init_weights

# the archs, per module: every factory of tpuseg's
PORTED = {
    "ocrnet": ("HRNet", "HRNet_ASPP_OCR", "HRNet_Mscale",
               "HRNet_Mscale_Tiny"),
    "deepv3": ("DeepV3PlusSRNX50", "DeepV3PlusR50", "DeepV3PlusSRNX101",
               "DeepV3PlusW38", "DeepV3PlusW38I", "DeepV3PlusX71",
               "DeepV3PlusEffB4", "DeepWV3Plus", "DeepV3R50",
               "DeepV3PlusW38Tiny"),
    "mscale": ("DeepV3R50", "DeepV3W38", "DeepV3W38Fuse", "DeepV3W38Fuse2",
               "DeepV3X71", "DeepV3EffB4", "DeepV3EffB4Fuse", "DeeperW38",
               "DeeperX71", "DeeperEffB4", "Basic", "HRNet", "HRNet_ASP",
               "DeepV3W38Tiny"),
    "mscale2": ("DeepV3R50", "DeepV3W38", "HRNet"),
    "attnscale": ("DeepV3R50", "DeepV3R50B", "DeepV3W38", "DeepV3R50BP"),
    "basic": ("HRNet", "HRNet_ASP"),
    "deeper": ("DeeperW38", "DeeperX71"),
}


def band_geometry(cfg) -> tuple:
    """-> (the stride of ``cfg.model.arch``'s deepest feature map, the
    scales besides 1.0 and the two-scale pass that a train step runs it
    at), from the ``band_geometry`` of the arch's module, which reads its
    factory table: 32 on HRNetV2 (its lowest branch), 8 on the DeepLab
    trunks (output stride 8, ``trunks.get_trunk``). Builds nothing."""
    module_name, fn_name = cfg.model.arch.split(".")
    mod = importlib.import_module(f"tpuseg_torch.models.{module_name}")
    trunk, scales = mod.band_geometry(fn_name, cfg)
    return (32 if trunk.startswith("hrnetv2") else 8), scales


def get_model(cfg, seed: int = 0) -> torch.nn.Module:
    """Build ``cfg.model.arch`` on the CPU with a seeded fresh init
    (``torch.Generator(seed)``); move it with ``.to(device)``."""
    if cfg.model.remat and cfg.model.remat_stages:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, remat=tuple(cfg.model.remat_stages)))
    module_name, fn_name = cfg.model.arch.split(".")
    if fn_name not in PORTED.get(module_name, ()):
        archs = sorted(f"{m}.{f}" for m, fs in PORTED.items() for f in fs)
        raise ValueError(f"unknown model.arch={cfg.model.arch!r}; the archs "
                         f"are {archs}")
    mod = importlib.import_module(f"tpuseg_torch.models.{module_name}")
    model = getattr(mod, fn_name)(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model
