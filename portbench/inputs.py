"""The benchmark's inputs, made from the run's seed: street-scene stand-ins
with labels, the seeded weights (``reference.common.seeded_state``), and
the program's configuration from a configuration file.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

# the Cityscapes colours of the 19 train classes
PALETTE = np.array([
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
    (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
    (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
    (0, 0, 230), (119, 11, 32)], dtype=np.int64)
IGNORE = 255


def scenes(n: int, hw, seed: int, device, ignore_share: float = 0.1,
           block: int = 128):
    """``n`` seeded scenes: ``block``-pixel squares of random classes, each
    pixel its class's colour plus uniform noise in [-24, 24]; a share
    ``ignore_share`` of the squares labelled ignore. Drawn on ``device``.
    Returns (uint8 NHWC images, uint8 NHW labels) as host arrays."""
    h, w = hw
    gen = torch.Generator(device=device).manual_seed(seed)
    pal = torch.as_tensor(PALETTE, device=device)
    gh, gw = math.ceil(h / block), math.ceil(w / block)
    images = np.empty((n, h, w, 3), np.uint8)
    labels = np.empty((n, h, w), np.uint8)
    for i in range(n):
        cls = torch.randint(0, len(PALETTE), (gh, gw), generator=gen,
                            device=device)
        ign = torch.rand((gh, gw), generator=gen, device=device) \
            < ignore_share
        up = lambda t: t.repeat_interleave(block, 0).repeat_interleave(
            block, 1)[:h, :w]
        cls_px = up(cls)
        noise = torch.randint(-24, 25, (h, w, 3), generator=gen,
                              device=device)
        images[i] = (pal[cls_px] + noise).clamp(0, 255).to(
            torch.uint8).cpu().numpy()
        labels[i] = torch.where(up(ign), IGNORE, cls_px).to(
            torch.uint8).cpu().numpy()
    return images, labels


def program_config(config: dict, kind: str):
    """The program's ``Config`` for a cell of ``kind`` (``eval`` or
    ``train``): the recipe and ``--set`` overrides the configuration file
    gives, read as the program's CLI reads them."""
    from tpuseg_torch.cli.main import load_config

    prog = config["program"][kind]
    recipe = Path(__file__).resolve().parents[1] / prog["recipe"]
    return load_config(str(recipe), list(prog.get("set", ())))

