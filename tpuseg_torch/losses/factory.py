"""Loss factory, eval side (port of ``tpuseg/losses/factory.py:53``): the
val criterion is always plain CE, as in the reference (loss/utils.py:40-67).
The training criteria (RMI, image-weighted CE, relaxed) wait for the
training slice (ROADMAP Queue 1 item 8)."""
from __future__ import annotations

from functools import partial

from tpuseg_torch.losses.ce import cross_entropy


def get_val_loss(cfg):
    return partial(cross_entropy, ignore_label=cfg.dataset.ignore_label)
