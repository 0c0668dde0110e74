"""Loss factory (port of ``tpuseg/losses/factory.py:19-54``; reference
get_loss: loss/utils.py:40-67).

``criterion(logits, labels, do_rmi=...)`` callables over NHWC logits and NHW
labels (``relaxed``: (B, H, W, C+1) multi-hot targets); ``do_rmi`` lets
the aux loss skip the RMI term (reference: ocrnet.py:300-308). The train
criterion is the global batch's loss under data parallelism
(``data_parallel``, ``losses/ce.py``); the val criterion is always plain CE
on the rank's own images, as in the reference.
"""
from __future__ import annotations

from functools import partial

from tpuseg_torch.losses.ce import cross_entropy, image_weighted_cross_entropy
from tpuseg_torch.losses.relaxed import relaxed_soft_nll
from tpuseg_torch.losses.rmi import rmi_loss


def get_loss(cfg):
    """-> (train criterion, val criterion)."""
    lc = cfg.loss
    ignore = cfg.dataset.ignore_label
    n = cfg.dataset.num_classes

    if lc.loss_type == "rmi":
        def criterion(logits, labels, do_rmi=True):
            return rmi_loss(logits, labels, num_classes=n,
                            ignore_label=ignore, radius=lc.rmi_radius,
                            pool_size=lc.rmi_pool_size, do_rmi=do_rmi,
                            data_parallel=True)
    elif lc.loss_type == "img_wt":
        def criterion(logits, labels, do_rmi=None):
            return image_weighted_cross_entropy(
                logits, labels, ignore_label=ignore,
                upper_bound=lc.img_wt_bound,
                batch_weighting=lc.batch_weighting, data_parallel=True)
    elif lc.loss_type == "ce":
        def criterion(logits, labels, do_rmi=None):
            return cross_entropy(logits, labels, ignore_label=ignore,
                                 data_parallel=True)
    elif lc.loss_type == "relaxed":
        # over the (B, H, W, C+1) multi-hot targets of
        # dataset.jointwtborder; the train loop sets invert_border past
        # loss.reduce_border_epoch
        def criterion(logits, relaxed_target, do_rmi=None,
                      invert_border=False):
            return relaxed_soft_nll(
                logits, relaxed_target, upper_bound=lc.img_wt_bound,
                batch_weighting=lc.batch_weighting,
                invert_border=invert_border, data_parallel=True)
    else:
        raise ValueError(f"unknown loss_type {lc.loss_type}")

    return criterion, get_val_loss(cfg)


def get_val_loss(cfg):
    """The val criterion alone: CE with the dataset's ignore label."""
    return partial(cross_entropy, ignore_label=cfg.dataset.ignore_label)
