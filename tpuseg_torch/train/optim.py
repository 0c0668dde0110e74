"""Optimizers and LR schedules (port of ``tpuseg/train/optim.py``;
reference: loss/optimizer.py:43-98).

The reference steps its LambdaLR once per epoch; the schedules here are
functions of the global step that quantise to the epoch
(``epoch = step // steps_per_epoch``). The train step sets each step's LR
from ``schedule(step)`` before ``optimizer.step()``, with ``step`` the
number of steps already taken: optax's ``scale_by_learning_rate`` reads the
schedule at its count before the increment, the same value.

- SGD: ``torch.optim.SGD(momentum, weight_decay, nesterov=False)`` over
  every parameter, BN affine included: ``grad += wd * param``, then
  ``buf = momentum * buf + grad``, ``param -= lr * buf``, which is optax's
  ``add_decayed_weights -> trace -> scale_by_learning_rate``.
- Adam: ``torch.optim.Adam(weight_decay=...)``, L2 added to the gradient
  before the moments, as ``add_decayed_weights -> scale_by_adam``.
- RAdam: decoupled decay after the rectified direction (reference
  radam.py:94-97), ``torch.optim.RAdam(decoupled_weight_decay=True)``, as
  ``scale_by_radam -> add_decayed_weights``.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch


def poly_schedule(base_lr: float, max_epoch: int, poly_exp: float,
                  steps_per_epoch: int) -> Callable[[int], float]:
    """lr = base * (1 - epoch/max_epoch)^poly_exp (reference poly_schd:
    loss/optimizer.py:67-68)."""
    def fn(step):
        epoch = step // steps_per_epoch
        return base_lr * (1.0 - epoch / max_epoch) ** poly_exp
    return fn


def poly2_schedule(base_lr: float, max_epoch: int, poly_exp: float,
                   poly_step: int, steps_per_epoch: int):
    """The exponent doubles after ``poly_step`` epochs (reference
    poly2_schd: loss/optimizer.py:70-75)."""
    def fn(step):
        epoch = step // steps_per_epoch
        exp = poly_exp if epoch < poly_step else 2.0 * poly_exp
        return base_lr * (1.0 - epoch / max_epoch) ** exp
    return fn


def scl_poly_schedule(base_lr: float, max_epoch: int, poly_exp: float,
                      rescale_thresh: int, scale_value: float, repoly: float,
                      steps_per_epoch: int):
    """Warm-restart poly tied to REDUCE_BORDER_EPOCH (reference:
    loss/optimizer.py:77-87)."""
    def fn(step):
        epoch = step // steps_per_epoch
        if epoch < rescale_thresh:
            return base_lr * max(1.0 - epoch / max_epoch, 0.0) ** poly_exp
        frac = (epoch - rescale_thresh) / (max_epoch - rescale_thresh)
        return base_lr * scale_value * max(1.0 - frac, 0.0) ** repoly
    return fn


def make_schedule(cfg, steps_per_epoch: int):
    oc = cfg.optim
    if oc.lr_schedule == "poly":
        return poly_schedule(oc.lr, cfg.train.max_epoch, oc.poly_exp,
                             steps_per_epoch)
    if oc.lr_schedule == "poly2":
        return poly2_schedule(oc.lr, cfg.train.max_epoch, oc.poly_exp,
                              oc.poly_step, steps_per_epoch)
    if oc.lr_schedule == "scl-poly":
        if cfg.loss.reduce_border_epoch == -1:
            raise ValueError("scl-poly requires loss.reduce_border_epoch")
        return scl_poly_schedule(oc.lr, cfg.train.max_epoch, oc.poly_exp,
                                 cfg.loss.reduce_border_epoch, oc.rescale_lr,
                                 oc.repoly, steps_per_epoch)
    raise ValueError(f"unknown lr schedule {oc.lr_schedule}")


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int = 1):
    """-> (torch optimizer over ``params``, schedule). The optimizer's LR
    starts at ``schedule(0)``; :func:`set_lr` moves it."""
    oc = cfg.optim
    schedule = make_schedule(cfg, steps_per_epoch)
    lr = schedule(0)
    if oc.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=oc.momentum,
                              weight_decay=oc.weight_decay, nesterov=False)
    elif oc.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, weight_decay=oc.weight_decay)
    elif oc.optimizer == "radam":
        opt = torch.optim.RAdam(params, lr=lr, weight_decay=oc.weight_decay,
                                decoupled_weight_decay=True)
    else:
        raise ValueError(f"unknown optimizer {oc.optimizer}")
    return opt, schedule


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
