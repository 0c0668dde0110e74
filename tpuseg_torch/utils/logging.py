"""Rank-aware logging + metric streams.

The port's copy of ``tpuseg/utils/logging.py``: messages to stdout + file,
scalar metric streams to JSONL (machine-readable). Only the primary process
writes. ``tpuseg``'s optional TensorBoard writer comes from ``flax``, which
the port never imports, and the card's machine has no ``tensorboard``
package: ``tensorboard=True`` raises, and :meth:`Logger.image` is the
no-op that ``tpuseg``'s is without a writer.
"""
from __future__ import annotations

import json
import os
import time
from typing import Mapping, Optional


class Logger:
    def __init__(self, logdir: Optional[str] = None, is_primary: bool = True,
                 tensorboard: bool = False):
        self.logdir = logdir
        self.is_primary = is_primary
        if tensorboard:
            raise NotImplementedError(
                "TensorBoard logging is not ported to tpuseg_torch yet")
        self._metrics_f = None
        self._log_f = None
        if logdir and is_primary:
            os.makedirs(logdir, exist_ok=True)
            self._metrics_f = open(os.path.join(logdir, "metrics.jsonl"), "a")
            self._log_f = open(os.path.join(logdir, "log.txt"), "a")

    def msg(self, message: str):
        if not self.is_primary:
            return
        line = f"[{time.strftime('%H:%M:%S')}] {message}"
        print(line, flush=True)
        if self._log_f:
            self._log_f.write(line + "\n")
            self._log_f.flush()

    def metric(self, phase: str, metrics: Mapping[str, float], step: int):
        """(reference: logx.metric, train.py:525-528)"""
        if not self.is_primary:
            return
        if self._metrics_f:
            self._metrics_f.write(json.dumps(
                {"phase": phase, "step": int(step),
                 **{k: float(v) for k, v in metrics.items()}}) + "\n")
            self._metrics_f.flush()

    def image(self, tag: str, img, step: int):
        """HWC float [0,1] image to TensorBoard (reference: logx.add_image
        via ImageDumper.write_summaries, utils/misc.py:388-417). A no-op:
        the port has no TensorBoard writer."""
