"""CLI: ``python -m tpuseg_torch.cli eval --config <recipe> --set k=v ...``.

Reads the same YAML recipes as ``tpuseg`` through
``tpuseg.cli.main.load_config`` (which imports no JAX). Only ``eval`` is
ported; the other ``tpuseg`` subcommands follow the ROADMAP queue.
"""
from __future__ import annotations

import argparse
import sys

from tpuseg.cli.main import load_config


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tpuseg_torch")
    parser.add_argument("command", choices=["eval"])
    parser.add_argument("--config", default=None, help="YAML recipe")
    parser.add_argument("--set", dest="sets", action="append", default=[],
                        metavar="KEY=VALUE", help="dotted config override")
    parser.add_argument("--logdir", default="logs")
    parser.add_argument("--checkpoint", default=None,
                        help="reference-format torch state dict (.pth)")
    parser.add_argument("--eval-mode", default="val", choices=["val", "trn"])
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' raises when absent")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, args.sets)
    from tpuseg_torch.train.loop import evaluate_only

    evaluate_only(cfg, logdir=args.logdir, eval_mode=args.eval_mode,
                  checkpoint=args.checkpoint, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
