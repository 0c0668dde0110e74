"""CLI: ``python -m tpuseg_torch.cli train|eval --config <recipe> --set
k=v ...``.

Reads the YAML recipes shipped in ``tpuseg_torch/cli/recipes/`` (copies of
``tpuseg``'s) with ``--set`` overrides, as ``tpuseg.cli.main.load_config``
does. ``train`` and ``eval`` are ported; ``tpuseg``'s other subcommands
follow the ROADMAP queue. Both run on the card unless ``--device`` names
another device.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import sys

import yaml

from tpuseg_torch.config import make_config


def _parse_value(v: str):
    # whole Python literal first so bracketed lists ("[64,64]") and
    # e-notation ("1e-3", a string to YAML 1.1) work
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        pass
    # then YAML scalar resolution — same rules as the recipe files, so
    # 'false' becomes False (a leaked 'false' STRING is truthy and would
    # silently invert every boolean override) and 'null'/'~' become None
    try:
        y = yaml.safe_load(v)
    except yaml.YAMLError:
        y = v
    if not isinstance(y, str):
        return y
    # the bare comma form ("64,64") mirrors the reference's flag syntax
    if "," in v:
        return tuple(_parse_value(x) for x in v.split(",") if x != "")
    return v


def load_config(config_path: str | None, sets: list[str]):
    overrides = {}
    if config_path:
        with open(config_path) as f:
            overrides.update(yaml.safe_load(f) or {})
    for item in sets:
        key, _, val = item.partition("=")
        overrides[key] = _parse_value(val)
    return make_config(overrides)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tpuseg_torch")
    parser.add_argument("command", choices=["train", "eval"])
    parser.add_argument("--config", default=None, help="YAML recipe")
    parser.add_argument("--set", dest="sets", action="append", default=[],
                        metavar="KEY=VALUE", help="dotted config override")
    parser.add_argument("--logdir", default="logs")
    parser.add_argument("--checkpoint", default=None,
                        help="reference-format torch state dict (.pth): "
                             "the weights for eval, a warm-start snapshot "
                             "for train (maps to train.snapshot)")
    parser.add_argument("--eval-mode", default="val", choices=["val", "trn"])
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' raises when absent")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, args.sets)
    if args.command == "train":
        from tpuseg_torch.train.loop import Trainer

        if args.checkpoint:
            # warm start (reference --snapshot, train.py:343-376)
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, snapshot=args.checkpoint))
        Trainer(cfg, logdir=args.logdir, device=args.device).fit()
    else:
        from tpuseg_torch.train.loop import evaluate_only

        evaluate_only(cfg, logdir=args.logdir, eval_mode=args.eval_mode,
                      checkpoint=args.checkpoint, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
