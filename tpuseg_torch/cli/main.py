"""CLI: ``python -m tpuseg_torch.cli train|eval|dump|summary|export|serve
--config <recipe> --set k=v ...``.

Reads the YAML recipes shipped in ``tpuseg_torch/cli/recipes/`` (copies of
``tpuseg``'s) with ``--set`` overrides, as ``tpuseg.cli.main.load_config``
does, and takes ``tpuseg``'s flags. Every command runs on the card unless
``--device`` names another device:

  python -m tpuseg_torch.cli eval    --config .../eval_cityscapes.yaml
  python -m tpuseg_torch.cli dump    --config .../dump_cityscapes.yaml
  python -m tpuseg_torch.cli dump    --config .../dump_folder.yaml \
      --eval-mode folder --set dataset.eval_folder=./imgs
  python -m tpuseg_torch.cli summary --config .../eval_cityscapes.yaml
  python -m tpuseg_torch.cli export  --config .../eval_cityscapes.yaml \
      --export-size 1024x2048 --export-out model.tpuseg_torch
  python -m tpuseg_torch.cli serve   --artifact model.tpuseg_torch

``--multi-host`` (``tpuseg``'s flag for ``jax.distributed``) joins the
process group of torchrun's environment first (``parallel.init_distributed``:
NCCL on CUDA, gloo with ``--device cpu``); ``train`` and ``eval`` then run
as data-parallel ranks, rank 0 the primary:

  python -m torch.distributed.run --nproc-per-node 8 -m tpuseg_torch.cli \
      train --multi-host --config .../train_cityscapes.yaml

With ``--set mesh.model_parallelism=N`` the ranks train as dp x sp: each
group of N consecutive ranks splits every image's rows into N bands
(``parallel/spatial.py``), padded where a map's rows do not split evenly.
Any crop trains whose deepest feature map at the lowest train scale has at
least N rows (``train.loop.check_spatial``): ``crop_h // 64 >= N`` on the
HRNet-OCR recipe, ``crop_h // 8 >= N`` on the DeepLab trunks at 1.0x.
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
    parser.add_argument("command",
                        choices=["train", "eval", "dump", "summary",
                                 "export", "serve"])
    parser.add_argument("--export-out", default="exported",
                        help="output dir for `export` (torch.export bundle)")
    parser.add_argument("--artifact", default=None,
                        help="exported bundle dir for `serve`")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--export-size", default=None,
                        help="HxW serving resolution for `export` "
                             "(default: dataset.crop_size)")
    parser.add_argument("--config", default=None, help="YAML recipe")
    parser.add_argument("--set", dest="sets", action="append", default=[],
                        metavar="KEY=VALUE", help="dotted config override")
    parser.add_argument("--logdir", default="logs")
    parser.add_argument("--checkpoint", default=None,
                        help="reference-format torch state dict (.pth): "
                             "the weights for eval/dump/summary/export, a "
                             "warm-start snapshot for train (maps to "
                             "train.snapshot)")
    parser.add_argument("--eval-mode", default="val",
                        choices=["val", "trn", "folder"])
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' raises when absent")
    parser.add_argument("--multi-host", action="store_true",
                        help="join torchrun's process group first (train "
                             "and eval run as data-parallel ranks)")
    args = parser.parse_args(argv)

    device, is_primary = args.device, True
    if args.multi_host:
        from tpuseg_torch.parallel import init_distributed, process_index

        device = str(init_distributed(args.device))
        is_primary = process_index() == 0

    cfg = load_config(args.config, args.sets)
    if args.command == "train":
        from tpuseg_torch.train.loop import Trainer

        if args.checkpoint:
            # warm start (reference --snapshot, train.py:343-376)
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, snapshot=args.checkpoint))
        Trainer(cfg, logdir=args.logdir, device=device,
                is_primary=is_primary).fit()
    elif args.command in ("eval", "dump"):
        from tpuseg_torch.train.loop import evaluate_only

        if args.command == "dump":
            cfg = cfg.replace(eval=dataclasses.replace(
                cfg.eval, dump_assets=True, dump_all_images=True))
        evaluate_only(cfg, logdir=args.logdir, eval_mode=args.eval_mode,
                      checkpoint=args.checkpoint, device=device,
                      is_primary=is_primary)
    elif args.command == "summary":
        # params + counted FLOPs, replaces the reference's thop --summary
        # (train.py:385-392)
        import torch

        from tpuseg_torch.train.loop import resolve_device
        from tpuseg_torch.utils.profiling import model_summary

        h, w = cfg.dataset.crop_size
        info = model_summary(_eval_model(cfg, args),
                             (1, int(h), int(w), 3),
                             getattr(torch, cfg.model.compute_dtype),
                             device=resolve_device(args.device))
        peak = info["peak_bytes"]
        print(f"params: {info['params'] / 1e6:.2f}M ({info['params']})  "
              f"fwd GFLOPs: {info['flops'] / 1e9:.1f}  peak device memory: "
              + (f"{peak / 2 ** 30:.2f}GiB" if peak is not None
                 else "not measured (no CUDA device)")
              + "  bytes accessed: not counted (no torch counterpart of "
                "XLA's cost model)", flush=True)
    elif args.command == "export":
        # the eval forward with the weights as constants, for serving
        from tpuseg_torch.serving import export_model
        from tpuseg_torch.train.loop import resolve_device

        if args.export_size:
            h, w = (int(s) for s in args.export_size.split("x"))
        else:
            h, w = cfg.dataset.crop_size
        entry = export_model(_eval_model(cfg, args), (h, w),
                             args.export_out,
                             input_dtype=cfg.model.compute_dtype,
                             device=resolve_device(args.device))
        print(f"exported {entry['bytes'] / 1e6:.1f}MB artifact for input "
              f"{entry['input']['shape']} {entry['input']['dtype']} on "
              f"{entry['device']} to {args.export_out}", flush=True)
    else:
        # HTTP inference over an exported bundle (tpuseg_torch/serving.py)
        from tpuseg_torch.serving import serve_http

        if not args.artifact:
            parser.error("serve requires --artifact <exported bundle dir>")
        serve_http(args.artifact, host=args.host, port=args.port)
    return 0


def _eval_model(cfg, args):
    """The eval model of ``cfg`` (seeded init, or ``--checkpoint``) on the
    CPU, in eval mode."""
    from tpuseg_torch.config import eval_model_config
    from tpuseg_torch.convert import load_reference_checkpoint
    from tpuseg_torch.models import get_model

    model = get_model(eval_model_config(cfg), seed=cfg.train.seed)
    if args.checkpoint:
        load_reference_checkpoint(model, args.checkpoint)
    return model.eval()


if __name__ == "__main__":
    sys.exit(main())
