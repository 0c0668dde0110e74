"""Convert a tpuseg orbax snapshot to a reference-format .pth for
tpuseg_torch.

    python scripts/orbax_to_pth.py SNAPSHOT OUT.pth --arch ocrnet.HRNet_Mscale \
        [--num-classes 19]

Reads what tpuseg's ``--checkpoint`` and ``train.snapshot`` read: an orbax
checkpoint of ``{"params", "batch_stats"}`` (or of the params alone),
merged into a freshly built tpuseg model of ``--arch`` by tpuseg's own
``load_snapshot``, whose forgiving merge keeps the fresh value of every
key the snapshot lacks or holds at another shape (a snapshot of another
class count: the classifier heads) and logs each one. The merged weights
go through ``tpuseg_torch.convert.state_dict_from_flax`` into the port's
names, which tpuseg_torch's ``--checkpoint`` and ``train.snapshot`` load
as they are.

This script imports JAX, orbax and tpuseg, so it runs where tpuseg runs;
tpuseg_torch itself imports none of them.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def convert(snapshot: str, out: str, arch: str, num_classes: int = 19,
            log=print) -> dict:
    """Write ``snapshot``'s weights for ``arch`` to ``out`` as the port's
    state dict; returns the state dict."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from tpuseg.config import make_config
    from tpuseg.models import get_model
    from tpuseg.train.checkpoint import load_snapshot
    from tpuseg_torch.convert import state_dict_from_flax

    cfg = make_config({"model.arch": arch,
                       "dataset.num_classes": int(num_classes)})
    model = get_model(cfg)
    # parameter shapes do not depend on the input size (tpuseg's
    # evaluate_only initialises on the same 64x64 example)
    example = jnp.zeros((1, 64, 64, 3), jnp.dtype(cfg.model.compute_dtype))
    variables = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.PRNGKey(0), example)
    params, stats = load_snapshot(snapshot, variables["params"],
                                  variables.get("batch_stats", {}), log)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    state = state_dict_from_flax(to_np(params), to_np(stats), arch=arch)
    torch.save(state, out)
    return state


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="tpuseg orbax snapshot -> tpuseg_torch .pth")
    parser.add_argument("snapshot", help="orbax checkpoint directory")
    parser.add_argument("out", help="the .pth to write")
    parser.add_argument("--arch", required=True,
                        help="model.arch the weights belong to")
    parser.add_argument("--num-classes", type=int, default=19)
    args = parser.parse_args(argv)
    state = convert(args.snapshot, args.out, args.arch, args.num_classes)
    print(f"wrote {len(state)} tensors for {args.arch} to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
