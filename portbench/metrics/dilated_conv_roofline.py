"""``csrc/dilated_conv.cu``'s share of its roofline in the traced train
steps: the least time its launches could take over their device time.

The launches are the DeepLabV3+ ASPP's dilated 3x3 convs, one launch a
rate a batch. Their widths, rates and map come from the cell's frozen
reference, built on ``meta`` and run at the mix's batch and size: every
conv under its ``aspp`` module with dilation above 1 (the program sends
ASPP's alone to the kernel, none of the trunk's), with the (B, Cin, h, w)
map it reads. A launch's least time counts only the taps that land in the
image, so that no implementation, one that skips the padding or one that
does not, can read over 100 %: 2 B Cin Cout (3 h - 2 d)(3 w - 2 d)
operations at rate d, and the map x, the weights and the output once
each. A count that is not a whole number of batches reads nothing (so
does a program without the kernel, and a reference without an ASPP)."""
import re

import torch
import torch.nn as nn

from portbench import costs

KERNEL = re.compile(r"\bdilated_conv")


def launch_s(b: int, h: int, w: int, cin: int, cout: int, d: int) -> float:
    """One bf16 conv at rate d over the in-image taps."""
    flops = 2.0 * b * cin * cout * (3 * h - 2 * d) * (3 * w - 2 * d)
    nbytes = 2 * (b * h * w * cin + 9 * cin * cout + b * h * w * cout)
    return costs.bound_s(nbytes, flops)


def aspp_convs(cell) -> list:
    """``launch_s``'s (b, h, w, cin, cout, d) of each dilated conv under
    the reference's ``aspp``, in forward order; [] without one."""
    ref, m, t = cell.reference(), cell.config["model"], cell.traffic
    with torch.device("meta"):
        model = ref.build(m).eval()
    aspp = getattr(model, "aspp", None)
    if aspp is None:
        return []
    shapes = []

    def record(conv, args):
        b, cin, h, w = args[0].shape
        shapes.append((b, h, w, cin, conv.out_channels, conv.dilation[0]))

    for conv in aspp.modules():
        if isinstance(conv, nn.Conv2d) and conv.dilation[0] > 1:
            conv.register_forward_pre_hook(record)
    image = torch.zeros((t["batch"], *t["hw"], 3), dtype=torch.uint8,
                        device="meta")
    with torch.no_grad():
        ref.eval_logits(model, image, m)
    return shapes


def read(trace):
    sec, n = trace.seconds(lambda name: KERNEL.search(name) is not None)
    if not n or sec <= 0:
        return None
    convs = aspp_convs(trace.cell)
    if not convs or n % len(convs):
        return None
    bound = sum(launch_s(*c) for c in convs)
    return 100.0 * bound * (n // len(convs)) / sec
