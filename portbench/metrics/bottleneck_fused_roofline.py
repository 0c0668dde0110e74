"""``csrc/bottleneck_fused.cu``'s share of its roofline in the traced eval
steps: the least time its launches could take
(``costs.bottleneck_launch_s`` over stage 1's identity blocks, (B, H/4,
W/4, 4 M) at each eval scale) over their device time. One launch an
identity block a scale a batch; a count that is not a whole number of
batches reads nothing."""
import math
import re

from portbench import costs

KERNEL = re.compile(r"\bbottleneck_kernel\b")


def read(trace):
    sec, n = trace.seconds(lambda name: KERNEL.search(name) is not None)
    m, t = trace.cell.config["model"], trace.cell.traffic
    scales, spec = m["n_scales"], m["spec"]
    per_batch = (spec["stage1_blocks"] - 1) * len(scales)
    if not n or n % per_batch or sec <= 0:
        return None
    h, w = t["hw"]
    c1 = spec["stage1_channels"]
    bound = (spec["stage1_blocks"] - 1) * sum(costs.bottleneck_launch_s(
        t["batch"], costs.quarter(math.floor(h * s)),
        costs.quarter(math.floor(w * s)), 4 * c1, c1) for s in scales)
    return 100.0 * bound * (n // per_batch) / sec
