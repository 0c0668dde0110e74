"""``csrc/ocr_attention.cu``'s share of its roofline in the traced eval
steps: the least time its launches could take
(``costs.attention_launch_s`` at each eval scale's (B, N, d) queries over
the K class proxies) over their device time. One launch a scale a batch;
a count that is not a whole number of batches reads nothing."""
import math
import re

from portbench import costs

KERNEL = re.compile(r"\battention_(tc|f32)_kernel\b")


def read(trace):
    sec, n = trace.seconds(lambda name: KERNEL.search(name) is not None)
    m, t = trace.cell.config["model"], trace.cell.traffic
    scales = m["n_scales"]
    if not n or n % len(scales) or sec <= 0:
        return None
    h, w = t["hw"]
    bound = sum(costs.attention_launch_s(
        t["batch"], costs.quarter(math.floor(h * s))
        * costs.quarter(math.floor(w * s)), m["num_classes"],
        m["key_channels"]) for s in scales)
    return 100.0 * bound * (n // len(scales)) / sec
