"""``csrc/dilated_conv.cu``'s share of its roofline in the traced train
steps: the least time its launches could take over their device time.

The launches are the DeepLabV3+ ASPP's three dilated 3x3 convs, 4096 ->
256 at rates 12, 24 and 36 (output stride 8) over the (B, H / 8, W / 8)
map of the last trunk stage, one launch a rate a batch. A launch's least
time counts only the taps that land in the image, so that no
implementation, one that skips the padding or one that does not, can read
over 100 %: 2 B Cin Cout (3 h - 2 d)(3 w - 2 d) operations at rate d, and
the map x, the weights and the output once each. A count that is not a
whole number of batches reads nothing (so does a program without the
kernel)."""
import re

from portbench import costs

KERNEL = re.compile(r"\bdilated_conv")
RATES = (12, 24, 36)  # ASPP's rates (6, 12, 18), doubled at output stride 8
COUT = 256            # ASPP's reduction width in DeepLabV3+
STRIDE = 8            # the trunk's output stride


def launch_s(b: int, h: int, w: int, cin: int, cout: int, d: int) -> float:
    """One bf16 conv at rate d over the in-image taps."""
    flops = 2.0 * b * cin * cout * (3 * h - 2 * d) * (3 * w - 2 * d)
    nbytes = 2 * (b * h * w * cin + 9 * cin * cout + b * h * w * cout)
    return costs.bound_s(nbytes, flops)


def read(trace):
    sec, n = trace.seconds(lambda name: KERNEL.search(name) is not None)
    if not n or n % len(RATES) or sec <= 0:
        return None
    t, m = trace.cell.traffic, trace.cell.config["model"]
    h, w = (s // STRIDE for s in t["hw"])
    cin = m["channels"][-1][-1]
    bound = sum(launch_s(t["batch"], h, w, cin, COUT, d) for d in RATES)
    return 100.0 * bound * (n // len(RATES)) / sec
