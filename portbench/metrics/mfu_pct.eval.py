"""The whole eval step's share of the card's bf16 peak: the reference's
FLOPs of the images the window completed over its seconds
(``costs.eval_flops_per_image``)."""
from portbench import costs


def read(trace):
    if not trace.window_images or not trace.flops_per_image:
        return None
    return 100.0 * trace.flops_per_image * trace.window_images / (
        trace.window_s * costs.BF16_FLOPS)
