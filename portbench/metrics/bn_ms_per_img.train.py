"""Device milliseconds an image in batch norm's kernels (statistics,
normalisation and their backward; ``models/layers.py``'s ``BatchNorm2d``)
in the traced train steps."""
import re

BN = re.compile(r"batch_norm|\bbn_(fw|bw)")


def read(trace):
    sec, n = trace.seconds(lambda name: BN.search(name) is not None)
    if not n or not trace.images:
        return None
    return 1e3 * sec / trace.images
