"""Device milliseconds an image in the bilinear resize kernels
(``ops/resize.py``'s ``F.interpolate``) in the traced eval steps."""


def read(trace):
    sec, n = trace.seconds(lambda name: "upsample_bilinear2d" in name)
    if not n or not trace.images:
        return None
    return 1e3 * sec / trace.images
