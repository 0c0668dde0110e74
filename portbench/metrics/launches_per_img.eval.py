"""Device kernels launched an image in the traced steps of the eval window
(memory copies and sets left out): the host's dispatch of
``EvalRunner`` and the model."""


def read(trace):
    if not trace.images:
        return None
    return trace.kernel_launches() / trace.images
