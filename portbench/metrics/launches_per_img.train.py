"""Device kernels launched an image in the traced steps of a train window
(memory copies and sets left out): the host's dispatch of the
train step, autograd and the optimizer."""


def read(trace):
    if not trace.images:
        return None
    return trace.kernel_launches() / trace.images
