"""Share of the traced eval steps' wall time in which no operation ran on
the device."""


def read(trace):
    if trace.span_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.span_s)
