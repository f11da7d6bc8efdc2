"""Share of the traced window (%) in which no device operation ran."""


def read(trace):
    if trace.window_s <= 0.0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
