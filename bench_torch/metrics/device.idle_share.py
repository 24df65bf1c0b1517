"""device.idle_share: the share (%) of the traced window in which the
device ran no kernel, copy or set (one minus the union of their intervals
over the window's host time, which ends with a synchronize)."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0 or not (r.trace.kernels or r.trace.copies):
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
