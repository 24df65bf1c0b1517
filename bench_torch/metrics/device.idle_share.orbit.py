"""device.idle_share.orbit: in the host-loop (orbit) cells, the share (%)
of the untraced window's frame time in which the device ran nothing: one
minus the device's busy time a traced frame (the union of its kernels,
copies and sets) over the untraced window's time a frame. Tracing slows
the host's launches, so a traced orbit frame takes longer than an
untraced one and the traced window's own idle share would read the
tracer; the device's busy time a frame is what tracing leaves alone."""


def read(r):
    if r.trace is None or not (r.trace.kernels or r.trace.copies) or not r.window_frames:
        return None
    busy = r.trace.busy_s() / r.trace.frames
    return 100.0 * (1.0 - busy / (r.window_s / r.window_frames))
