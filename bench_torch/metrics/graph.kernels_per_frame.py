"""graph.kernels_per_frame: the device's kernel records in the traced
window divided by its frames; a captured frame's replays count, unlike
the program's launch counters. In a traced run the harness adds its own:
the ray counter's four small kernels to each traversal call (three a
raster frame) and the finiteness check's few a unit, about 16 of the
frame's ~19,000 records."""


def read(r):
    if r.trace is None or not r.trace.kernels:
        return None
    return len(r.trace.kernels) / r.trace.frames
