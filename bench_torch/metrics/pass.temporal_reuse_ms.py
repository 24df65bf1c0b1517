"""pass.temporal_reuse_ms: the `temporal_reuse` pass's device ms a frame, from the event pair of
its `pass/temporal_reuse` span (in the still cell, the last replayed frame of each
run_on_device call), total over the frames sampled since the window's
start. A program without the span reads None."""

from harness import passes


def read(r):
    return passes.device_ms("temporal_reuse")
