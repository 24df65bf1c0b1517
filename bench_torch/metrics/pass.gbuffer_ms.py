"""pass.gbuffer_ms: the `gbuffer` pass's device ms a frame, from the event pair of
its `pass/gbuffer` span (in the still cell, the last replayed frame of each
run_on_device call), total over the frames sampled since the window's
start."""

from harness import passes


def read(r):
    return passes.device_ms("gbuffer")
