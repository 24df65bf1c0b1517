"""pass.rt_reflections_ms: the `rt_reflections` pass's device ms a frame, from the event pair of
its `pass/rt_reflections` span (in the still cell, the last replayed frame of each
run_on_device call), total over the frames sampled since the window's
start."""

from harness import passes


def read(r):
    return passes.device_ms("rt_reflections")
