"""pass.initial_ris_ms: the `initial_ris` pass's device ms a frame, from the event pair of
its `pass/initial_ris` span (in the still cell, the last replayed frame of each
run_on_device call), total over the frames sampled since the window's
start. A program without the span reads None."""

from harness import passes


def read(r):
    return passes.device_ms("initial_ris")
