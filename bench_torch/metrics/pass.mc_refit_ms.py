"""pass.mc_refit_ms: the isosurface tree's refit pass's device ms a frame,
from the event pair of its `pass/mc_refit` span (in the device loop's
isolated prefix, eager, every frame sampled), total over the frames
sampled since the window's start. A program without the span reads
None."""

from harness import passes


def read(r):
    return passes.device_ms("mc_refit")
