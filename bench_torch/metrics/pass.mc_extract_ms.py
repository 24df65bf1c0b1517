"""pass.mc_extract_ms: the isosurface's extraction pass's device ms a frame,
from the event pair of its `pass/mc_extract` span. The pass heads the
device loop's isolated prefix, which runs eagerly for each of a call's
frames before the captured body, so every frame is sampled; total over
the frames sampled since the window's start. A program without the span
reads None."""

from harness import passes


def read(r):
    return passes.device_ms("mc_extract")
