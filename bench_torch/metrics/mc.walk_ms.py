"""mc.walk_ms: the device ms a frame of the isosurface tree's walks, the
program's `mc/walk` spans (one around each walk of the dynamic tree, in the
g-buffer pass and in the path tracer's closest-hit and any-hit queries),
over the frames its `pass/reference_pt` span sampled (in the still cell,
the last replayed frame of each run_on_device call). A program without
the spans reads None."""

from harness import passes


def read(r):
    totals = passes.device_totals()
    frames = totals.get("pass/reference_pt", (0, 0.0))[0]
    spans, ms = totals.get("mc/walk", (0, 0.0))
    return ms / frames if frames and spans else None
