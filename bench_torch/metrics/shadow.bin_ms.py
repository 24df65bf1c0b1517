"""shadow.bin_ms: the device ms a frame of the shadow cascades' binning,
the program's `shadow/bin` spans (each cascade's vertex transform,
`tri_rows` and `bin_triangles`; four a frame), over the frames its
`pass/shadow` span sampled (in the still cell, the last replayed frame of
each run_on_device call). A program without the spans reads None."""

from harness import passes


def read(r):
    totals = passes.device_totals()
    frames = totals.get("pass/shadow", (0, 0.0))[0]
    spans, ms = totals.get("shadow/bin", (0, 0.0))
    return ms / frames if frames and spans else None
