"""mc.hits_per_frame: the lanes a frame whose nearest hit is on the
isosurface, summed over every closest-hit query of the frame (the
g-buffer's primary rays and each bounce's), from the program's device
counter `mc/hits` (one call a query), its total over the frames that the
counter `mc/triangles` counts (one call a frame). A program without
either counter reads None."""

from harness.counters import counter


def read(r):
    hits, frames = counter("mc/hits"), counter("mc/triangles")
    return None if hits is None or frames is None else hits[1] / frames[0]
